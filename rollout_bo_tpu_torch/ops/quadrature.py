"""Gauss-Hermite quadrature helpers for the deterministic (SAA) rollout.

Copy of `rollout_bo_tpu/ops/quadrature.py` (numpy only). reference:
FastGaussQuadrature.gausshermite usage + tensor-product index sets
(`utils.jl:217-221`, `rollout.jl:409-467`).
"""

from __future__ import annotations

import itertools

import numpy as np

__all__ = ["gauss_hermite", "tensor_product_indices"]


def gauss_hermite(num_nodes: int):
    """Physicists' Gauss-Hermite nodes/weights (weight e^{-x^2}), numpy."""
    return np.polynomial.hermite.hermgauss(num_nodes)


def tensor_product_indices(num_nodes: int, depth: int) -> np.ndarray:
    """All index tuples in {0..num_nodes-1}^depth, shape (num_nodes^depth, depth).

    reference: generate_indices (utils.jl:217-221; 1-based there). The
    iteration order matches Julia's `Iterators.product` (first axis fastest).
    """
    grids = np.meshgrid(*[np.arange(num_nodes)] * depth, indexing="ij")
    return np.stack([g.reshape(-1, order="F") for g in grids], axis=1)
