"""The lane kernel's work, frozen: a copy of the program's
`ops/newton_lanes.py::lane_solve_work` as it stood when the benchmark was
defined, so that a change to the program cannot move its roofline.

`solve_work(n, cap, d, S, iters_per_start, itemsize)` gives the
(floating-point operations, bytes) of one solve: one launch over len(n)
lanes with active counts n, S starts each running `iters_per_start`
iterations (a fixed figure of the cell, measured once from the kernel's
own count of the iterations its starts ran). Operations are the fewest the
function needs, whoever computes it (a multiply-add is two), per (lane,
start, iteration): the 18 backtracking values, the three passes over the
data, the rule and its partials, the Hessian's data terms, one d x d
Cholesky solve and the direction's norms; then one value per (lane,
start). itemsize 4 counts the float32 (W = K^{-1}) form, 8 the float64
(Li) form. Bytes count each input once and each output once.
"""

from __future__ import annotations

CANDIDATES = 18


def solve_work(n, cap: int, d: int, S: int, iters_per_start: float, itemsize: int):
    li = itemsize == 8
    profile, profile_terms, rule, partials = 12, 25, 30, 60
    sym = d * (d + 1) // 2
    flops = 0.0
    for ni in (int(v) for v in n):
        tri = ni * (ni + 1)
        if li:
            value = ni * (3 * d + profile) + tri + 4 * ni + rule
            passes = (ni * (3 * d + profile_terms + 4 + d) + 2 * tri + 4 * ni
                      + 4 * ni * d + d)
            hessian = tri * d + ni * (d + 4) + 4 * ni * sym + 8 * sym + 6 * d
        else:
            value = ni * (3 * d + profile) + 2 * ni * ni + 4 * ni + rule
            passes = (ni * (3 * d + profile_terms + 4 + d) + 2 * ni * ni + 4 * ni
                      + 4 * ni * d + d)
            hessian = 2 * ni * ni * d + ni * (3 * d + 6) + 2 * ni * sym + 8 * sym + 6 * d
        chol = d ** 3 / 3.0 + 2 * d * d + 4 * d
        direction = 2 * d * d + 20 * d
        iteration = (CANDIDATES * (value + 3 * d) + passes + rule + partials
                     + hessian + chol + direction)
        flops += S * iters_per_start * iteration + S * value
    lanes = len(n)
    matrix = cap * (cap + 1) // 2 if li else cap * cap
    read = (lanes * (cap * d + matrix + cap + 2) + 2 * d + S * d + 2) * itemsize + 8 * lanes
    written = lanes * (d + 1) * itemsize
    return float(flops), int(read + written)
