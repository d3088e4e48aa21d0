"""The notebook-analog examples, ported from the JAX package's `examples/`.

One module per script, with the same names, flags and printed lines, plus
`--device` (default `cuda`: the run raises without a card; `cpu` runs the
plain PyTorch route). Each module's `main(argv=None)` prints what the JAX
script prints and returns those numbers as a dict. Run one with

    python -m rollout_bo_tpu_torch.examples.<name> [flags]

- `derivs_ei`: the EI derivative chain against centered finite
  differences (fails above 1e-5);
- `fantasy_conditioning`: rank-1 fantasy conditioning against a full
  refactorization, and the reset;
- `laplace_approximation`: 100 x 100 fantasy-conditioning episodes;
- `overview`: posterior / EI over a grid and a myopic BO run;
- `explanatory`: the 1-D rollout sweep, adjoint gradient against FD;
- `rollout_bo`: rollout gradients, the explicit adjoint, the outer SGA and
  a non-myopic against a myopic BO run.
"""
