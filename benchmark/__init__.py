"""The benchmark of rollout_bo_tpu_torch on an NVIDIA H100: `run.py` runs
one cell of BENCHMARK.json for one seed and prints one JSON result line."""
