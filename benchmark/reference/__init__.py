"""The benchmark's plain reference: its own GP, rollout estimator, solves
and test functions in plain PyTorch and NumPy. It imports nothing of the
program under test and takes nothing the program made."""
