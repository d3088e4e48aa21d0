"""Named constants (reference: constants.jl:1-13; copy of rollout_bo_tpu's).

The reference uses these as dispatch sentinels; here they are kept for API
parity: the fantasy-surrogate evaluation index convention and the
surrogate's default capacity.
"""

# Name of the random-search decision rule (reference constants.jl:1; the
# multistart solver short-circuits on it, rbf_optim.jl:76-79).
RANDOM_ACQUISITION = "Random"

# Fantasy-index sentinel selecting the *base* (ground-truth-conditioned)
# posterior slice instead of a fantasy step (reference constants.jl:7;
# used by radial_basis_surrogates.jl:482-585). In this package the same
# convention applies to `models.fantasy.view(fs, fantasy_index=-1)`.
GROUND_TRUTH_OBSERVATIONS = -1

# Default preallocated observation capacity (reference constants.jl:13).
DEFAULT_CAPACITY = 100
