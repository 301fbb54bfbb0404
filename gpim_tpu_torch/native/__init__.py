"""Host-side helpers of the Bayesian-optimisation loop (numpy)."""
