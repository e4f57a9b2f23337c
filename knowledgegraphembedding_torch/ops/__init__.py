"""Hand-written kernels and their wrappers."""
