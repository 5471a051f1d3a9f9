"""Hand-written kernels (csrc/) and their wrappers."""
