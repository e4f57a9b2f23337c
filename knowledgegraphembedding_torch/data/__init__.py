"""Dataset IO, synthetic generators, filter sets and the dataset registry."""
