"""K1 — bitonic tile sort."""
