"""K2 — tagged ranks in sorted runs."""
