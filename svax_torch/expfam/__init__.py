"""Exponential-family cores (Dirichlet, NIW)."""
