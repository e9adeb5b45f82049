"""Probabilistic graphical model layer (GMM prior, CVI updates)."""
