"""Datasets (numpy only)."""
