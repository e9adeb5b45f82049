"""Encoder/decoder MLPs."""
