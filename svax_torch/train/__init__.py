"""Train step and chunk runner."""
