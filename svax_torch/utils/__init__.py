"""State-tree helpers and numerical guards (``svax/utils``, the guards subset)."""
