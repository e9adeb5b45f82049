"""Batched small-d linear algebra and the hand-written CUDA kernels.

Kernel sources live in ``csrc/`` and are built at first use by
``_build.py``; nothing is compiled or loaded at import time.
"""
