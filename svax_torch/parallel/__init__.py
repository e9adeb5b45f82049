"""Data and component parallelism on ``torch.distributed`` (``svax/parallel``)."""
