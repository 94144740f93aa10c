"""Measurement tools of the port, run as ``python -m
gpusimilarity_tpu_torch.tools.<name>``."""
