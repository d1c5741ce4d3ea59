"""Measurement scripts of the port, each run on the card as ``python -m cds_mvsnet_tpu_torch.tools.<name>``."""
