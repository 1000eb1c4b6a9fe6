"""Training-side utilities of the port: so far the checkpoint I/O the
broker saves and restores through (``repro_torch.train.checkpoint``)."""
