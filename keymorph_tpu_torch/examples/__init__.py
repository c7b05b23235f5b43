"""Runnable examples of the port (``python -m keymorph_tpu_torch.examples.<name>``)."""
