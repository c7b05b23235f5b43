"""Command-line entry points of the port: ``python -m
keymorph_tpu_torch.cli.register`` and the evaluation harnesses it drives."""
