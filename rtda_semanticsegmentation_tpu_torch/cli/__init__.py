"""Command-line entry points of the port (``python -m
rtda_semanticsegmentation_tpu_torch.cli.predict``)."""
