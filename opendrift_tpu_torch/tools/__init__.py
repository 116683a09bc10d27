"""Command-line tools of the port (``python -m opendrift_tpu_torch.tools.<name>``)."""
