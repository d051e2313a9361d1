"""Command-line tools of the port: python -m sparf_tpu_torch.scripts.<name>."""
