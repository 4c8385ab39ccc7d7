"""Command-line experiments of the port (``python -m diffdrr_tpu_torch.experiments.<name>``)."""
