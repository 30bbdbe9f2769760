"""Command-line entry points of the port (``python -m
dfu_multimodal_tpu_torch.cli.<name>``)."""
