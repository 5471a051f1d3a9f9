"""Command-line entry points (``python -m mri_super_resolution_tpu_torch.cli.<tool>``)."""
