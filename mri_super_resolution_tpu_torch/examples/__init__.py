"""Runnable examples on the port, one for each of the JAX package's
``examples/``: the kiwi and water phantom checks (``phantom_sanity``), the
3-D super-resolution walkthrough (``sr3d_demo``) and WIRE against SIREN on
one slice (``wire_vs_siren``). Run each with ``python -m
mri_super_resolution_tpu_torch.examples.<name>``."""
