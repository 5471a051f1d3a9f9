"""Checkpoints and the TensorBoard scalar writer of the MISR trainer."""
