"""Checkpoints and the TensorBoard scalar writer of the MISR trainer, and
the analysis of experiment CSVs."""
