"""End-to-end pipelines (the 3-D volume SIREN pipeline so far)."""
