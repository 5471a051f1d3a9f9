"""End-to-end pipelines: the 3-D volume INR pipeline (SIREN and WIRE) and
MISR inference with RAMS."""
