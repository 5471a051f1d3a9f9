"""End-to-end pipelines: the 3-D volume INR pipeline (SIREN, WIRE and the
dense grid), the hybrid multi-TE tissue fit and PIA training, the 2-D INR
pipelines, and MISR inference with RAMS."""
