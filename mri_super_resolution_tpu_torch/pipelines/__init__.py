"""End-to-end pipelines: the 3-D volume INR pipeline (SIREN, WIRE and the
dense grid), the hybrid multi-TE tissue fit and PIA training, the 2-D INR
pipelines (the directional ensemble, the soft-ERD fit and its half-res
quality protocol), the ERD-only statistics, MISR inference with RAMS,
and the cohort runner."""
