"""Data layer: .mat IO, CSV and DICOM writers, synthetic patients,
combination expansion."""

from mri_super_resolution_tpu_torch.data import synthetic  # noqa: F401
from mri_super_resolution_tpu_torch.data.combinations import (  # noqa: F401
    combination_mean,
    expand_combinations,
)
from mri_super_resolution_tpu_torch.data.io import (  # noqa: F401
    SSIM_HEADER,
    MetricsCSV,
    load_mat,
    save_dicom,
)
