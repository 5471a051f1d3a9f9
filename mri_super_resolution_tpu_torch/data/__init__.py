"""Data layer: .mat IO, CSV and DICOM writers, synthetic patients,
combination expansion, the case registry."""

from mri_super_resolution_tpu_torch.data import synthetic  # noqa: F401
from mri_super_resolution_tpu_torch.data.cases import (  # noqa: F401
    CASE_TABLE,
    Case,
    available_patients,
    default_data_dir,
    load_cases,
)
from mri_super_resolution_tpu_torch.data.combinations import (  # noqa: F401
    combination_mean,
    expand_combinations,
)
from mri_super_resolution_tpu_torch.data.datasets import (  # noqa: F401
    ImageFittingSet,
    flatten_weights,
)
from mri_super_resolution_tpu_torch.data.io import (  # noqa: F401
    CNR_SNR_HEADER,
    CONTRAST_HEADER,
    SSIM_HEADER,
    MetricsCSV,
    load_mat,
    save_dicom,
    save_mat,
)
