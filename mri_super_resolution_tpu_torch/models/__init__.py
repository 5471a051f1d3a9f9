"""INR models: SIREN and the PerturbNet coordinate offset."""

from mri_super_resolution_tpu_torch.models.perturbnet import (  # noqa: F401
    PerturbNet,
    perturbnet_apply,
)
from mri_super_resolution_tpu_torch.models.siren import SineLayer, Siren  # noqa: F401
