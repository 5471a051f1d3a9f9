"""INR models: SIREN, WIRE and the PerturbNet coordinate offset."""

from mri_super_resolution_tpu_torch.models.perturbnet import (  # noqa: F401
    PerturbNet,
    perturbnet_apply,
)
from mri_super_resolution_tpu_torch.models.siren import SineLayer, Siren  # noqa: F401
from mri_super_resolution_tpu_torch.models.wire import (  # noqa: F401
    ComplexDense,
    ComplexGaborLayer,
    Wire,
    wire_apply,
)
