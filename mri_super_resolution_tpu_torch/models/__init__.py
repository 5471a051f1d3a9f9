"""INR models (SIREN, WIRE, the PerturbNet coordinate offset) and the RAMS
multi-image super-resolution network."""

from mri_super_resolution_tpu_torch.models.perturbnet import (  # noqa: F401
    PerturbNet,
    perturbnet_apply,
)
from mri_super_resolution_tpu_torch.models.rams import (  # noqa: F401
    RAMS,
    RFAB,
    RTAB,
    WNConv,
    fold_weight_norm,
)
from mri_super_resolution_tpu_torch.models.siren import (  # noqa: F401
    PerturbHead,
    SineLayer,
    Siren,
    SirenERD,
)
from mri_super_resolution_tpu_torch.models.wire import (  # noqa: F401
    ComplexDense,
    ComplexGaborLayer,
    Wire,
    wire_apply,
)
