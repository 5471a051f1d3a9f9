"""INR models (SIREN and its ERD and toy variants, WIRE, the dense-grid
GridINR, the PerturbNet coordinate offset), the RAMS multi-image
super-resolution network and the PIA tissue autoencoder."""

from mri_super_resolution_tpu_torch.models.grid_inr import (  # noqa: F401
    GridINR,
    GridINR2D,
)
from mri_super_resolution_tpu_torch.models.perturbnet import (  # noqa: F401
    PerturbNet,
    perturbnet_apply,
)
from mri_super_resolution_tpu_torch.models.pia import PIA  # noqa: F401
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
    SirenToy,
)
from mri_super_resolution_tpu_torch.models.wire import (  # noqa: F401
    ComplexDense,
    ComplexGaborLayer,
    Wire,
    wire_apply,
)
