"""Parallelism over ``torch.distributed`` ranks: meshes, voxel-sharded and
cohort fits, the tensor-parallel fit, multi-process wiring. The engine's
``fit_ensemble_batched``, ``fit_alternating_pn`` and ``fit_until`` take a
``mesh`` of this package and run on each rank's ``shard_batch``."""

from mri_super_resolution_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    Spec,
    make_mesh,
    data_sharding,
    case_data_sharding,
    replicated,
    shard_batch,
    pad_to_multiple,
)
from mri_super_resolution_tpu_torch.parallel.sharded_fit import (  # noqa: F401
    make_sharded_fit,
    make_cohort_fit,
    stack_params,
)
from mri_super_resolution_tpu_torch.parallel.tp_fit import (  # noqa: F401
    make_tp_fit,
    make_tp_mesh,
    siren_tp_specs,
)
from mri_super_resolution_tpu_torch.parallel.distributed import (  # noqa: F401
    global_mesh,
    host_local_slice,
    init_distributed,
    make_global_batch,
    restore_sharded,
    save_sharded,
)
