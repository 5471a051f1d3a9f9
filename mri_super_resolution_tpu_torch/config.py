"""Configuration of the 3-D volume pipeline.

Counterpart of ``mri_super_resolution_tpu/config.py`` (``SupperresDWIConfig``,
``PRESETS``, ``add_preset_arg``), copied so the port imports nothing of the
JAX package. The config accepts ``inr_model="grid"``/``"wire"`` and their
knobs; the port's pipeline runs only ``"siren"`` so far and raises
``NotImplementedError`` for the others.
"""
from __future__ import annotations

import dataclasses
import sys


@dataclasses.dataclass
class SupperresDWIConfig:
    """superresDWI.py hard-coded hyperparameters (lines 84-118)."""

    number_of_epochs: int = 2500
    perturbation_epochs: int = 10
    hidden_dim: int = 512
    num_layers: int = 3
    pn_dim: int = 128
    roi_start: int = 40
    roi_end: int = 90
    mapping_size: int = 128
    ff_scale: float = 0.5
    inr_lr: float = 1e-4
    pn_lr: float = 1e-6
    pn_eps: float = 1.0 / 128.0
    te_index: int = 1  # TE=70ms column used for rescaling outputs
    # True: the INR steps, PN steps and inference run the SIREN kernels
    # (K1/K2/K3 on a CUDA device; their plain versions on the CPU).
    # False: eager PyTorch autograd over torch.matmul.
    use_pallas: bool = True
    # >0 switches the INR optimizer to Adam with moment restarts every N steps
    inr_restart_every: int = 0
    inr_model: str = "siren"
    wire_hidden: int = 256
    wire_layers: int = 2
    wire_lr: float = 1e-3
    wire_omega: float = 10.0
    wire_sigma: float = 10.0
    wire_trainable: bool = False
    grid_levels: int = 4
    grid_base_resolution: int = 6
    grid_features: int = 4
    grid_hidden: int = 64
    grid_lr: float = 5e-3
    grid_z_divisor: int = 1


# "reference": exact reference behavior (FF-SIREN, flat Adam, 2500 epochs).
# "quality" / "fast": the grid INR arms (not ported yet: the pipeline raises).
# Keys are CLI flag dests; explicit flags always beat the preset.
PRESETS: dict[str, dict] = {
    "reference": {},
    "quality": {
        "inr_model": "grid",
        "grid_z_divisor": 1,
        "grid_lr": 5e-3,
        "inr_restart_every": 250,
    },
    "fast": {
        "inr_model": "grid",
        "grid_z_divisor": 1,
        "grid_lr": 5e-3,
        "inr_restart_every": 250,
        "epochs": 600,
        "pn_epochs": 0,
    },
}


def add_preset_arg(parser, argv=None) -> None:
    """Add --preset and re-seed the parser's defaults from the chosen preset
    (pre-parses just --preset; explicit flags still override)."""
    parser.add_argument(
        "--preset", choices=sorted(PRESETS), default="reference",
        help="config preset: 'reference' = exact reference behavior; "
        "'quality'/'fast' = grid INR arms (not ported yet)",
    )
    args = sys.argv[1:] if argv is None else list(argv)
    pre, _ = parser.parse_known_args(
        [a for a in args if a not in ("--help", "-h")]
    )
    known = {a.dest for a in parser._actions}
    preset = PRESETS[pre.preset]
    applied = {k: v for k, v in preset.items() if k in known}
    dropped = sorted(set(preset) - set(applied))
    if dropped:
        print(
            f"--preset {pre.preset}: applied {sorted(applied) or 'nothing'}; "
            f"this CLI has no {dropped} flags, those keys are IGNORED",
            file=sys.stderr,
        )
    parser.set_defaults(**applied)
