"""Configuration of the pipelines and of the RAMS network.

Counterpart of ``mri_super_resolution_tpu/config.py`` (``Master2DConfig``,
``SupperresDWIConfig``, ``PRESETS``, ``add_preset_arg``, ``INRERDConfig``,
``RAMSConfig``, ``TrainerConfig``), copied so the port imports nothing of
the JAX package. The config accepts ``inr_model="grid"`` and its
knobs; the port's pipeline runs ``"siren"`` and ``"wire"`` and raises
``NotImplementedError`` for ``"grid"``.
"""
from __future__ import annotations

import dataclasses
import sys


@dataclasses.dataclass
class Master2DConfig:
    """master.py flags (lines 25-41), defaults preserved."""

    out_folder: str = "experiments/"
    out_img_folder: str = "output_images/"
    total_steps: int = 3000
    seg: int = 150
    hidden_layers: int = 6
    hidden_features: int = 64
    roi_begin: int = 40
    roi_end: int = 100
    learning_rate: float = 3e-4
    scale: int = 3
    exp_name: str = "sr2"
    repeat_time: int = 1
    erd: int = 0  # 0=no ERD, 1=majority vote, 2=intensity-cognisant
    # True: every per-acquisition update is one K1 pass (sample-weighted) on
    # a CUDA device, its plain version on the CPU. False: eager autograd
    # (the CPU only; refused on the card)
    use_pallas: bool = True


@dataclasses.dataclass
class INRERDConfig:
    """INR_ERD.py hard-coded hyperparameters (lines 162-273)."""

    hidden_features: int = 128
    hidden_layers: int = 3
    pretrain_lr: float = 3e-4
    loss_threshold: float = 2e-5
    perturb_lr: float = 3e-4
    net_lr: float = 1e-7
    perturb_eps: float = 1.0 / 128.0
    soft_erd_mul: float = 1000.0
    soft_erd_slope: float = 20.0
    seeds: int = 10


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
    # True: the INR steps, PN steps and inference run the kernels (SIREN
    # K1/K2/K3, WIRE K4/K5 on a CUDA device; their plain versions on the CPU).
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


@dataclasses.dataclass
class RAMSConfig:
    """RAMS network hyperparameters (multi-image-super-resolution/
    master.py:20-27 and utils/network.py:91-155)."""

    scale: int = 3
    filters: int = 32
    kernel_size: int = 3
    channels: int = 9  # T temporal acquisitions
    r: int = 8  # attention compression
    N: int = 12  # number of RFABs
    mean: float = 7433.6436  # PROBA-V normalisation (network.py:18-19)
    std: float = 2353.0723
    # activation type; parameters, the attention gates and the output sum
    # stay float32
    compute_dtype: str = "bfloat16"
    # True: the 3x3x3 convs with channel counts divisible by 8 run K6
    # (conv3d_rfab) on a CUDA device, its plain version on the CPU
    conv_kernel: bool = False
    # (B, H, W, T, C) activations; the committed checkpoint and K6 use it
    layout: str = "nhwtc"

    def __post_init__(self):
        if self.layout == "nthwc":
            raise NotImplementedError(
                "layout='nthwc' is not ported to PyTorch yet (ROADMAP Queue 1, item 17); "
                "the port runs layout='nhwtc'")
        if self.layout != "nhwtc":
            raise ValueError(f"unknown layout {self.layout!r}")


@dataclasses.dataclass
class TrainerConfig:
    """MISR Trainer knobs (utils/training.py:108-120), the JAX package's
    fields and defaults."""

    batch_size: int = 32
    buffer_size: int = 512
    epochs: int = 100
    evaluate_every: int = 100
    val_steps: int = 100
    hr_size: int = 96
    learning_rate: float = 1e-4
    # "constant" (the reference recipe) or "cosine": learning_rate decays to
    # 0 over decay_steps applied updates (optax cosine_decay_schedule, alpha 0)
    lr_schedule: str = "constant"
    decay_steps: int = 0
    # exponential moving average of the weights (0 = off, the reference
    # behaviour). When > 0 the trainer keeps ema = d ema + (1 - d) params
    # after every step; validation, best-checkpoint gating and serving
    # (utils/checkpoint.unwrap_trainer_params) use the averaged weights
    ema_decay: float = 0.0
    # gradient accumulation: an optimizer step sees batch_size * grad_accum
    # samples; weighted-sum accumulation makes k micro-batches one big-batch
    # step (ragged tails included)
    grad_accum: int = 1
    checkpoint_dir: str = "ckpt"
    log_dir: str = "logs"
    max_to_keep: int = 3
    save_best_only: bool = True
    data_aug: bool = False
    tensorboard: bool = False  # also emit tfevents (training.py:128-129)


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
