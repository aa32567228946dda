"""Training configuration (port of ``nerf_for_angiography_tpu/training/
config.py``): every field and default of ``TrainConfig``,
``REFERENCE_STRICT_OVERRIDES``, and ``parse_train_args``, the train CLI's
flags with the reference's names and defaults (run_nerf_acc.py:25-47) plus
``--device``.

Every configuration the JAX package takes, the port takes too.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses

import torch

from ..data.datasets import sdf_datagen_config
from ..models import CPPNConfig


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # reference CLI flags (run_nerf_acc.py:40-47)
    limited_size: float = 180.0
    number_angles: float = 4.0
    center_point: tuple[float, float] = (90.0, 0.0)
    binary: bool = False
    sampling_strategy: str = "frangi"  # frangi | segmentation | random
    data_name: str = "ct"
    num_layers: int = 4
    num_hidden_units: int = 128

    # schedule (run_nerf_acc.py:129-167)
    n_iters: int = 500_000
    early_stop_iters: int = 50_000
    display_every: int = 500
    save_every_factor: int = 100  # save_every = display_every * 100
    depth_samples_per_ray: int = 300
    coarse_lr: float = 1e-4
    decay_rate: float = 0.1
    decay_steps: int = 500 * 1000  # lr_decay(500) * 1000
    sample_size: int = 75  # rays per dim per iter -> batch = sample_size^2
    sample_mode: str = "pixel"  # 'pixel' | 'image'

    # scene bounds (run_nerf_acc.py:66,131-134,196)
    outside: float = 100.0

    # nerfacc-equivalent marching params (run_nerf_acc.py:68-70); alpha_thre
    # doubles as the occupancy-grid occ_thre (run_nerf_acc.py:285)
    early_stop_eps: float = 1e-2
    alpha_thre: float = 1e-4
    vessel_alpha_thre: float = 5e-2
    # apply alpha_thre as a hard per-sample mask in the training loss
    train_alpha_prune: bool = False
    grid_resolution: int = 128
    grid_update_every: int = 16
    grid_ema_decay: float = 0.95
    # jitter the grid-update evaluation points uniformly inside each cell
    grid_jitter: bool = False
    # 1 = dense grid update; N > 1 = rotating 1/N x-slab after a 256-step
    # full-update warmup
    grid_update_slabs: int = 4
    # 0 = always-dense lattice; k > 0 switches to a compacted march once the
    # grid has pruned (choose_compact_mode); compact_engage_max > k lets it
    # engage early with an interim k up to that value
    compact_samples: int = 96
    compact_engage_max: int = 192
    # space-carving grid initialization (ops/occupancy.py::carve_feasible)
    carve_init: bool = True
    carve_thresh: float = 0.995
    # probe the occupancy grid every n-th sample during marching
    occ_stride: int = 2
    # compacted-march strategy ('window' | 'hybrid' | 'lattice') and its
    # tuning; the loop sizes hybrid_w_cap / hybrid_w_lo / hybrid_k_lo and k
    # from the chooser's probe (training/pressure.py)
    march_mode: str = "window"
    hybrid_w_cap: int = 0
    hybrid_split: float = 0.75
    hybrid_w_lo: int = 0
    hybrid_bucket_k: bool = True
    hybrid_k_lo: int = 0
    compact_k_margin: float = 1.15
    # first-k-active implementation: the JAX package's 'xla' (compare and
    # count) and 'pallas' (its TPU kernel) compute the same function; in the
    # port both mean the CUDA kernel on the card (its plain version on the
    # CPU)
    march_fka: str = "xla"
    compact_check_every: int = 100
    # write grid VTKs at display cadence (checkpoints/logging slice)
    grid_export: bool = True

    # positional encoding / BARF (run_nerf_acc.py:160-167)
    pos_enc: str = "none"
    pos_enc_basis: int = 5
    fourier_sigma: float = 5.0
    barf_start: int = 8000
    barf_stop: int = 250_000
    # view-direction branch (classic path): 0 disables
    num_input_channels_views: int = 0
    pos_enc_basis_views: int = 4

    # per-view pose refinement
    pose_refine: bool = False
    pose_lr: float = 1e-2
    pose_weight_decay: float = 1e-3
    pose_start: int = 0

    # weighted ray sampler: 'overdraw' = inverse-CDF overdraw + dedupe;
    # 'gumbel' = exact successive-draw semantics (nerf_helpers.py:139)
    sampling_impl: str = "overdraw"

    # parallelism (no reference counterpart)
    data_axis: str = "data"

    # compute dtype of the plain MLP path ('xla' backend); the fused kernels
    # always compute in bf16 with f32 accumulation
    compute_dtype: str = "bfloat16"
    # MLP backend: 'pallas' = the fused kernels (raises if the model is not
    # eligible), 'auto' = the fused kernels when eligible, 'xla' = the plain
    # module forward. The names are the JAX package's.
    mlp_backend: str = "auto"
    # feature-major kernel input (a TPU layout variant)
    feature_major_mlp: bool = False
    # whole-train-step fused kernel (slice 3 of the port)
    fused_train_step: str = "off"

    seed: int = 0

    def __post_init__(self):
        if self.march_fka not in ("xla", "pallas"):
            raise ValueError(f"march_fka must be 'xla' or 'pallas', got {self.march_fka!r}")

    @property
    def img_sample_size(self) -> int:
        return self.sample_size**2

    @property
    def save_every(self) -> int:
        """coarsemodel.npz cadence (and the CLI's checkpoint_every)."""
        return self.display_every * self.save_every_factor

    def model_config(self) -> CPPNConfig:
        """The reference's model params dict (run_nerf_acc.py:168-183)."""
        return CPPNConfig(
            num_early_layers=self.num_layers,
            num_late_layers=0,
            num_filters=self.num_hidden_units,
            num_input_channels=3,
            num_output_channels=2 if self.num_input_channels_views > 0 else 1,
            num_input_channels_views=self.num_input_channels_views,
            use_bias=True,
            pos_enc=self.pos_enc,
            pos_enc_basis=self.pos_enc_basis,
            pos_enc_basis_views=self.pos_enc_basis_views,
            act_func="relu",
            fourier_sigma=self.fourier_sigma,
            num_img=1,
            dtype=torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32,
            input_scale=1.0 / self.outside,
        )


# the reference-parity protocol knobs the production defaults flip on; one
# dict restores the strict behavior
REFERENCE_STRICT_OVERRIDES = dict(
    carve_init=False,
    compact_engage_max=0,
    hybrid_split=0.0,
    hybrid_bucket_k=False,
)


def lca_protocol(**kw) -> tuple[TrainConfig, float]:
    """The JAX LCA anchor's protocol (benchmarks/LCA.md: cli/train.py
    --data_name LCA --display_every 1000 --compact_engage_max 192): its
    TrainConfig with ``kw`` on top, and the ``src_pt_z`` that train() takes
    for the rays of ``sdf_datagen_config()`` (the source at focal_length +
    src_z_offset, z = 4000)."""
    base = dict(compact_engage_max=192, display_every=1000, data_name="LCA")
    return TrainConfig(**{**base, **kw}), float(sdf_datagen_config().src_pt[2])


def train_arg_parser() -> argparse.ArgumentParser:
    """The train CLI's flags: the JAX package's (its run_nerf_acc.py:25-47
    surface and the protocol knobs) and ``--device``."""
    p = argparse.ArgumentParser()
    p.add_argument("--limited_size", help="Angle range to sample the projections in")
    p.add_argument("--number_angles", help="Number of projections to sample per axis")
    p.add_argument("--center_point", help="Center point for the angle sampling")
    p.add_argument("--binary", help="Whether images are binary or not")
    p.add_argument(
        "--sampling_strategy",
        help="What sampling strategy to use, options: frangi, segmentation or random",
    )
    p.add_argument("--data_name", help="Either CT data or LCA data")
    p.add_argument("--num_layers", help="Number of layers for MLP")
    p.add_argument("--num_hidden_units", help="Number of hidden units for MLP")
    p.add_argument("--data_dir", default="data", help="dataset root directory")
    p.add_argument("--n_iters", default=None, help="override max iterations")
    p.add_argument("--grid_resolution", default=None, help="occupancy grid resolution")
    p.add_argument("--depth_samples", default=None, help="samples per ray")
    p.add_argument("--display_every", default=None, help="eval cadence")
    p.add_argument("--pose_refine", action="store_true",
                   help="learn a per-view camera translation jointly with the field")
    p.add_argument("--pose_lr", default=None, help="pose-shift Adam lr")
    p.add_argument("--march_mode", default=None, choices=["window", "hybrid", "lattice"],
                   help="compacted-march strategy")
    p.add_argument("--mlp_backend", default=None, choices=["auto", "xla", "pallas"],
                   help="density-MLP backend: auto/pallas = the fused kernels, xla = the "
                        "plain module forward (the JAX package's names)")
    p.add_argument("--feature_major_mlp", default=None, action="store_true",
                   help="feed the fused MLP feature-major (3, P) positions")
    p.add_argument("--fused_train_step", default=None, choices=["auto", "on", "off"],
                   help="the whole-train-step kernel (MLP forward + composite + loss "
                        "gradient + MLP backward in one call)")
    p.add_argument("--sampling_impl", default=None, choices=["overdraw", "gumbel"],
                   help="weighted ray sampler (overdraw = table sampler; gumbel = exact "
                        "successive-draw semantics)")
    p.add_argument("--carve_init", default=None, choices=["True", "False"],
                   help="space-carving occupancy-grid init from unattenuated training rays. "
                        "Default True (production protocol)")
    p.add_argument("--compact_engage_max", default=None,
                   help="interim compaction ladder cap (0 = wait for compact_samples fit). "
                        "Default 192 (production protocol)")
    p.add_argument("--hybrid_split", default=None,
                   help="two-bucket hybrid march: fraction of the batch marched at the "
                        "smaller window (0 = off). Default 0.75")
    p.add_argument("--hybrid_bucket_k", default=None, choices=["True", "False"],
                   help="per-bucket compaction width for the two-bucket march. Default True")
    p.add_argument("--reference-strict", action="store_true", dest="reference_strict",
                   help="restore the reference-parity training protocol: no carve init, no "
                        "interim compaction engagement, single-bucket march "
                        "(run_nerf_acc.py:196-198 semantics). Explicit per-knob flags still "
                        "override on top")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    return p


def config_from_args(a: argparse.Namespace) -> tuple[TrainConfig, str]:
    """(TrainConfig, data_dir) from parsed train CLI flags, as the JAX
    package's parse_train_args builds them."""
    kw = {}
    if a.limited_size is not None:
        kw["limited_size"] = float(a.limited_size)
    if a.number_angles is not None:
        kw["number_angles"] = float(a.number_angles)
    if a.center_point is not None:
        kw["center_point"] = tuple(ast.literal_eval(a.center_point))
    if a.binary is not None:
        kw["binary"] = a.binary == "True"
    if a.sampling_strategy is not None:
        kw["sampling_strategy"] = a.sampling_strategy
    if a.data_name:
        kw["data_name"] = a.data_name
    if a.num_layers:
        kw["num_layers"] = int(a.num_layers)
    if a.num_hidden_units:
        kw["num_hidden_units"] = int(a.num_hidden_units)
    if a.n_iters:
        kw["n_iters"] = int(a.n_iters)
    if a.grid_resolution:
        kw["grid_resolution"] = int(a.grid_resolution)
    if a.depth_samples:
        kw["depth_samples_per_ray"] = int(a.depth_samples)
    if a.display_every:
        kw["display_every"] = int(a.display_every)
    if a.pose_refine:
        kw["pose_refine"] = True
    if a.pose_lr:
        kw["pose_lr"] = float(a.pose_lr)
    if a.march_mode:
        kw["march_mode"] = a.march_mode
    if a.mlp_backend:
        kw["mlp_backend"] = a.mlp_backend
    if a.feature_major_mlp:
        kw["feature_major_mlp"] = True
    if a.fused_train_step:
        kw["fused_train_step"] = a.fused_train_step
    if a.sampling_impl:
        kw["sampling_impl"] = a.sampling_impl
    if a.reference_strict:
        kw.update(REFERENCE_STRICT_OVERRIDES)
    if a.carve_init is not None:
        kw["carve_init"] = a.carve_init == "True"
    if a.compact_engage_max is not None:
        kw["compact_engage_max"] = int(a.compact_engage_max)
    if a.hybrid_split is not None:
        kw["hybrid_split"] = float(a.hybrid_split)
    if a.hybrid_bucket_k is not None:
        kw["hybrid_bucket_k"] = a.hybrid_bucket_k == "True"
    return TrainConfig(**kw), a.data_dir


def parse_train_args(argv=None) -> tuple[TrainConfig, str]:
    """The train CLI's flags -> (TrainConfig, data_dir), as the JAX
    package's parse_train_args; ``--device`` is read by the CLI
    (``train_arg_parser``)."""
    return config_from_args(train_arg_parser().parse_args(argv))


def categories_for(cfg: TrainConfig) -> list[str]:
    """Experiment categorization (run_nerf_acc.py:49-54)."""
    cats = ["Background"]
    if cfg.binary:
        cats = ["Sparse projections", "Limited projections"]
    if cfg.num_hidden_units != 128 or cfg.num_layers != 4:
        cats = ["Model architecture"]
    return cats
