"""Evaluation and export (port of ``nerf_for_angiography_tpu/evaluation``):
the angle sweep, its metrics, the cag-vis JSONs, the field VTK and the
rotation videos, with the JAX package's names."""

from .heatmap import (
    convert_to_polar,
    experiment_naming,
    get_2d_heatmap,
    hemisphere_mask,
    normalize_cam_poses,
)
from .metrics import (
    binarize,
    dice_binary,
    dice_micro,
    dot_score,
    mse,
    psnr,
    ssim,
)
from .perceptual import PerceptualMetrics, vgg16_features
from .sweep import (
    EvalConfig,
    export_field_vtk,
    make_batch_view_renderer,
    make_view_renderer,
    gt_from_volume,
    lca_eval_config,
    render_sweep_views,
    render_view_pair,
    run_sweep,
    sweep_angles,
)
from .video import get_videos, save_video

__all__ = [
    "EvalConfig",
    "PerceptualMetrics",
    "binarize",
    "convert_to_polar",
    "dice_binary",
    "dice_micro",
    "dot_score",
    "experiment_naming",
    "export_field_vtk",
    "get_2d_heatmap",
    "get_videos",
    "gt_from_volume",
    "hemisphere_mask",
    "lca_eval_config",
    "make_batch_view_renderer",
    "make_view_renderer",
    "mse",
    "normalize_cam_poses",
    "psnr",
    "render_sweep_views",
    "render_view_pair",
    "run_sweep",
    "save_video",
    "ssim",
    "sweep_angles",
    "vgg16_features",
]
