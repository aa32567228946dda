"""Analysis (port of ``nerf_for_angiography_tpu/analysis``): the experiment
loader over run directories and the metric-vs-limited-angle plot."""

from .plots import (
    METRIC_LIMITS,
    PSNR_MAX,
    apply_filters,
    get_cmap,
    load_experiments,
    plot_metric_vs_limited_angle,
)

__all__ = [
    "METRIC_LIMITS",
    "PSNR_MAX",
    "apply_filters",
    "get_cmap",
    "load_experiments",
    "plot_metric_vs_limited_angle",
]
