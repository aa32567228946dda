from .pose import (
    get_rotation,
    source_matrix,
    translation_matrix,
    x_rotation_matrix,
    y_rotation_matrix,
    z_rotation_matrix,
)
from .rays import (
    camera_directions,
    get_depth_values,
    get_ray_values,
    linspace_depths,
    pixel_grid,
    query_points,
    segment_lengths,
    stratify_depths,
)

__all__ = [
    "camera_directions",
    "get_depth_values",
    "get_ray_values",
    "get_rotation",
    "linspace_depths",
    "pixel_grid",
    "query_points",
    "segment_lengths",
    "source_matrix",
    "stratify_depths",
    "translation_matrix",
    "x_rotation_matrix",
    "y_rotation_matrix",
    "z_rotation_matrix",
]
