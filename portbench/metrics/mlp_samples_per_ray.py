"""mlp_samples_per_ray (samples/ray): the MLP points the steps' marches fed
the MLP, over the rays stepped: 300 a ray on a dense step, the Tuning's k
(k_lo for the lo bucket's rays of a two-bucket Tuning) on a compacted one,
from each job's ``dense_rays`` and ``steady_phases``."""

from portbench.counts import march_points


def read(ctx):
    points, rays = march_points(ctx)
    return points / rays if rays else None
