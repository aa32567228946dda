"""step_rays_per_s (rays/s): the rays of the chunk calls' steps over their
own seconds (``step_dense + step_compact``), summed over the window's jobs:
the steps alone, without captures, evals and the chooser."""


def read(ctx):
    rays = sum(j["timing"]["dense_rays"] + sum(p["rays"] for p in j["timing"]["steady_phases"])
               for j in ctx["jobs"])
    secs = sum(j["timing"]["step_dense"] + j["timing"]["step_compact"] for j in ctx["jobs"])
    return rays / secs if secs > 0 else None
