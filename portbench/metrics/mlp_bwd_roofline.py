"""mlp_bwd_roofline (%): kernel #2's bound over its time, a launch at a
time. The bound (the larger of its operations at the bf16 peak and its bytes
at the HBM peak) is taken at the window's mean launch: its active 16-point
tiles and its points, from the port's counters (``mlp_bwd_tiles``): the
work the kernel cannot skip. Its time is the ``step/mlp_bwd`` span a
replayed step (one launch a step). Nothing without the counters, the span
or a launch."""

from portbench.counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, bwd_bytes, bwd_flops
from portbench.spans import totals


def read(ctx):
    tot = totals(ctx)
    if tot is None or not tot["span_steps"]:
        return None
    tiles, ms = tot["mlp_bwd_tiles"], tot["spans"].get("step/mlp_bwd", 0.0)
    launches = tiles.get("launches", 0)
    if not launches or not tiles.get("active") or ms <= 0:
        return None
    n_in, f, nh = ctx["mlp"]
    active_points = 16.0 * tiles["active"] / launches
    p = tiles["points"] / launches
    bound = max(bwd_flops(active_points, n_in, f, nh) / PEAK_BF16_FLOPS,
                bwd_bytes(p, active_points, n_in, f, nh) / PEAK_BYTES_PER_S)
    return 100.0 * bound / (ms / tot["span_steps"] / 1e3)
