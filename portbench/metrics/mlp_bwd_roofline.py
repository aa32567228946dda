"""mlp_bwd_roofline (%): kernel #2's bound over its time, a launch at a
time. The bound (the larger of its operations at the bf16 peak and its bytes
at the HBM peak) is taken at the window's mean launch: its active 16-point
tiles and its points, from the port's counters (``mlp_bwd_tiles``): the
work the kernel cannot skip. Its time is the ``step/mlp_bwd`` span a
replayed step (one launch a step). Nothing without the counters, the span
or a launch."""

from portbench.counts import PEAK_BF16_FLOPS, PEAK_BYTES_PER_S
from portbench.spans import totals


def bwd_flops(points: float, n_in: int, f: int, nh: int) -> float:
    """The backward's operations over ``points``: the forward recomputed,
    the weight gradients and the input / hidden gradients."""
    fwd = 2.0 * points * (n_in * f + nh * f * f + f)
    dh = 2.0 * points * (nh * f * f + n_in * f)
    return 2.0 * fwd + dh


def bwd_bytes(p: float, active_points: float, n_in: int, f: int, nh: int) -> float:
    """The bytes it has to move once: g (f32) of every point, x (3 f32) of
    the active points, dx (3 f32) of every point, the packed weights (bf16
    input and hidden layers, f32 biases and head) and the f32 gradients."""
    weights = 2 * (16 * f + nh * f * f) + 4 * (nh + 1) * f + 4 * (f + 1)
    grads = 4 * (n_in * f + nh * f * f + (nh + 1) * f + f + 1)
    return 4.0 * p + 12.0 * active_points + 12.0 * p + weights + grads


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
