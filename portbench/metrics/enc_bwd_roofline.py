"""enc_bwd_roofline (%): kernel #4's bound over its time, a launch at a
time. The bound (the larger of its operations at the bf16 peak and its
bytes at the HBM peak, at the cell's L bands) is taken at the window's mean
launch: its active 16-point tiles and its points, from the port's counters
(``mlp_bwd_tiles``, #4's in an encoded job): the work the kernel cannot
skip. Its time is the ``step/mlp_bwd`` span a replayed step (one launch a
step). Nothing in a cell without an encoding, and nothing without the
counters, the span or a launch."""

from portbench.counts import (PEAK_BF16_FLOPS, PEAK_BYTES_PER_S, enc_bwd_bytes, enc_bwd_flops,
                              encoding_of)
from portbench.spans import totals


def read(ctx):
    _, bands = encoding_of(ctx)
    tot = totals(ctx)
    if not bands or tot is None or not tot["span_steps"]:
        return None
    tiles, ms = tot["mlp_bwd_tiles"], tot["spans"].get("step/mlp_bwd", 0.0)
    launches = tiles.get("launches", 0)
    if not launches or not tiles.get("active") or ms <= 0:
        return None
    _, f, nh = ctx["mlp"]
    active_points = 16.0 * tiles["active"] / launches
    p = tiles["points"] / launches
    bound = max(enc_bwd_flops(active_points, bands, f, nh) / PEAK_BF16_FLOPS,
                enc_bwd_bytes(p, active_points, bands, f, nh) / PEAK_BYTES_PER_S)
    return 100.0 * bound / (ms / tot["span_steps"] / 1e3)
