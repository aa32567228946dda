"""step_mfu (%): the MLP operations of the profiled steps (six a weight a
point the steps' marches fed the MLP, two a weight a point of their grid
updates; with a positional encoding, the weights of the encoded stack, its
first layer E wide) over the device's span of those steps at the card's
bf16 peak: the whole step's share of the peak, whichever kernels do the
work."""

from portbench.counts import (PEAK_BF16_FLOPS, encoding_of, mlp_inputs, mlp_weights,
                              train_flops_per_point)


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["device_span_s"]:
        return None
    n_in, f, nh = ctx["mlp"]
    _, bands = encoding_of(ctx)
    if bands:
        n_in = mlp_inputs(bands, n_in)
    flops = (train_flops_per_point(n_in, f, nh) * prof["train_points"]
             + 2.0 * mlp_weights(n_in, f, nh) * prof["grid_points"])
    return 100.0 * flops / (prof["device_span_s"] * PEAK_BF16_FLOPS)
