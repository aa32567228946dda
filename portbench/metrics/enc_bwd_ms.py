"""enc_bwd_ms (ms): kernel #4's device time a profiled step: its launches
over the encoded, gated input (``bwd_chain_kernel<F, GatedEncX<KE, ...>>``
and ``wgrad_kernel<F, GatedEncX<KE, ...>>``) and the ``reduce_partials``
launches, the weight gradients' partial sum and the dA slots' sum. Nothing
in a cell without an encoding, where #2 does the backward."""

from portbench.counts import encoding_of

PARTS = ("GatedEncX<", "reduce_partials")


def read(ctx):
    prof = ctx["profile"]
    if not prof or not encoding_of(ctx)[1]:
        return None
    secs = sum(v[0] for name, v in prof["kernels"].items() if any(p in name for p in PARTS))
    return 1e3 * secs / prof["n_steps"] if secs else None
