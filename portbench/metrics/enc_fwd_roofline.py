"""enc_fwd_roofline (%): kernel #3's bound (the larger of its operations at
the bf16 peak and its bytes at the HBM peak, launch by launch from its
point counts, the first layer E = 3 + 6L wide at the cell's L bands) over
its device time in the profiled steps. Nothing in a cell without an
encoding, and nothing when the trace holds another number of #3 launches
than the steps make (one a step's march, one a grid update)."""

from portbench.counts import enc_fwd_bound_s, encoding_of

FWD = "wgmma_enc_fwd_kernel"


def read(ctx):
    prof = ctx["profile"]
    _, bands = encoding_of(ctx)
    if not prof or not bands:
        return None
    hits = [v for name, v in prof["kernels"].items() if FWD in name]
    secs, count = sum(v[0] for v in hits), sum(v[1] for v in hits)
    if not secs or count != len(prof["fwd_points"]):
        return None
    _, f, nh = ctx["mlp"]
    return 100.0 * sum(enc_fwd_bound_s(p, bands, f, nh) for p in prof["fwd_points"]) / secs
