"""device_idle_share (%): 1 - the union of the kernels' device intervals
over the host's span of the profiled steps."""


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof["busy_s"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
