"""optimizer_ms (ms): the device time a replayed step spends in its
optimizer span (``step/optimizer``: the lr schedule, the view shifts' lr,
the fused Adam / AdamW step and the step counter), over the window's jobs'
replayed steps."""

from portbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, ("step/optimizer",))
