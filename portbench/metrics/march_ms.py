"""march_ms (ms): the device time a replayed step spends drawing its batch
and marching it (the port's ``step/sample`` and ``step/march`` spans: the
ray draw, the view shifts' origins under pose refinement, the occupancy
march and first-k, kernel #5), over the window's jobs' replayed steps."""

from portbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, ("step/sample", "step/march"))
