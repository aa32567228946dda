"""composite_ms (ms): the device time a replayed step spends around the MLP
in the step's own PyTorch work: the keep mask, the composite, the loss, the
march's pressure and the metrics (``step/composite``) and the backward
outside kernel #2 (``step/backward`` less ``step/mlp_bwd``: the composite's
autograd, the view shifts' gradient), over the window's jobs' replayed
steps."""

from portbench.spans import stage_ms


def read(ctx):
    return stage_ms(ctx, ("step/composite", "step/backward"), ("step/mlp_bwd",))
