"""loop_nonstep_share (%): the share of the jobs' loop time outside the
chunk calls' own step time (1 - (step_dense + step_compact) / total, summed
over the jobs' ``timing``): captures, evals, the chooser, the carve."""


def read(ctx):
    total = sum(j["timing"]["total"] for j in ctx["jobs"])
    steps = sum(j["timing"]["step_dense"] + j["timing"]["step_compact"] for j in ctx["jobs"])
    return 100.0 * (1.0 - steps / total) if total > 0 else None
