"""capture_s (s): a job's ``timing["compile"]``, the mean over the window's
jobs: the first eager step of each chunk, its graph captures, the first
eval."""

import statistics


def read(ctx):
    return statistics.fmean(j["timing"]["compile"] for j in ctx["jobs"])
