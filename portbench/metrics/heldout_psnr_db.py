"""heldout_psnr_db (dB): the held-out PSNR of each window job's final state,
the mean over the jobs. The port renders the held-out view (its eval step on
the dense lattice, after the window); the benchmark takes -10 log10 of the
mean squared error against the dataset's held-out pixels itself."""

import statistics


def read(ctx):
    return statistics.fmean(j["heldout_psnr_db"] for j in ctx["jobs"])
