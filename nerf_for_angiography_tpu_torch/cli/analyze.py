"""Analysis CLI (port of ``cli/analyze.py``): the reference's
``analysis/analysis.py`` entry point, with a working experiment loader over
the run directories' readme.txt and df-metrics.csv. Draws with matplotlib;
nothing runs on a device.

    python -m nerf_for_angiography_tpu_torch.cli.analyze --cases_root cases
"""

from __future__ import annotations

import argparse

from ..analysis import load_experiments, plot_metric_vs_limited_angle


def main(argv=None) -> dict:
    """Load the experiments and draw the plot; returns the loaded table."""
    p = argparse.ArgumentParser()
    p.add_argument("--cases_root", default="cases")
    p.add_argument("--metric", default="PSNR")
    p.add_argument("--group_by", default="Sparse projections")
    p.add_argument("--agg", default="mean", choices=["mean", "min"])
    p.add_argument("--out", default="analysis-plot.png")
    a = p.parse_args(argv)

    table = load_experiments(a.cases_root)
    n = len(table["run"]) if table else 0
    if n == 0:
        raise SystemExit(f"no evaluated runs under {a.cases_root}")
    print(f"loaded {n} experiments")
    plot_metric_vs_limited_angle(table, metric=a.metric, group_by=a.group_by, agg=a.agg,
                                 out_path=a.out)
    print(f"wrote {a.out}")
    return table


if __name__ == "__main__":
    main()
