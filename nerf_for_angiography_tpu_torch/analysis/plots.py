"""Analysis plots: metric-vs-limited-angle line charts (port of
``nerf_for_angiography_tpu/analysis/plots.py``, without pandas).

Re-implements the reference's ``analysis/analysis.py`` with a working data
loader (the reference's was stripped, analysis.py:83-85): experiments are
found from run directories' ``readme.txt`` metadata and the
``df-metrics.csv`` tables the evaluation writes, and returned as a column
table (a dict from column name to a numpy array or a list, one row a run).
The filter predicates (analysis.py:61-75) are plain dict filters; the
truncated colormap (analysis.py:8-13) and per-metric axis limits
(analysis.py:162-199) are kept. matplotlib is imported by the plotting
functions only, so ``load_experiments`` runs where it is not installed.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.csvtable import read_csv_table

# the reference's hard-coded experimental PSNR ceiling (analysis.py:57)
PSNR_MAX = 47.8239

# per-metric plot envelopes (analysis.py:182-199)
METRIC_LIMITS = {
    "PSNR": (5, 48),
    "SSIM": (0.1, 1.0),
    "DICE 2D": (0.0, 1.0),
    "LPIPS": (0.0, 1.0),
    "DISTS": (0.0, 1.0),
}


def pyplot():
    """matplotlib's pyplot on the Agg backend; ImportError naming the
    package where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("matplotlib is not installed; the analysis plots need it") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def get_cmap(base: str = "viridis", minval: float = 0.0, maxval: float = 1.0, n: int = 256):
    """Truncated colormap helper (analysis.py:8-13)."""
    plt = pyplot()
    import matplotlib.colors as mcolors

    return mcolors.LinearSegmentedColormap.from_list(
        f"trunc({base},{minval:.2f},{maxval:.2f})",
        plt.get_cmap(base)(np.linspace(minval, maxval, n)),
    )


def _skipna(f, v) -> float:
    """pandas' skipna reduction of a float column."""
    v = np.asarray(v, np.float64)
    v = v[~np.isnan(v)]
    return float(f(v)) if v.size else float("nan")


def _column(values: list):
    """A loader column as the DataFrame of its rows types it: float64 (NaN
    for a missing value) or bool arrays, else a list."""
    if all(isinstance(v, bool) for v in values):
        return np.array(values, bool)
    if all(isinstance(v, float) for v in values):
        return np.array(values, np.float64)
    return values


def load_experiments(cases_root: str = "cases") -> dict:
    """One row a run: each run's readme.txt key=value metadata (written by
    training/loop.py in the reference's page_data shape) and the min / mean
    of every metric column of its df-metrics.csv."""
    rows = []
    for data_name in sorted(os.listdir(cases_root)) if os.path.isdir(cases_root) else []:
        runs = os.path.join(cases_root, data_name, "runs")
        if not os.path.isdir(runs):
            continue
        for run in sorted(os.listdir(runs)):
            rd = os.path.join(runs, run)
            meta_path = os.path.join(rd, "readme.txt")
            metrics_path = os.path.join(rd, "df-metrics.csv")
            if not os.path.exists(metrics_path):
                continue
            meta = {}
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    for line in f:
                        if "=" in line:
                            k, v = line.strip().split("=", 1)
                            meta[k] = v
            md = read_csv_table(metrics_path)
            row = {
                "run": run,
                "data_name": data_name,
                "Limited projections": float(meta.get("Limited projections", np.nan)),
                "Sparse projections": float(meta.get("Sparse projections", np.nan)),
                "Model architecture": meta.get("Model architecture", "4x128"),
                "Sampling": meta.get("Sampling", ""),
                "Binary": meta.get("Binary", "False") == "True",
            }
            for m in METRIC_LIMITS:
                if m in md:
                    row[f"{m} mean"] = _skipna(np.mean, md[m])
                    row[f"{m} min"] = _skipna(np.min, md[m])
            rows.append(row)
    cols = list(dict.fromkeys(k for r in rows for k in r))
    return {c: _column([r.get(c, float("nan")) for r in rows]) for c in cols}


def _n_rows(table: dict) -> int:
    return len(next(iter(table.values()))) if table else 0


def _take(table: dict, mask: np.ndarray) -> dict:
    idx = np.flatnonzero(mask)
    return {c: v[idx] if isinstance(v, np.ndarray) else [v[i] for i in idx]
            for c, v in table.items()}


def apply_filters(table: dict, filters: dict) -> dict:
    """Plain-dict form of the filter predicates (analysis.py:61-75):
    {'column': value} equality / {'column': (lo, hi)} range /
    {'column': [v1, v2]} membership."""
    out = table
    for col, cond in filters.items():
        v = out[col]
        if isinstance(cond, tuple) and len(cond) == 2:
            a = np.asarray(v)
            mask = (a >= cond[0]) & (a <= cond[1])
        elif isinstance(cond, list):
            mask = np.array([x in cond for x in v], bool)
        else:
            mask = np.array([x == cond for x in v], bool)
        out = _take(out, mask)
    return out


def plot_metric_vs_limited_angle(
    table: dict,
    metric: str = "PSNR",
    group_by: str = "Sparse projections",
    agg: str = "mean",
    out_path: str | None = None,
    filters: dict | None = None,
):
    """Line chart: metric vs limited-angle range, one line a group
    (sparse-projection count / architecture / sampling: analysis.py's chart
    families)."""
    if filters:
        table = apply_filters(table, filters)
    col = f"{metric} {agg}"
    if col not in table or _n_rows(table) == 0:
        raise ValueError(f"no data for {col}")
    plt = pyplot()

    fig, ax = plt.subplots(figsize=(8, 5))
    cmap = get_cmap("viridis", 0.1, 0.9)
    keys = table[group_by]
    groups = sorted({k for k in keys if not (isinstance(k, float) and np.isnan(k))}, key=str)
    limited = np.asarray(table["Limited projections"], np.float64)
    vals = np.asarray(table[col], np.float64)
    for i, g in enumerate(groups):
        rows = np.array([j for j, k in enumerate(keys) if k == g])
        rows = rows[np.argsort(limited[rows], kind="stable")]
        ax.plot(limited[rows], vals[rows], marker="o", label=f"{group_by}={g}",
                color=cmap(i / max(len(groups) - 1, 1)))
    lo, hi = METRIC_LIMITS.get(metric, (None, None))
    if lo is not None:
        ax.set_ylim(lo, hi)
    if metric == "PSNR":
        ax.axhline(PSNR_MAX, ls="--", c="gray", lw=0.8, label="max observed")
    ax.set_xlabel("Limited angle range (degrees)")
    ax.set_ylabel(f"{metric} ({agg})")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    if out_path:
        fig.savefig(out_path, dpi=150)
        plt.close(fig)
    return fig
