"""Column tables and their ``;``-separated CSV files, without pandas.

A column table is a dict from column name to a column: a list, or a numpy
array whose first axis runs over the rows. ``write_csv_table`` writes the
bytes ``pandas.DataFrame(table).to_csv(path, sep=';')`` writes for the same
columns: the unnamed index column first, float32 values in numpy's shortest
float32 form, float64 values as ``repr``, NaN and None as empty cells,
booleans as True / False, and a cell that holds a list or an array as
``str`` of its nested list. ``read_csv_table`` reads such a file back, each
column typed as ``pandas.read_csv(path, sep=';', index_col=0)`` types it:
int64, float64 (empty cells NaN) or bool arrays where every cell parses so,
else a list of strings.
"""

from __future__ import annotations

import csv
import os

import numpy as np


def _cell(v) -> str:
    if v is None:
        return ""
    if isinstance(v, np.ndarray):
        return str(v.tolist())
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (float, np.floating)) and np.isnan(v):
        return ""
    if isinstance(v, np.float32):
        return str(v)
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def column_strings(col) -> list[str]:
    """One column's cells as ``to_csv`` writes them."""
    if isinstance(col, np.ndarray) and col.ndim == 1 and col.dtype.kind in "biuf":
        cells = col.astype(str)
        if col.dtype.kind == "f":
            cells[np.isnan(col)] = ""
        return cells.tolist()
    return [_cell(v) for v in col]


def write_csv_table(table: dict, path: str, columns: list[str] | None = None) -> list[str]:
    """Write ``columns`` (default: all) of ``table`` behind an index column.
    Returns the header."""
    cols = list(table) if columns is None else list(columns)
    n = len(table[cols[0]]) if cols else 0
    cells = [column_strings(table[c]) for c in cols]
    header = [""] + cols
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=";", lineterminator="\n")
        w.writerow(header)
        w.writerows(zip(map(str, range(n)), *cells))
    return header


def _typed(cells: list[str]):
    if not cells:
        return np.array([], np.int64)
    if "" not in cells:
        try:
            return np.array(cells, dtype=np.int64)
        except ValueError:
            pass
    try:
        return np.array([c or "nan" for c in cells], dtype=np.float64)
    except ValueError:
        pass
    if cells and all(c in ("True", "False") for c in cells):
        return np.array([c == "True" for c in cells])
    return cells


def read_csv_table(path: str) -> dict:
    """Read a ``;``-separated CSV with an index column into a column table
    (the index column dropped)."""
    # a list-valued cell (a 150x162 image) is far above csv's default
    # field limit of 131,072 characters
    csv.field_size_limit(max(csv.field_size_limit(), os.path.getsize(path)))
    with open(path, newline="") as f:
        rows = list(csv.reader(f, delimiter=";"))
    if not rows:
        raise ValueError(f"{path}: empty CSV file")
    header = rows[0][1:]
    if any(len(r) != len(header) + 1 for r in rows[1:]):
        raise ValueError(f"{path}: a row does not have the header's {len(header) + 1} fields")
    return {c: _typed([r[j + 1] for r in rows[1:]]) for j, c in enumerate(header)}
