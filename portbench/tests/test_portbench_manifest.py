"""BENCHMARK.json against the benchmark's contract: names, units, keys, the
files each entry needs, and the cells each per-layer metric lists."""

from __future__ import annotations

import json
import os
import re

import pytest

from portbench import check, run
from portbench.tests.tiny import BENCH, REPO

with open(os.path.join(REPO, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(MANIFEST) == KEYS
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(MANIFEST["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p.split("/") for p in MANIFEST["paths"])
    assert len(MANIFEST["command"]) <= 32 and all(_line(w) for w in MANIFEST["command"])
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_a_full_check_fits_its_time_with_24_cells():
    rs = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"] + MANIFEST["workloads"]
                         + MANIFEST["end_to_end"] + MANIFEST["per_layer"],
                         ids=lambda e: e["name"])
def test_names_units_and_lines(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert entry["source"] in SOURCES
    for key in entry.get("reduced", []):
        assert NAME.match(key)


def test_entries_have_just_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_are_unique():
    for group in ("configs", "workloads"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))


def _reports(cell: str) -> set[str]:
    return {m["name"] for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])}


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in MANIFEST["workloads"]:
        e2e = _reports(w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in MANIFEST["per_layer"])


@pytest.mark.parametrize("metric", MANIFEST["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metrics_cells_report_what_it_moves(metric):
    assert metric["moves"] in {m["name"] for m in MANIFEST["end_to_end"]}
    assert metric["workloads"]
    for cell in metric["workloads"]:
        assert metric["moves"] in _reports(cell)
    assert metric["moves"] == "train_rays_per_s"


def test_metrics_of_a_layer_name_it_alike():
    by_module = {}
    for m in MANIFEST["per_layer"]:
        by_module.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


def test_every_entry_finds_its_files():
    configs = {c["name"] for c in MANIFEST["configs"]}
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for c in MANIFEST["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(os.path.join(REPO, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    for w in MANIFEST["workloads"]:
        assert w["config"] in configs
        assert os.path.exists(os.path.join(BENCH, "traffic", f"{w['traffic']}.json"))
        with open(os.path.join(BENCH, "limits", f"{w['name']}.json")) as f:
            assert set(json.load(f)["limits"]) == set(check.CHECKS)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", f"{m['name']}.py"))
        assert set(m.get("workloads", cells)) <= cells
    assert {c for w in MANIFEST["workloads"] for c in [w["config"]]} == configs


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)


@pytest.mark.parametrize("cell", [w["name"] for w in MANIFEST["workloads"]])
def test_each_cell_loads_and_the_reference_follows_its_settings(cell):
    spec = run.load_cell(cell)
    train, _, _ = run.settings(spec["config"], spec["traffic"], 1)
    assert check.reference.unmodelled(train) == []
    assert len(spec["traffic"]["job_seeds"]) >= 1


def test_a_cell_the_reference_does_not_follow_is_refused(tmp_path):
    from portbench.tests import tiny

    train = tiny.tiny_train(pos_enc="hashgrid", sample_mode="image")
    root, bench = tiny.make_root(str(tmp_path), train=train)
    with pytest.raises(SystemExit) as e:
        run.load_cell(tiny.WORKLOAD, root, bench)
    assert "pos_enc='hashgrid'" in str(e.value) and "sample_mode='image'" in str(e.value)


@pytest.mark.parametrize("pos_enc", ["fourier", "barf"])
def test_the_reference_follows_the_encodings_at_the_shipped_settings(pos_enc):
    """Each cell's settings with the encoding switched on, its bands, sigma
    and window left at the shipped defaults."""
    for w in MANIFEST["workloads"]:
        spec = run.load_cell(w["name"])
        train, _, _ = run.settings(spec["config"], spec["traffic"], 1)
        assert check.reference.unmodelled({**train, "pos_enc": pos_enc}) == []


def test_a_tiny_fourier_cell_loads(tmp_path):
    from portbench.tests import tiny

    root, bench = tiny.make_root(str(tmp_path), traffic=tiny.FOURIER)
    spec = run.load_cell(tiny.WORKLOAD, root, bench)
    train, _, _ = run.settings(spec["config"], spec["traffic"], 1)
    assert train["pos_enc"] == "fourier" and check.reference.unmodelled(train) == []
    assert check.reference_spec(train, 1500.0)["widths"][0] == 33
