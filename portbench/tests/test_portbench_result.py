"""A whole run of a tiny cell on the CPU (the look for a chip skipped): the
last line's keys, the checks last, the metrics of each --trace, and the
refusals."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def result(cell):
    root, bench = cell
    return run.run_cell(tiny.WORKLOAD, 2**31 + 11, 0.0, False, root=root, bench=bench,
                        device="cpu", look_for_chip=False)


def test_the_result_has_exactly_the_contracts_keys_checks_last(result):
    assert list(result) == KEYS
    json.loads(json.dumps(result))
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}


def test_a_sound_run_is_correct(result):
    assert result["correct"], result["checks"]
    assert result["attempted"] == len(tiny.TRAIN["job_seeds"]) and result["failed"] == 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_trace_0_reports_the_cells_end_to_end_metrics(result):
    assert set(result["metrics"]) == {"setup_s", "train_rays_per_s", "heldout_psnr_db"}
    rays = result["metrics"]["train_rays_per_s"]
    assert rays["unit"] == "rays/s" and rays["value"] > 0


def test_the_same_seed_gives_the_same_inputs(cell):
    root, bench = cell
    spec = run.load_cell(tiny.WORKLOAD, root, bench)
    train, datagen, _ = run.settings(spec["config"], spec["traffic"], 7)
    a, _ = run.make_dataset(torch, spec["config"], datagen, torch.device("cpu"))
    b, _ = run.make_dataset(torch, spec["config"], datagen, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a[:7], b[:7]))


def test_without_a_card_the_command_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = {**os.environ, "PYTHONPATH": tiny.REPO}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "ct_vessel.train", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=tiny.REPO, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_with_the_benchmarks_files_alone_the_command_fails(tmp_path):
    shutil.copy(os.path.join(tiny.REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(tiny.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                           "ct_vessel.train", "--seed", "5", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_the_process_holding_jax_names_is_found(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert run.jax_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.xla_client")
    assert "nerf_for_angiography_tpu" not in run.jax_modules()
