"""The output check fails what it has to: a run with the timed path broken
underneath (each fault of portbench/faults.py that the cell can have,
planted in the port), and the control, the plain reference in float8 put in
the port's place, both at a tiny size on the CPU, in a training, a pose
and a Fourier cell, with limits set between their readings there. On a card the control
also runs at the ct_vessel.train cell's own size."""

from __future__ import annotations

import math

import pytest
import torch

from portbench import check, faults, run
from portbench.reference import steps as reference
from portbench.tests import tiny

LIMITS = tiny.LIMITS
KINDS = {"train": (tiny.TRAIN, tiny.LIMITS), "pose": (tiny.POSE, tiny.POSE_LIMITS),
         "fourier": (tiny.FOURIER, tiny.LIMITS)}
# the kind whose settings a fault needs: the view shifts', the coefficients'
NEEDS = {**{f: "pose" for f in faults.POSE_ONLY}, **{f: "fourier" for f in faults.FOURIER_ONLY}}


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    return {kind: tiny.make_root(str(tmp_path_factory.mktemp(kind)), traffic=traffic,
                                 limits=limits)
            for kind, (traffic, limits) in KINDS.items()}


@pytest.fixture(scope="module")
def cell(cells):
    return cells["train"]


def _run(cell, seed=1):
    root, bench = cell
    return run.run_cell(tiny.WORKLOAD, seed, 0.0, False, root=root, bench=bench,
                        device="cpu", look_for_chip=False)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_port_as_it_is_passes(cells, kind):
    r = _run(cells[kind])
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("kind,fault", [(k, f) for k in sorted(KINDS) for f in sorted(faults.FAULTS)
                                        if NEEDS.get(f, k) == k])
def test_a_fault_under_the_timed_path_fails(cells, kind, fault):
    with faults.FAULTS[fault]():
        r = _run(cells[kind])
    assert not r["correct"], (fault, r["checks"])


def _control_numbers(torch_mod, cfg_train, rays, src_z, seed):
    spec = check.reference_spec(cfg_train, src_z)
    inputs = {k: getattr(rays, k) for k in ("origins", "directions", "pixel_values", "weights",
                                             "image_ids")}
    ref = reference.follow(spec, inputs, seed, check.N_STEPS)
    low = reference.follow(spec, inputs, seed, check.N_STEPS, quant=reference.fp8_quant)
    return check.compare(faults.observed(low), ref)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_the_control_fails_at_a_tiny_size(cells, kind, seed):
    root, bench = cells[kind]
    spec = run.load_cell(tiny.WORKLOAD, root, bench)
    train, datagen, _ = run.settings(spec["config"], spec["traffic"], seed)
    rays, src_z = run.make_dataset(torch, spec["config"], datagen, torch.device("cpu"))
    ok, table = check.judge(_control_numbers(torch, train, rays, src_z, seed), KINDS[kind][1])
    assert not ok, table


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec = run.load_cell("ct_vessel.train")
    limits = check.load_limits("ct_vessel.train")
    for seed in (21, 22, 23):
        train, datagen, _ = run.settings(spec["config"], spec["traffic"], seed)
        rays, src_z = run.make_dataset(torch, spec["config"], datagen, torch.device("cuda"))
        ok, table = check.judge(_control_numbers(torch, train, rays, src_z, seed), limits)
        assert not ok, table
        assert all(math.isfinite(v["value"]) for v in table.values())
