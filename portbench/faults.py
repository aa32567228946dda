"""Faults planted under the port's timed path, for the readings that set
the output check's limits (portbench/calibrate.py) and for the test that
sees ``correct`` come out false (portbench/tests/test_faults.py). The
benchmark's own runs never import this module.

- ``unchanged``: a step that returns its state unchanged: the lr (of both
  groups under pose refinement) is 0, so Adam moves no weight;
- ``half_batch``: half of the batch left out, the mean taken over the rest:
  the render's second half of rows carries the first half's residuals;
- ``answer``: the answer altered where it is produced: every pixel the
  composite renders 0.01 brighter;
- ``pose_unchanged``: under pose refinement, a step that leaves the view
  shifts unchanged and updates the field: the shifts' lr (``pose_lr_at``)
  is 0;
- ``coeff_unchanged``: under the Fourier encoding, a step that leaves the
  coefficients unchanged and updates the rest of the field: the
  coefficients sit in an optimizer group of their own whose lr stays 0
  (Adam still keeps their moments).

There is one card a cell, so no exchange between chips to leave out.
"""

from __future__ import annotations

import contextlib
import importlib

import torch


def _train_module():
    # the package re-exports the loop's ``train`` under the module's name
    return importlib.import_module("nerf_for_angiography_tpu_torch.training.train")


@contextlib.contextmanager
def _patched(obj, name: str, wrap):
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield
    finally:
        setattr(obj, name, orig)


def _zero_pose_lr(orig):
    def lr(cfg, count):
        return orig(cfg, count) * 0.0
    return lr


@contextlib.contextmanager
def unchanged():
    tm = _train_module()

    def zero_lr(orig):
        def value(self, count):
            return orig(self, count) * 0.0
        return value

    with _patched(tm.ExponentialDecayLR, "value", zero_lr), \
            _patched(tm, "pose_lr_at", _zero_pose_lr):
        yield


@contextlib.contextmanager
def pose_unchanged():
    with _patched(_train_module(), "pose_lr_at", _zero_pose_lr):
        yield


@contextlib.contextmanager
def coeff_unchanged():
    tm = _train_module()
    loop = importlib.import_module("nerf_for_angiography_tpu_torch.training.loop")

    def freeze(orig):
        def create(*args, **kwargs):
            model, state = orig(*args, **kwargs)
            coeff = getattr(model, "fourier_coefficients_pts", None)
            if coeff is not None:
                field = state.optimizer.param_groups[0]
                field["params"] = [p for p in field["params"] if p is not coeff]
                state.optimizer.add_param_group(
                    {"params": [coeff], "lr": torch.zeros_like(field["lr"]), "weight_decay": 0.0,
                     "frozen": True})
            return model, state
        return create

    def keep_frozen(orig):
        def apply(self, count):
            orig(self, count)
            for group in self.optimizer.param_groups:
                if group.get("frozen"):
                    group["lr"].zero_()
        return apply

    with _patched(loop, "create_train_state", freeze), \
            _patched(tm.ExponentialDecayLR, "apply", keep_frozen):
        yield


def _render_wrap(alter):
    def wrap(orig):
        def render(*args, **kwargs):
            out = orig(*args, **kwargs)
            return (alter(out[0]),) + tuple(out[1:])
        return render
    return wrap


@contextlib.contextmanager
def half_batch():
    tm = _train_module()

    drawn = {}

    def record(orig):
        def sample(*args, **kwargs):
            batch = orig(*args, **kwargs)
            drawn["targets"] = batch.pixel_values
            return batch
        return sample

    def wrap(orig):
        def render(*args, **kwargs):
            out = orig(*args, **kwargs)
            px, t = out[0], drawn.get("targets")
            if t is None or t.shape != px.shape:  # not a training batch (the eval)
                return out
            # rows [h, 2h) carry the residuals of rows [0, h): the loss is the
            # mean over the first half, and so is its gradient
            h = px.shape[0] // 2
            px = torch.cat([px[:h], t[h:2 * h] + (px[:h] - t[:h]), px[2 * h:]])
            return (px,) + tuple(out[1:])
        return render

    with _patched(tm, "sample_pixel_rays", record), _patched(tm, "render_rays", wrap):
        yield


@contextlib.contextmanager
def answer():
    tm = _train_module()

    with _patched(tm, "render_rays", _render_wrap(lambda px: px + 0.01)):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch, "answer": answer,
          "pose_unchanged": pose_unchanged, "coeff_unchanged": coeff_unchanged}
# the faults a cell can have: the view shifts' only under pose refinement,
# the coefficients' only under the Fourier encoding
POSE_ONLY = frozenset({"pose_unchanged"})
FOURIER_ONLY = frozenset({"coeff_unchanged"})


def observed(ref: dict) -> dict:
    """A reference run in the shape of what ``check.StepTap`` observes of
    the port (the control put in the port's place)."""
    return dict(start=ref["start"], targets=ref["targets"], pixels=ref["pixels"],
                losses=[torch.tensor(x) for x in ref["losses"]], grad0=ref["grad0"],
                binary0=ref["binary0"], leaves=ref["leaves"], shifts=ref["shifts"])
