"""Port: first-k-active compaction. The plain version (the CPU path of
``ops/kernels/first_k.py``) against the JAX package's XLA formulation and
its Pallas kernel in interpret mode, exactly, and the wrapper's rules. The
CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.ops.occupancy import _first_k_active as first_k_active_j
from nerf_for_angiography_tpu.ops.pallas.first_k import first_k_active_pallas
from nerf_for_angiography_tpu_torch.ops import occupancy as ot
from nerf_for_angiography_tpu_torch.ops.kernels import build
from nerf_for_angiography_tpu_torch.ops.kernels import first_k as fk
from nerf_for_angiography_tpu_torch.training import TrainConfig


def _mask(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return (rng.random(shape) < 0.4).astype(np.float32)
    if kind == "zeros":
        return np.zeros(shape, np.float32)
    if kind == "ones":
        return np.ones(shape, np.float32)
    # rows denser than k, sparser than k, empty, full, one active run
    w = shape[-1]
    rows = [
        np.zeros(w), np.ones(w),
        np.r_[np.zeros(40), np.ones(50), np.zeros(w - 90)],
        np.r_[np.ones(10), np.zeros(w - 10)],
        (rng.random(w) < 0.9).astype(np.float64),
    ]
    return np.stack(rows).astype(np.float32)


# the shapes of tests/test_pallas_first_k.py, plus k > w
CASES = [
    ("random", (37, 160), 88), ("random", (5, 7, 96), 48), ("random", (300, 33), 16),
    ("random", (600, 160), 88), ("zeros", (11, 64), 32), ("ones", (11, 64), 32),
    ("rows", (5, 96), 24), ("random", (50, 48), 56), ("rows", (5, 100), 130),
]


@pytest.mark.parametrize("kind,shape,k", CASES, ids=lambda v: str(v))
def test_first_k_plain_matches_jax(kind, shape, k):
    mask = _mask(kind, shape, seed=sum(shape) + k)
    sel_x, mk_x = first_k_active_j(jnp.asarray(mask), k)
    sel_p, mk_p = first_k_active_pallas(jnp.asarray(mask), k, interpret=True)
    sel_t, mk_t = fk.first_k_active(torch.from_numpy(mask), k)
    assert sel_t.dtype == torch.int32 and mk_t.dtype == torch.float32
    assert tuple(sel_t.shape) == tuple(mk_t.shape) == shape[:-1] + (k,)
    for want_sel, want_mk in ((sel_x, mk_x), (sel_p, mk_p)):
        np.testing.assert_array_equal(sel_t.numpy(), np.asarray(want_sel))
        np.testing.assert_array_equal(mk_t.numpy(), np.asarray(want_mk))


@pytest.mark.parametrize("fka", ["xla", "pallas"])
def test_both_fka_names_take_the_plain_version_on_the_cpu(fka):
    mask = torch.from_numpy(_mask("random", (20, 40), seed=1))
    fk.reset_counts()
    sel, mk = ot._first_k_active(mask, 16, fka)
    want_sel, want_mk = fk.first_k_active_reference(mask, 16)
    assert torch.equal(sel, want_sel) and torch.equal(mk, want_mk)
    assert fk.launches == 0 and not fk.shapes


def test_first_k_rules():
    mask = torch.from_numpy(_mask("random", (4, 16), seed=2))
    with pytest.raises(ValueError, match="fka"):
        ot._first_k_active(mask, 8, "pallas_interpret")
    with pytest.raises(ValueError, match="requires_grad"):
        fk.first_k_active(mask.clone().requires_grad_(True), 8)
    with pytest.raises(ValueError, match="march_fka"):
        TrainConfig(march_fka="pallas_interpret")
    assert TrainConfig(march_fka="pallas").march_fka == "pallas"


def test_kernel_wrapper_raises_without_a_build(monkeypatch):
    """No fallback: asking for the kernel where it cannot be built raises."""
    monkeypatch.setattr(fk, "_lib", None)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    with pytest.raises(RuntimeError, match="nvcc"):
        fk.first_k_active_cuda(torch.zeros((4, 16)), 8)
