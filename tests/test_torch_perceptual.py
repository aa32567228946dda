"""Port: the perceptual metrics (VGG16 features, LPIPS, DISTS) against
the JAX package with the uncalibrated weights copied across
(``convert.perceptual_params_from_jax``), rtol 1e-4; ``from_npz`` on a
bundle the test writes, with its sha256 check."""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.evaluation import perceptual as pj
from nerf_for_angiography_tpu_torch.convert import perceptual_params_from_jax
from nerf_for_angiography_tpu_torch.evaluation import perceptual as pt


def _t(a):
    return torch.from_numpy(np.array(a))


def _images(seed=0, shape=(24, 20)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def perceptual_pair():
    pm_j = pj.PerceptualMetrics.uncalibrated(jax.random.PRNGKey(7))
    kw = perceptual_params_from_jax(
        [(np.asarray(w), np.asarray(b)) for w, b in pm_j.vgg_params],
        [np.asarray(w) for w in pm_j.lpips_weights],
        [np.asarray(a) for a in pm_j.dists_alpha], [np.asarray(b) for b in pm_j.dists_beta])
    return pm_j, pt.PerceptualMetrics(**kw, calibrated=False)


def test_vgg16_features_match_jax(perceptual_pair):
    pm_j, pm_t = perceptual_pair
    x = np.random.default_rng(0).standard_normal((1, 20, 18, 3)).astype(np.float32)
    for pool in ("max", "avg"):
        want = pj.vgg16_features(pm_j.vgg_params, jnp.asarray(x), pool=pool)
        got = pt.vgg16_features(pm_t.vgg_params, _t(x.transpose(0, 3, 1, 2)), pool=pool)
        assert len(got) == len(want) == 5
        for g, w in zip(got, want):
            w = np.asarray(w).transpose(0, 3, 1, 2)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("shape", [(32, 32), (20, 26)])
def test_lpips_dists_match_jax(perceptual_pair, shape):
    pm_j, pm_t = perceptual_pair
    a, b = _images(11, shape)
    for fn in ("lpips", "dists"):
        want = float(getattr(pm_j, fn)(jnp.asarray(a), jnp.asarray(b)))
        got = float(getattr(pm_t, fn)(_t(a), _t(b)))
        assert got == pytest.approx(want, rel=1e-4, abs=1e-7), fn
    # a stack of views gives each view its own value
    stack = getattr(pm_t, "lpips")(_t(np.stack([a, b])), _t(np.stack([b, b])))
    assert float(stack[0]) == pytest.approx(float(pm_t.lpips(_t(a), _t(b))), rel=1e-5)
    assert abs(float(stack[1])) < 1e-6


def test_lpips_dists_of_tiny_images_are_nan_as_in_jax(perceptual_pair):
    """12x12 pools to an empty map before the last stage: both packages
    give NaN there (the JAX sweep test's size)."""
    pm_j, pm_t = perceptual_pair
    a, b = _images(2, (12, 12))
    for fn in ("lpips", "dists"):
        assert np.isnan(float(getattr(pm_j, fn)(jnp.asarray(a), jnp.asarray(b))))
        assert np.isnan(float(getattr(pm_t, fn)(_t(a), _t(b))))


def _write_bundle(path, pm_j):
    z = {}
    for i, (w, b) in enumerate(pm_j.vgg_params):
        z[f"conv{i}_w"], z[f"conv{i}_b"] = np.asarray(w), np.asarray(b)
    for i, w in enumerate(pm_j.lpips_weights):
        z[f"lpips{i}"] = np.asarray(w) * (1.0 + i)
    np.savez(path, **z)


def test_from_npz_round_trip_and_sha256(tmp_path, perceptual_pair):
    pm_j, _ = perceptual_pair
    path = str(tmp_path / "vgg.npz")
    _write_bundle(path, pm_j)
    digest = hashlib.sha256(open(path, "rb").read()).hexdigest()
    open(path + ".sha256", "w").write(f"{digest}  vgg.npz\n")
    got = pt.PerceptualMetrics.from_npz(path, device="cpu")
    want = pj.PerceptualMetrics.from_npz(path)
    assert got.calibrated and want.calibrated
    for (w, b), (wj, bj) in zip(got.vgg_params, want.vgg_params):
        np.testing.assert_array_equal(w.numpy(), np.asarray(wj).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
    a, b = _images(4, (32, 32))
    for fn in ("lpips", "dists"):
        assert float(getattr(got, fn)(_t(a), _t(b))) == pytest.approx(
            float(getattr(want, fn)(jnp.asarray(a), jnp.asarray(b))), rel=1e-4)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        pt.PerceptualMetrics.from_npz(path, sha256="0" * 64, device="cpu")
    open(path + ".sha256", "w").write("f" * 64)
    with pytest.raises(ValueError, match="sha256 mismatch"):
        pt.PerceptualMetrics.from_npz(path, device="cpu")


def test_uncalibrated_is_seeded_and_flagged():
    a = pt.PerceptualMetrics.uncalibrated(device="cpu")
    b = pt.PerceptualMetrics.uncalibrated(torch.Generator().manual_seed(1234), device="cpu")
    assert not a.calibrated
    for (wa, _), (wb, _) in zip(a.vgg_params, b.vgg_params):
        assert torch.equal(wa, wb)
    x, y = _images(6, (32, 32))
    assert float(a.lpips(_t(x), _t(x))) < 1e-6
    assert abs(float(a.dists(_t(x), _t(x)))) < 1e-3
    assert float(a.dists(_t(x), _t(y))) > float(a.dists(_t(x), _t(x)))


def test_perceptual_weights_default_to_the_card(tmp_path, perceptual_pair):
    """Both constructors put the weights on the card unless given
    device='cpu', and raise without one, as the sweep's entry points do."""
    path = str(tmp_path / "vgg.npz")
    _write_bundle(path, perceptual_pair[0])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.PerceptualMetrics.uncalibrated()
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.PerceptualMetrics.from_npz(path)
    pm = pt.PerceptualMetrics.from_npz(path, device="cpu")
    assert all(w.device.type == "cpu" for w, _ in pm.vgg_params)
