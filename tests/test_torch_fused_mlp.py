"""Port: the fused-MLP kernels' plain PyTorch versions against the JAX
Pallas kernel pair (interpret mode on the CPU, as tests/test_pallas.py runs
it), with weights carried across by convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.models import CPPNConfig, init_cppn
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import (
    cppn_params_to_list as jax_params_to_list,
)
from nerf_for_angiography_tpu.ops.pallas.fused_mlp import fused_mlp_raw as jax_fused_mlp_raw
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.models import CPPN
from nerf_for_angiography_tpu_torch.models import CPPNConfig as TorchCPPNConfig
from nerf_for_angiography_tpu_torch.ops.kernels import build
from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm


def _setup(n_hidden, width, p, seed=0):
    _, params = init_cppn(
        CPPNConfig(num_early_layers=n_hidden, num_filters=width), jax.random.PRNGKey(seed)
    )
    # non-zero biases so the bias path is exercised
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    for name, leaf in params["params"].items():
        if isinstance(leaf, dict):
            leaf["bias"] = (0.1 * rng.standard_normal(leaf["bias"].shape)).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, (p, 3)).astype(np.float32)
    model = CPPN(TorchCPPNConfig(num_early_layers=n_hidden, num_filters=width))
    model.load_state_dict(cppn_params_from_jax(params))
    return params, model, x


@pytest.fixture(scope="module")
def setup():
    return _setup(n_hidden=3, width=64, p=3001)


@pytest.mark.parametrize("n_hidden,width,p", [(3, 64, 3001), (2, 32, 130), (4, 128, 700)])
def test_plain_forward_matches_pallas_interpret(n_hidden, width, p):
    params, model, x = _setup(n_hidden, width, p)
    want = np.asarray(jax_fused_mlp_raw(jax_params_to_list(params, n_hidden), jnp.asarray(x), True))
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    got = fm.fused_mlp_fwd_reference(packed, torch.from_numpy(x)).numpy()
    assert got.shape == (p,)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    assert np.median(np.abs(got - want)) < 1e-3


def test_plain_backward_matches_pallas_vjp(setup):
    params, model, x = setup
    plist = jax_params_to_list(params, 3)

    def loss_jax(pl_, xx):
        return jnp.mean(jax.nn.sigmoid(jax_fused_mlp_raw(pl_, xx, True)) ** 2)

    g_params, g_x = jax.grad(loss_jax, argnums=(0, 1))(plist, jnp.asarray(x))

    xt = torch.from_numpy(x).requires_grad_(True)
    loss = torch.mean(torch.sigmoid(fm.fused_mlp_raw(fm.cppn_params_to_list(model), xt)) ** 2)
    loss.backward()
    for lin, (dw_j, db_j) in zip(model.linears(), g_params):
        # nn.Linear holds (out, in); the plist and flax hold (in, out)
        for got, want in ((lin.weight.grad.T, dw_j), (lin.bias.grad, db_j)):
            want = np.asarray(want).reshape(got.shape)
            scale = max(np.abs(want).max(), 1e-8)
            np.testing.assert_allclose(got.numpy() / scale, want / scale, atol=3e-2)
    want_dx = np.asarray(g_x)
    scale = max(np.abs(want_dx).max(), 1e-8)
    assert np.abs(xt.grad.numpy()).max() > 0.0
    np.testing.assert_allclose(xt.grad.numpy() / scale, want_dx / scale, atol=2e-2)


def test_plain_backward_shapes_and_head(setup):
    """The plain backward returns the plist layout, and its head gradient is
    the sum of g."""
    _, model, x = setup
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(x.shape[0]).astype(np.float32))
    grads, dx = fm.fused_mlp_bwd_reference(packed, torch.from_numpy(x), g)
    assert [tuple(a.shape) for a, _ in grads] == [(3, 64), (64, 64), (64, 64), (64, 64), (64, 1)]
    assert dx.shape == (x.shape[0], 3)
    np.testing.assert_allclose(grads[-1][1].numpy(), [g.sum().item()], rtol=1e-6)


def test_kernel_layout_roundtrip(setup):
    """The flat kernel gradient layout unpacks into the plist shapes."""
    f, nh = 32, 2
    n = 16 * f + nh * f * f + (nh + 1) * f + f + 1
    flat = torch.arange(n, dtype=torch.float32)
    grads = fm._unflatten_grads(flat, f, nh)
    assert [tuple(a.shape) for a, _ in grads] == [(3, f), (f, f), (f, f), (f, 1)]
    assert [tuple(b.shape) for _, b in grads] == [(f,), (f,), (f,), (1,)]
    assert grads[-1][1].item() == n - 1
    assert grads[1][0][0, 0].item() == 16 * f


def test_cpu_tensors_never_launch(setup):
    _, model, x = setup
    fm.reset_counts()
    xt = torch.from_numpy(x)
    out = fm.fused_mlp_raw(fm.cppn_params_to_list(model), xt)
    out.sum().backward()
    assert fm.fwd_launches == 0 and fm.bwd_launches == 0


def test_kernel_wrapper_raises_without_a_build(setup, monkeypatch):
    """No fallback: asking for the kernel where it cannot be built raises."""
    _, model, x = setup
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    monkeypatch.setattr(fm, "_lib", None)
    # the nvcc lookup of the shared build helper (ops/kernels/build.py)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build, "Path", lambda p: type("P", (), {"exists": lambda self: False})())
    with pytest.raises(RuntimeError, match="nvcc"):
        fm.fused_mlp_fwd_cuda(packed, torch.from_numpy(x))


def test_unsupported_device_raises(setup):
    _, model, _ = setup
    packed = fm.pack_params(fm.cppn_params_to_list(model))
    with pytest.raises(ValueError):
        fm.fused_mlp_fwd(packed, torch.zeros((4, 3), device="meta"))
