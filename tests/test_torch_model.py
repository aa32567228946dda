"""Port: the torch CPPN against the flax CPPN with weights carried across by
convert.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.models import CPPNConfig, init_cppn
from nerf_for_angiography_tpu_torch.convert import cppn_params_from_jax
from nerf_for_angiography_tpu_torch.models import CPPN
from nerf_for_angiography_tpu_torch.models import CPPNConfig as TorchCPPNConfig


def _pair(n_hidden, width, input_scale, dtype_j=jnp.float32, dtype_t=torch.float32):
    cfg_j = CPPNConfig(num_early_layers=n_hidden, num_filters=width, input_scale=input_scale,
                       dtype=dtype_j)
    model_j, params = init_cppn(cfg_j, jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    model_t = CPPN(TorchCPPNConfig(num_early_layers=n_hidden, num_filters=width,
                                   input_scale=input_scale, dtype=dtype_t))
    model_t.load_state_dict(cppn_params_from_jax(params))
    return model_j, params, model_t


@pytest.mark.parametrize("n_hidden,width", [(2, 32), (4, 128)])
def test_cppn_matches_flax_f32(n_hidden, width):
    model_j, params, model_t = _pair(n_hidden, width, 0.01)
    x = np.random.default_rng(0).uniform(-100, 100, (500, 3)).astype(np.float32)
    want = np.asarray(model_j.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (500, 1)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cppn_matches_flax_bf16_compute():
    model_j, params, model_t = _pair(4, 64, 0.01, jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(1).uniform(-100, 100, (500, 3)).astype(np.float32)
    want = np.asarray(model_j.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = model_t(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_state_dict_names_match_flax():
    _, params, model_t = _pair(4, 32, 1.0)
    assert set(cppn_params_from_jax(params)) == set(model_t.state_dict())
    assert {"img1", "img2", "input_layer.weight", "early_3.bias", "output_linear.weight"} <= set(
        model_t.state_dict()
    )


def test_init_matches_flax_in_distribution():
    """lecun_normal kernels (variance 1/fan_in, truncated at 2 std) and zero
    biases, like flax — equal in distribution, not in bits."""
    torch_model = CPPN(TorchCPPNConfig(num_early_layers=4, num_filters=128),
                       generator=torch.Generator().manual_seed(0))
    _, params = init_cppn(CPPNConfig(num_early_layers=4, num_filters=128), jax.random.PRNGKey(0))
    w_j = np.asarray(params["params"]["early_1"]["kernel"])
    w_t = torch_model.early_1.weight.detach().numpy()
    assert abs(w_t.std() - w_j.std()) / w_j.std() < 0.03
    assert np.abs(w_t).max() <= 2.0 / np.sqrt(128) / 0.8796 + 1e-6
    assert all(float(lin.bias.detach().abs().max()) == 0.0 for lin in torch_model.linears())


@pytest.mark.parametrize("kw", [dict(pos_enc="fourier", act_func="sine"),
                                dict(pos_enc="barf", num_input_channels_views=3),
                                dict(act_func="sine"), dict(num_late_layers=1),
                                dict(num_input_channels_views=3)])
def test_unported_model_configs_raise(kw):
    with pytest.raises(NotImplementedError):
        CPPN(TorchCPPNConfig(**kw))
