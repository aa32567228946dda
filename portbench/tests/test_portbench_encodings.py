"""The reference's encodings against the port's: the Fourier coefficients
drawn as the port's CPPN draws them, bit for bit; the defaults the
reference assumes equal to the port's; BARF's window at each step; and a
tiny BARF cell whose window opens inside the watched steps, held to the
reference."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.reference import steps as reference
from portbench.reference.encodings import barf, fourier
from portbench.tests import tiny


def _port_model(seed: int, **kw):
    from nerf_for_angiography_tpu_torch.training import TrainConfig
    from nerf_for_angiography_tpu_torch.training.train import create_train_state

    cfg = TrainConfig(**{**tiny.tiny_train(**kw), "seed": seed, "n_iters": 1})
    return create_train_state(cfg, device="cpu")[0]


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 11])
def test_the_reference_draws_the_ports_coefficients_bit_for_bit(seed):
    from portbench import check

    model = _port_model(seed, pos_enc="fourier")
    train = tiny.tiny_train(pos_enc="fourier")
    spec = check.reference_spec(train, 1500.0)
    mlp, enc = reference.init_weights(seed, spec["widths"], "cpu", fourier, train)
    assert len(enc) == 1 and enc[0].shape == (15,)
    assert torch.equal(enc[0], model.fourier_coefficients_pts.detach())
    for a, b in zip(mlp + enc, check.program_leaves(model)):
        assert torch.equal(a, b.detach())


def test_the_references_defaults_are_the_ports():
    from nerf_for_angiography_tpu_torch.training import TrainConfig

    cfg = TrainConfig()
    assert fourier.bands({}) == barf.bands({}) == cfg.pos_enc_basis
    train = {"pos_enc_basis": 5}
    gen = torch.Generator().manual_seed(3)
    (b,) = fourier.leaves(gen, train)
    assert torch.equal(b, torch.randn((15,), generator=torch.Generator().manual_seed(3))
                       * cfg.fourier_sigma)
    assert float(barf.alpha(cfg.barf_start + 1000, {})) == pytest.approx(
        1000 * cfg.pos_enc_basis / (cfg.barf_stop - cfg.barf_start), rel=1e-6)


@pytest.mark.parametrize("step", [0, 1, 2, 3, 4, 7, 9000, 130_000, 250_000, 300_000])
@pytest.mark.parametrize("schedule", [{}, {"barf_start": 0, "barf_stop": 4}])
def test_barfs_window_is_the_ports(step, schedule):
    from nerf_for_angiography_tpu_torch.models.cppn import (barf_alpha_schedule, barf_k_values,
                                                             barf_weights)

    train = {"pos_enc_basis": 5, **schedule}
    a = barf_alpha_schedule(step, 5, **schedule)
    assert float(barf.alpha(step, train)) == a
    assert torch.equal(barf.window(step, train), barf_weights(a, barf_k_values(5, 3)))


def test_barfs_window_opens_inside_the_watched_steps():
    train = {"pos_enc_basis": 5, **tiny.BARF["train"]}
    w = [barf.window(s, train) for s in range(3)]
    assert not w[0].any()
    assert 0 < float(w[1][0]) < 1 and float(w[2][0]) == 1 and 0 < float(w[2][3]) < 1


def test_the_encoded_features_are_the_ports():
    """The reference's encoded features against the port's CPPN encoding
    (its ``_pos_enc``) at the same coefficients and window."""
    x = torch.rand((64, 3), generator=torch.Generator().manual_seed(5)) * 2 - 1
    model = _port_model(4, pos_enc="fourier")
    coeff = model.fourier_coefficients_pts.detach()
    ref = fourier.encode(x, [coeff], 0, {"pos_enc_basis": 5})
    assert ref.shape == (64, 33)
    torch.testing.assert_close(ref, model._pos_enc(x, 5, "pts", 0.0), rtol=0, atol=2e-6)
    model = _port_model(4, pos_enc="barf", barf_start=0, barf_stop=4)
    train = {"pos_enc_basis": 5, "barf_start": 0, "barf_stop": 4}
    torch.testing.assert_close(barf.encode(x, [], 2, train),
                               model._pos_enc(x, 5, "pts", float(barf.alpha(2, train))),
                               rtol=0, atol=2e-6)


@pytest.fixture(scope="module")
def barf_cell(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("barf")), traffic=tiny.BARF)


def test_a_barf_cell_whose_window_moves_is_correct(barf_cell):
    root, bench = barf_cell
    r = run.run_cell(tiny.WORKLOAD, 3, 0.0, False, root=root, bench=bench, device="cpu",
                     look_for_chip=False)
    assert r["correct"], r["checks"]
