"""Port: ray samplers against the JAX package. The port draws from a
torch.Generator, so the selection is held against JAX's own draws."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_for_angiography_tpu.ops import sampling as sj
from nerf_for_angiography_tpu_torch.ops import sampling as st


@pytest.mark.parametrize("n_rays", [1000, 50_000])
def test_build_sampling_table_exact(n_rays):
    # dyadic weights sum exactly in f32 in any order, so the table is exact
    w = (np.random.default_rng(0).integers(0, 64, n_rays) / 64.0).astype(np.float32)
    want = np.asarray(sj.build_sampling_table(jnp.asarray(w), table_size=1 << 14))
    got = st.build_sampling_table(torch.from_numpy(w), table_size=1 << 14).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_rays", [5000, 260_000])
def test_build_sampling_table_is_a_sequential_f32_cumsum(n_rays):
    """The cdf is the sequential f32 cumsum in ray order (numpy's), bit for
    bit, whatever the weights: the table is the same from run to run and
    device to device."""
    w = np.random.default_rng(n_rays).random(n_rays).astype(np.float32) + 1e-3
    cdf = np.cumsum(w, dtype=np.float32)
    cdf = cdf / cdf[-1]
    u = (np.arange(1 << 14, dtype=np.float32) + np.float32(0.5)) / np.float32(1 << 14)
    want = np.searchsorted(cdf, u, side="left")
    got = st.build_sampling_table(torch.from_numpy(w), table_size=1 << 14).numpy()
    np.testing.assert_array_equal(got, want)
    assert st.build_sampling_table(torch.from_numpy(w), table_size=1 << 14).equal(
        torch.from_numpy(got))


@pytest.mark.parametrize("n_values,n,seed", [(5000, 600, 0), (300, 250, 1), (64, 64, 2)])
def test_overdraw_selection_exact_given_jax_draws(n_values, n, seed):
    w = np.random.default_rng(seed).random(n_values).astype(np.float32) + 1e-3
    table_j = sj.build_sampling_table(jnp.asarray(w), table_size=1 << 12)
    key = jax.random.PRNGKey(seed)
    want = np.asarray(sj.overdraw_sample_indices(key, table_j, n, n_values=n_values))
    # the JAX sampler's draw: randint(key, (ceil(n * 1.125),), 0, table_size)
    draws = np.array(jax.random.randint(key, (math.ceil(n * 1.125),), 0, table_j.shape[0]))
    got = st.overdraw_select(
        torch.from_numpy(np.asarray(table_j).astype(np.int64)), torch.from_numpy(draws).long(),
        n, n_values,
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_overdraw_shortfall_fills_with_earliest_duplicates():
    table = torch.tensor([0, 1, 2, 3])
    draws = torch.tensor([1, 1, 2, 1, 2, 0])  # ray ids 1,1,2,1,2,0
    got = st.overdraw_select(table, draws, 5, 4)
    # unique draws in draw order (1, 2, 0), then the earliest duplicates (1, 1)
    assert got.tolist() == [1, 2, 0, 1, 1]


def _dataset(n):
    rng = np.random.default_rng(0)
    return st.RayDataset(
        origins=torch.from_numpy(rng.random((n, 3)).astype(np.float32)),
        directions=torch.from_numpy(rng.random((n, 3)).astype(np.float32)),
        pixel_values=torch.arange(n, dtype=torch.float32),
        weights=torch.from_numpy(rng.random(n).astype(np.float32) + 0.1),
        image_ids=torch.zeros(n, dtype=torch.int64),
        x_positions=torch.arange(n),
        y_positions=torch.zeros(n, dtype=torch.int64),
    )


def test_sample_pixel_rays_without_replacement():
    data = _dataset(64)
    gen = torch.Generator().manual_seed(0)
    batch = st.sample_pixel_rays(gen, data, 64, weighted=False)
    assert sorted(batch.pixel_values.long().tolist()) == list(range(64))
    table = st.build_sampling_table(data.weights, 1 << 12)
    batch = st.sample_pixel_rays(gen, data._replace(sampling_table=table), 20, impl="overdraw")
    assert len(set(batch.pixel_values.long().tolist())) == 20


def test_gumbel_topk_follows_weights():
    """Heavily weighted rays are drawn first: in distribution only, since
    torch's and JAX's random bits differ."""
    w = torch.ones(1000)
    w[:10] = 1e6
    gen = torch.Generator().manual_seed(0)
    idx = st.gumbel_topk_indices(gen, w, 10)
    assert sorted(idx.tolist()) == list(range(10))
