"""counts.py against operations and bytes worked out by hand."""

from __future__ import annotations

import pytest

from portbench import counts


def test_the_cppn_has_66048_matmul_weights():
    # 3 x 128 + 4 x 128 x 128 + 128 x 1
    assert counts.mlp_weights() == 384 + 65536 + 128 == 66048


def test_kernel_1_operations_and_bytes_at_the_dense_step():
    p = 5625 * 300
    assert counts.fwd_flops(p) == 2 * 1_687_500 * 66048 == 222_912_000_000
    # f32 positions in (12 B a point) and raw out (4 B), bf16 weights of the
    # input and hidden layers, f32 biases of five layers, f32 output row
    weights = 2 * (384 + 65536) + 4 * 5 * 128 + 4 * 129
    assert counts.fwd_bytes(p) == 16 * 1_687_500 + weights
    # operations bound it: 2.229e11 / 989e12 s = 0.22539 ms > 27.1 MB / 3.35 TB/s
    assert counts.fwd_bound_s(p) == pytest.approx(222_912_000_000 / 989e12)
    assert counts.fwd_bound_s(p) * 1e3 == pytest.approx(0.225391, rel=1e-5)


def test_bytes_bound_a_small_launch():
    # at one point the weights dominate: 132,916 B at 3.35 TB/s beat 132,096 flops
    assert counts.fwd_bound_s(1) == pytest.approx(counts.fwd_bytes(1) / 3.35e12)


def test_a_training_point_costs_six_operations_a_weight():
    assert counts.train_flops_per_point() == 6 * 66048


@pytest.mark.parametrize("tuning,expect", [
    (None, 300.0),
    ({"mode": "lattice", "k": 160, "w_cap": 0, "w_lo": 0, "k_lo": 0}, 160.0),
    ({"mode": "window", "k": 96, "w_cap": 0, "w_lo": 0, "k_lo": 0}, 96.0),
    # 4,218 lo rays at k_lo 56, 1,407 hi rays at k 96
    ({"mode": "hybrid", "k": 96, "w_cap": 160, "w_lo": 48, "k_lo": 56},
     (4218 * 56 + 1407 * 96) / 5625),
    ({"mode": "hybrid", "k": 96, "w_cap": 160, "w_lo": 48, "k_lo": 0}, 96.0),
    ({"mode": "hybrid", "k": 128, "w_cap": 176, "w_lo": 0, "k_lo": 0}, 128.0),
])
def test_samples_a_ray_of_each_tuning(tuning, expect):
    assert counts.samples_per_ray(tuning, 300, 0.75, 5625) == pytest.approx(expect)


def test_march_points_sum_dense_and_compacted_steps():
    ctx = {"batch": 10, "depth_samples": 300, "hybrid_split": 0.75, "jobs": [{"timing": {
        "dense_rays": 20, "steady_phases": [
            {"mode": "lattice", "k": 96, "w_cap": 0, "w_lo": 0, "k_lo": 0, "steps": 3,
             "rays": 20, "wall_s": 1.0}]}}]}
    assert counts.march_points(ctx) == (20 * 300 + 30 * 96, 50)
