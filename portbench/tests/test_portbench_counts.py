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


def test_the_encoded_cppn_has_69888_matmul_weights():
    # E = 3 + 6 x 5 = 33 inputs: 33 x 128 + 4 x 128 x 128 + 128 x 1
    assert counts.mlp_inputs(5) == 33
    assert counts.mlp_weights(counts.mlp_inputs(5)) == 4224 + 65536 + 128 == 69888


def test_kernel_3_operations_and_bytes_at_the_dense_step():
    p = 5625 * 300
    assert counts.enc_fwd_flops(p, 5) == 2 * 1_687_500 * 69888 == 235_872_000_000
    # 3 f32 coordinates in and the f32 raw out (16 B a point), bf16 weights of
    # the 33-wide input layer and the hidden layers, f32 biases of five
    # layers, the f32 output row, the 15 f32 coefficients
    weights = 2 * (4224 + 65536) + 4 * 5 * 128 + 4 * 129 + 4 * 15
    assert weights == 142_656
    assert counts.enc_fwd_bytes(p, 5) == 16 * 1_687_500 + weights == 27_142_656
    # operations bound it: 2.3587e11 / 989e12 s = 0.23850 ms
    assert counts.enc_fwd_bound_s(p, 5) * 1e3 == pytest.approx(0.238495, rel=1e-5)
    # beside them: a sincos a coordinate a band
    assert counts.enc_sincos(p, 5) == 15 * 1_687_500


def test_kernel_4_operations_and_bytes_at_the_dense_step():
    p = 5625 * 300
    # #2's at E = 33: the forward twice (4 x 69,888), the input and hidden
    # gradients (2 x (4 x 128^2 + 33 x 128) = 2 x 69,760), and the dcoeff
    # partials, a multiply-add a sine or cosine feature (2 x 30)
    assert counts.enc_bwd_flops(p, 5) == 1_687_500 * (279_552 + 139_520 + 60) \
        == 707_285_250_000
    # g, x and dx (4 + 12 + 12 B a point, every point active), the packed
    # weights (the input layer 48 columns wide), the f32 gradients (dW_in
    # 33 x 128), the coefficients in and their gradient out
    weights = 2 * (48 * 128 + 65536) + 4 * 5 * 128 + 4 * 129
    grads = 4 * (4224 + 65536 + 5 * 128 + 128 + 1)
    assert (weights, grads) == (146_436, 282_116)
    assert counts.enc_bwd_bytes(p, p, 5) == 28 * 1_687_500 + weights + grads + 120 \
        == 47_678_672
    assert counts.bound_s(counts.enc_bwd_flops(p, 5), counts.enc_bwd_bytes(p, p, 5)) * 1e3 \
        == pytest.approx(0.715152, rel=1e-5)


def test_kernel_2s_counts_are_the_readers_own():
    # at n_in = 3 the input layer packs to 16 columns, as kernel #2 takes it
    f, nh = 128, 4
    assert counts.bwd_bytes(100.0, 40.0, 3, f, nh) == (
        4 * 100 + 12 * 40 + 12 * 100 + 2 * (16 * f + nh * f * f) + 4 * (nh + 1) * f
        + 4 * (f + 1) + 4 * (3 * f + nh * f * f + (nh + 1) * f + f + 1))
    assert counts.bwd_flops(10.0, 3, f, nh) == 2 * (2 * 10 * 66048) + 2 * 10 * (nh * f * f + 3 * f)


@pytest.mark.parametrize("ctx,expect", [
    ({}, ("none", 0)),
    ({"encoding": {"name": "none", "bands": 0}}, ("none", 0)),
    ({"encoding": {"name": "fourier", "bands": 5}}, ("fourier", 5)),
    ({"encoding": {"name": "barf", "bands": 3}}, ("barf", 3)),
])
def test_the_encoding_of_a_context(ctx, expect):
    assert counts.encoding_of(ctx) == expect
