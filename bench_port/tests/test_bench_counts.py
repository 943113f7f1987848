"""The copied operation and byte counts equal ``chip_smoke.py``'s at its
shapes, and the whole-model count is the 759 GFLOP a pair at 640x480."""
import os
import sys

import pytest

from bench_port.counts import kernels as K
from bench_port.counts.model_flops import pair_forward

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
import chip_smoke  # noqa: E402

C, L = 256, 4800


@pytest.mark.parametrize("B", [1, 2])
def test_kernel_a_matches_chip_smoke(B):
    # chip_smoke.py :610-615, x = src = [B, 4800, 256]
    rows = B * L
    flops = 2 * (rows * (8 * C * C + C * (C // 8) + C)
                 + rows * (2 * C * C + C * (C // 8)))
    nbytes = 2 * rows * C * 2 + rows * C * 2 + 10 * C * C * 2 + 4 * C * 4
    assert K.coarse_layer(rows, rows) == (flops, nbytes)
    assert K.bound_s(flops, nbytes) * 1e3 == pytest.approx(
        chip_smoke.bound_ms(flops, nbytes, chip_smoke.PEAK_BF16_FLOPS)[0])


def test_kernel_a_forward_counts_twelve_launches():
    f, b, n = K.coarse_stack_forward(1, L, L)
    self_f, self_b = K.coarse_layer(2 * L, 2 * L)
    cross_f, cross_b = K.coarse_layer(L, L)
    assert n == 12
    assert (f, b) == (4 * self_f + 8 * cross_f, 4 * self_b + 8 * cross_b)


@pytest.mark.parametrize("B", [1, 8])
def test_kernel_b_matches_chip_smoke(B):
    # chip_smoke.py :681-682
    assert K.dual_softmax(B, L, L) == (2 * 2 * B * L * L * C,
                                       B * (2 * L * C * 2 + L * 8 + L * 4))


@pytest.mark.parametrize("nb", [1024, 8192])
def test_kernel_c_matches_chip_smoke(nb):
    # chip_smoke.py :739-740
    Cf = 128
    assert K.fine_stage(nb) == (
        nb * (2 * 100 * 10 * Cf * Cf + 2 * 2 * 100 * 25 * Cf),
        2 * nb * 25 * Cf * 2 + nb * 3 * 4 + 2 * 10 * Cf * Cf * 2)


@pytest.mark.parametrize("B", [1, 2])
def test_kernel_d_matches_focal_bounds(B):
    flops, nbytes = K.focal_loss(B, L, L)
    want = chip_smoke.focal_bounds(B, L, L, C)
    assert flops / K.PEAK_BF16_FLOPS * 1e3 == pytest.approx(want[0])
    assert nbytes / K.PEAK_BYTES * 1e3 == pytest.approx(want[4])


def test_peaks_match_chip_smoke():
    assert K.PEAK_BF16_FLOPS == chip_smoke.PEAK_BF16_FLOPS
    assert K.PEAK_BYTES == chip_smoke.PEAK_BYTES


def test_model_flops_at_640x480():
    assert pair_forward(480, 640, 1024) / 1e9 == pytest.approx(759, abs=0.5)
