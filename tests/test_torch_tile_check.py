"""chip_smoke.check_tiles, the per-tile measure that holds the
tensor-core attention kernels to their plain versions on the card: it
passes bf16-level noise and catches one 64-row tile that is off by 3%,
even where the elementwise bound would let that tile through."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from chip_smoke import (BWD_BF16_ATOL, BWD_BF16_RTOL, TILE_REL_TOL,
                        check_tiles)


def _plain(s=256, b=2, h=4, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                dtype=np.float32))


def _elementwise_ok(got, want):
    return bool(((got - want).abs() <=
                 BWD_BF16_RTOL * want.abs() + BWD_BF16_ATOL).all())


@pytest.mark.parametrize("s", [256, 77, 1])
def test_bf16_level_noise_passes(s):
    """The plain output rounded to bf16, then moved by up to one more bf16
    ulp (2^-7 of the value) of random sign: every tile stays inside the
    bound."""
    want = _plain(s)
    rng = np.random.default_rng(1)
    ulps = torch.from_numpy(rng.uniform(-1, 1, want.shape).astype(np.float32))
    got = want.bfloat16().float() * (1 + ulps * 2.0 ** -7)
    ok, worst = check_tiles(got, want)
    assert ok and worst > 1e-3


@pytest.mark.parametrize("tile", [0, 2, 3])
def test_one_tile_off_by_three_percent_fails(tile):
    want = _plain()
    got = want.clone()
    got[:, 64 * tile:64 * (tile + 1)] *= 1.03
    ok, worst = check_tiles(got, want)
    assert not ok and worst == pytest.approx(0.03, rel=1e-4)


def test_one_head_of_one_tile_is_enough_to_fail():
    """The measure is taken per (batch, head, tile): a wrong head of one
    tile is not averaged away over the others."""
    want = _plain()
    got = want.clone()
    got[1, 128:192, 2] *= 1.03
    assert not check_tiles(got, want)[0]


def test_a_wrong_tile_of_small_values_fails_where_elementwise_passes():
    """A late causal tile whose values are small (as the grads of the last
    keys are) and off by 3%: every element is inside the elementwise bound,
    which the absolute term dominates there; the tile measure catches it."""
    want = _plain()
    want[:, 192:] *= 1e-2
    got = want.clone()
    got[:, 192:] *= 1.03
    assert _elementwise_ok(got, want)
    ok, worst = check_tiles(got, want)
    assert not ok and worst == pytest.approx(0.03, rel=1e-4)


def test_rounding_noise_around_zero_is_measured_against_the_floor():
    """dK at s = 1 is 0 up to rounding on both sides: the two noises
    differ entirely, which the rms floor keeps from counting as a wrong
    tile."""
    rng = np.random.default_rng(2)
    want = torch.from_numpy(rng.standard_normal((2, 1, 2, 64),
                                                dtype=np.float32)) * 1e-7
    assert check_tiles(torch.zeros_like(want), want)[0]
