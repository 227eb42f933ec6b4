"""The generator: seeded inputs repeat exactly, lengths keep their
distribution from seed to seed."""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from wavebench import traffic

SEED = 3_000_000_019       # past 32 signed bits, as the check's seeds are


@pytest.mark.parametrize("spec", [
    {"kind": "gaussian"},
    {"kind": "chirp", "f0": [0.001, 0.05], "f1": [0.1, 0.45], "noise": 0.3},
    {"kind": "tones", "tones": 3, "freq": [0.0005, 0.05], "noise": 0.5},
])
def test_signal_repeats_for_a_seed(spec):
    a = traffic.signal(spec, 3, 1000, traffic.generator(SEED, "cpu"), "cpu")
    b = traffic.signal(spec, 3, 1000, traffic.generator(SEED, "cpu"), "cpu")
    c = traffic.signal(spec, 3, 1000, traffic.generator(SEED + 1, "cpu"),
                       "cpu")
    assert a.dtype == torch.float32 and a.shape == (3, 1000)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_host_chunks_repeat_for_a_seed():
    a = traffic.host_chunks(4, 256, traffic.rng(SEED))
    b = traffic.host_chunks(4, 256, traffic.rng(SEED))
    assert a.dtype == np.float32 and a.shape == (4, 256)
    np.testing.assert_array_equal(a, b)


def test_quantile_lengths_keep_their_distribution():
    spec = {"kind": "log_uniform_quantiles", "count": 256, "low": 100000,
            "high": 2000000, "jitter": 64}
    one = traffic.lengths(spec, traffic.rng(SEED))
    two = traffic.lengths(spec, traffic.rng(SEED + 5))
    assert one == traffic.lengths(spec, traffic.rng(SEED))
    assert one != two
    assert len(one) == 256
    assert all(n & (n - 1) for n in one)             # no power of two
    assert 100000 - 64 <= min(one) and max(one) <= 2000000 + 64
    # the same quantiles, moved by at most the jitter (and one step off a
    # power of two)
    assert max(abs(a - b) for a, b in zip(one, two)) <= 2 * 64 + 1
    mid = sorted(one)[128]
    assert abs(math.log(mid) - 0.5 * math.log(100000 * 2000000)) < 0.01


def test_fixed_lengths_and_orders():
    assert traffic.lengths({"kind": "fixed", "n": 7, "count": 3},
                           traffic.rng(1)) == [7, 7, 7]
    assert traffic.order(5, {}, traffic.rng(1)) == [0, 1, 2, 3, 4]
    shuffled = traffic.order(50, {"shuffle": True}, traffic.rng(SEED))
    assert sorted(shuffled) == list(range(50)) and shuffled != sorted(
        shuffled)
    assert shuffled == traffic.order(50, {"shuffle": True},
                                     traffic.rng(SEED))


def test_sample_keeps_the_same_sizes_for_every_seed():
    spec = {"kind": "log_uniform_quantiles", "count": 256, "low": 100000,
            "high": 2000000, "jitter": 64}
    sizes = []
    for seed in (SEED, SEED + 1):
        host = traffic.rng(seed)
        lengths = traffic.lengths(spec, host)
        got = traffic.sample(lengths, 8, host)
        assert len(got) == 8 and lengths.index(max(lengths)) in got
        sizes.append(sorted(lengths[i] for i in got))
    assert max(abs(a - b) for a, b in zip(*sizes)) <= 2 * 64 + 1
    # equal lengths: which ones the seed decides
    same = [4096] * 16
    picks = {tuple(traffic.sample(same, 2, traffic.rng(s)))
             for s in range(6)}
    assert len(picks) > 1
    assert traffic.sample([5, 6, 7], 8, traffic.rng(1)) == [0, 1, 2]
