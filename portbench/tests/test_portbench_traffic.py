"""The generator: the same seed gives the same files, every seed the
same set of lengths, and the warm-up reaches every batch shape."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import traffic

MIXES = Path(__file__).resolve().parents[1] / "traffic"
ALBUMS = {"seconds_min": 120, "seconds_max": 480, "sizes_per_round": 16,
          "pool": 4, "final_blocks": "distinct"}
CLIPS = {"seconds_min": 0.5, "seconds_max": 10, "sizes_per_round": 32,
         "pool": 4, "final_blocks": "distinct"}
CONTENT = json.loads((MIXES / "clips.json").read_text())["content"]
SEED = 2**31 + 977


@pytest.mark.parametrize("mix", [ALBUMS, CLIPS])
def test_lengths_are_a_fixed_set_in_a_seeded_order(mix):
    a = traffic.Plan(mix, 44100, 4096, SEED)
    b = traffic.Plan(mix, 44100, 4096, SEED)
    c = traffic.Plan(mix, 44100, 4096, SEED + 1)
    R = mix["sizes_per_round"]
    fa = [a.file(k) for k in range(3 * R)]
    assert fa == [b.file(k) for k in range(3 * R)]
    fc = [c.file(k) for k in range(3 * R)]
    assert [f.samples for f in fa] != [f.samples for f in fc]
    for r in range(3):
        blocks_a = sorted(f.samples // 4096 for f in fa[r * R:(r + 1) * R])
        blocks_c = sorted(f.samples // 4096 for f in fc[r * R:(r + 1) * R])
        assert blocks_a == blocks_c
    tails = [f.samples % 4096 for f in fa]
    assert len(set(tails)) == len(tails) and 0 not in tails
    assert 4096 - traffic.WARM_TAIL not in tails
    lo, hi = mix["seconds_min"] * 44100, mix["seconds_max"] * 44100
    assert all(lo - 4096 <= f.samples <= hi + 4096 for f in fa)
    assert all(f.offset + f.samples <= a.max_samples for f in fa)
    assert all(x.buffer != y.buffer for x, y in zip(fa, fa[1:]))


def test_pcm_is_made_from_the_seed():
    x = traffic.make_buffer(SEED, 0, 50000, 2, 16, 44100, "cpu", CONTENT)
    y = traffic.make_buffer(SEED, 0, 50000, 2, 16, 44100, "cpu", CONTENT)
    z = traffic.make_buffer(SEED, 1, 50000, 2, 16, 44100, "cpu", CONTENT)
    assert x.dtype == np.int32 and x.shape == (2, 50000)
    assert np.array_equal(x, y) and not np.array_equal(x, z)
    assert np.abs(x).max() <= 32767 and np.abs(x).max() > 8000
    h = traffic.make_buffer(SEED, 0, 5000, 2, 24, 96000, "cpu", CONTENT)
    assert np.abs(h).max() < 2**23 and np.abs(h).max() > 2**20


def test_bursts_and_pauses_are_placed_from_the_seed():
    rate, n = 44100, 44100 * 4
    content = dict(CONTENT,
                   bursts={"per_s": 3, "level": 1.0, "decay_ms": 10},
                   pauses={"share": 0.25, "seconds": 0.5, "floor": 0.0})
    x = traffic.make_buffer(SEED, 0, n, 1, 16, rate, "cpu", content)
    assert np.array_equal(
        x, traffic.make_buffer(SEED, 0, n, 1, 16, rate, "cpu", content))
    plain = traffic.make_buffer(SEED, 0, n, 1, 16, rate, "cpu", CONTENT)
    assert not np.array_equal(x, plain)
    # in a pause only the noise floor stays: a quiet tenth of a second
    rms = np.sqrt((x[0, :n // 4410 * 4410].astype(np.float64) ** 2)
                  .reshape(-1, 4410).mean(axis=1))
    assert rms.min() < 0.05 * np.median(rms)
    traffic.check_content(content, 16)
    with pytest.raises(ValueError):
        traffic.check_content(dict(CONTENT, noise=0.0), 16)


def test_warm_final_blocks_are_one_a_length_and_warmed():
    plan = traffic.Plan(dict(CLIPS, final_blocks="warm"), 44100, 4096,
                        SEED)
    R = CLIPS["sizes_per_round"]
    files = [plan.file(k) for k in range(3 * R)]
    tails = {f.samples % 4096 for f in files}
    assert len(tails) == R
    warm = traffic.warm_lengths(plan, 64, 8)
    assert tails <= {n % 4096 for n in warm if n < 4096}


@pytest.mark.parametrize("n", [1, 4095, 4096, 4097, 64 * 4096 + 5,
                               600 * 4096 + 7, 1300 * 4096])
def test_units_cover_every_sample(n):
    us = traffic.units(n, 4096, 64, 8)
    total = sum(v * 64 * 4096 if k == "super" else
                v * 4096 if k == "batch" else v for k, v in us)
    assert total == n
    assert all(1 <= v <= 8 for k, v in us if k == "super")
    assert all(1 <= v < 64 for k, v in us if k == "batch")


def test_warm_up_reaches_every_batch_shape():
    plan = traffic.Plan(ALBUMS, 96000, 4096, SEED)
    shapes = set()
    for n in traffic.warm_lengths(plan, 64, 8):
        shapes |= {u for u in traffic.units(n, 4096, 64, 8)
                   if u[0] != "tail"}
        assert n % 4096 == 4096 - traffic.WARM_TAIL
    for k in range(40):
        shapes_k = {u for u in traffic.units(plan.file(k).samples, 4096, 64,
                                             8) if u[0] != "tail"}
        assert shapes_k <= shapes
