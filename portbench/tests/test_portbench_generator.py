"""The traffic generator: seeded, exact chunk sizes, valid bags."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import generator
from _portbench_cases import REDUCED

MIX = json.loads((Path(__file__).resolve().parents[1] / "traffic" /
                  "lognormal8_fill.json").read_text())


def _mix(**kw):
    m = json.loads(json.dumps(MIX))
    m["pool_samples"] = 128
    m.update(kw)
    return m


def test_pool_is_seeded_and_valid():
    big = 2**31 + 2**30 + 12345
    a = generator.make_pool(_mix(), REDUCED, big, "cpu")
    b = generator.make_pool(_mix(), REDUCED, big, "cpu")
    c = generator.make_pool(_mix(), REDUCED, big + 1, "cpu")
    assert np.array_equal(a.indices, b.indices)
    assert np.array_equal(a.dense, b.dense)
    assert not np.array_equal(a.indices, c.indices)
    idx = a.indices
    P, R = REDUCED["avg_pooling"], REDUCED["rows_per_table"]
    assert idx.shape == (128, REDUCED["num_tables"], P)
    assert idx.max() < R and idx.min() >= -1
    valid = idx >= 0
    lens = valid.sum(axis=2)
    assert lens.min() >= 1 and lens.max() <= P
    # valid slots first, then -1 padding
    assert np.array_equal(valid, np.arange(P)[None, None, :] < lens[..., None])
    assert 0.5 * P < lens.mean() < 0.9 * P


def test_pool_refuses_other_row_draws():
    with pytest.raises(ValueError, match="uniform"):
        generator.make_pool(_mix(indices={"alpha": 1.05}), REDUCED, 1, "cpu")


def test_chunks_fill_whole_batches():
    chunks = generator.make_chunks(MIX, 7, 3 * 128, 6, 4096)
    again = generator.make_chunks(MIX, 7, 3 * 128, 6, 4096)
    assert [c.sizes for c in chunks] == [c.sizes for c in again]
    for c in chunks:
        assert c.samples == 3 * 128
        assert max(c.sizes) <= MIX["sizes"]["max"] and min(c.sizes) >= 1
        assert all(o + s <= 4096 for o, s in zip(c.offsets, c.sizes))
        assert all(b > a for a, b in zip(c.arrivals, c.arrivals[1:]))
    sizes = np.concatenate([c.sizes for c in chunks])
    assert 4 < sizes.mean() < 12
    # the offered rate fills a batch well inside max_wait_s
    rate = 3 * 128 / np.mean([c.arrivals[-1] for c in chunks])
    assert rate > 2 * 128 / 0.002


def test_streams_and_large_seeds_differ():
    draws = {}
    for seed in (7, 7 + 2**32, 2**31 + 7):
        for stream in (generator.CHUNK_STREAM, generator.WARMUP_STREAM):
            g = generator.seeded(seed, stream)
            draws[seed, stream] = tuple(torch.rand(4, generator=g).tolist())
    assert len(set(draws.values())) == len(draws)
