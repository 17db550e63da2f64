"""The benchmark's own FLOP and byte counts against the port's shapes
and against hand counts."""
import json
import math
from pathlib import Path

import pytest

from portbench import counts
from portbench.families import dlrm
from _portbench_cases import REDUCED

CONFIGS = sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.json"))


def _shapes(cfg):
    return dlrm.port_model(cfg, "t").param_shapes()


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.stem)
def test_tower_flops_match_param_shapes(path):
    cfg = json.loads(path.read_text())
    sh = _shapes(cfg)
    mats = [s for tree in (sh["bottom"], sh["top"])
            for k, s in tree.items() if k.startswith("w")]
    T, K = sh["proj"].shape
    D = sh["embed"].shape[-1]
    want = (sum(2 * a * b for a, b in (tuple(m.shape) for m in mats))
            + 2 * T * K * D + 2 * (K + 1) ** 2 * D)
    assert counts.tower_flops_per_sample(cfg) == want
    numel = sum(math.prod(s.shape) for tree in (sh["bottom"], sh["top"])
                for s in tree.values()) + math.prod(sh["proj"].shape)
    assert counts.tower_params(cfg) == numel


def test_generations_sizes():
    v5 = json.loads((CONFIGS[0].parent / "rm2-v5.json").read_text())
    v4 = json.loads((CONFIGS[0].parent / "rm2-v4.json").read_text())
    assert round(counts.tower_flops_per_sample(v5) / 1e9, 3) == 17.002
    assert round(counts.tower_flops_per_sample(v4) / 1e9, 3) == 9.684
    assert round(counts.tower_params(v5) * 4 / 1e9, 2) == 33.98
    assert round(counts.tower_params(v4) * 4 / 1e9, 2) == 19.34


def test_tower_bytes_by_hand():
    cfg = dict(REDUCED)
    # bottom 16-32-16, top (16 + 65*64/2 = 2096)-64-32-1, proj 8 x 64
    params = (16 * 32 + 32 + 32 * 16 + 16 + 2096 * 64 + 64 + 64 * 32 + 32
              + 32 + 1 + 8 * 64)
    assert counts.tower_params(cfg) == params
    B = 3
    assert counts.tower_bytes(cfg, B) == 4 * (params + B * 16 + B * 8 * 16 + B)


def test_bag_bytes_by_hand():
    # 2 bags of 2 tables, P = 3, D = 4: 5 valid slots
    assert counts.bag_bytes(5, 2 * 2 * 3, 2 * 2, 2, 4) == 4 * (
        5 * 4 + 12 + 4 * 4 + 2)
