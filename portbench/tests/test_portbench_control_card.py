"""The control on the card, at each cell's own size: the reference
computed with TF32 on, in the program's place, fails the cell's limit on
every seed, and the program's own runs pass it.  Needs a CUDA card
(marker ``cuda``; it skips without one):

    PYTHONPATH=src python -m pytest -q -m cuda portbench/tests
"""
import gc

import pytest

from portbench import bench


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    yield torch
    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["rm2v5_mixed_b128", "rm2v4_ddr_b128"])
def test_control_fails_the_limit(card, workload):
    from portbench.families import dlrm
    spec = bench.spec_of(workload)
    limit = spec["cell"]["score_gap_limit"]
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        s = dlrm.Session(spec["name"], spec["config"], spec["cell"],
                         spec["mix"], seed, "cuda")
        bench.serve_window(s, 2.0, False)
        s.free_program()
        chk = s.check(control=True)
        del s
        gc.collect()
        assert chk["failed"] == 0 and chk["compared_samples"] > 500
        assert chk["gap"] <= limit < chk["control_gap"]
