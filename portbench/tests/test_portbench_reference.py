"""The plain reference against the port on the CPU, at REDUCED sizes."""
import numpy as np
import pytest
import torch

from portbench import generator, reference
from portbench.families import dlrm
from _portbench_cases import REDUCED, tiny_spec


@pytest.mark.parametrize("workload", ["rm2v5_mixed_b128", "rm2v4_ddr_b128"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_served_scores_match_reference(workload, use_kernel):
    spec = tiny_spec(workload, use_kernel=use_kernel)
    s = dlrm.Session(spec["name"], spec["config"], spec["cell"], spec["mix"],
                     2**31 + 77, "cpu")
    for i in range(3):
        s.serve(i)
    s.free_program()
    chk = s.check(control=True)
    assert chk["failed"] == 0 and chk["attempted"] > 0
    assert chk["compared_samples"] > 0
    assert chk["gap"] <= 1e-6
    assert chk["gap"] < spec["cell"]["score_gap_limit"]


def test_reference_matches_model_serve_step():
    cfg = dict(REDUCED)
    params = dlrm.make_params(cfg, 5, "cpu")
    pool = generator.make_pool({"pool_samples": 64, "indices": "uniform",
                                "bag_length": {"center_frac": 0.7,
                                               "sigma": 0.3}}, cfg, 5, "cpu")
    model = dlrm.port_model(cfg, "t")
    batch = {"dense": torch.from_numpy(pool.dense),
             "indices": torch.from_numpy(pool.indices)}
    with torch.no_grad():
        want = model.serve_step(params, batch).numpy()
    got = reference.scores(params, pool.dense, pool.indices, bag_block=5,
                           tower_block=24)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert float(np.std(np.log(got / (1 - got)))) > 1e-3     # scores vary


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -3.14159, 1e-3])
    r = reference.round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2**-10
    assert r[2] == 1.0                       # tie to even
    assert r[3] == 1.0 + 2**-9               # tie to even, upward
    bits = r.view(torch.int32) & 0x1FFF
    assert bool((bits == 0).all())
    assert torch.allclose(r, x, rtol=2**-11, atol=0)


def test_control_separates_from_the_program_on_the_cpu():
    """The TF32 control (operands rounded to TF32) lies far past the
    program's own gap at REDUCED sizes."""
    spec = tiny_spec(use_kernel=True)
    s = dlrm.Session(spec["name"], spec["config"], spec["cell"], spec["mix"],
                     4242, "cpu")
    for i in range(2):
        s.serve(i)
    s.free_program()
    chk = s.check(control=True)
    assert chk["control_gap"] > 10 * max(chk["gap"], 1e-8)
