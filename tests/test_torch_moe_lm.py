"""The port's MoE archs (qwen2-moe-a2.7b: 60 experts padded to 64,
top-4, a shared expert; phi3.5-moe-42b-a6.6b: 16 experts, top-2) against
the JAX package's, on their reduced configs with the reference's weights
carried across, at ``_torch_zoo``'s tolerances: fp32 prefill logits and
hidden states within 1e-4, the MoE aux loss within 1e-5 and 8 greedy
tokens equal; bf16 teacher-forced logits within ten bf16 steps at their
magnitude.  The MoE FFN alone is in ``test_torch_moe.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_zoo as zoo
from repro import configs as jconfigs
from repro_torch import configs as tconfigs

MOE_ARCHS = ["qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_fp32_moe_model_matches_reference(arch):
    jm, jp, tm, tp = zoo.models(arch, "float32")
    assert tm.param_count() == jm.param_count()
    zoo.check_fp32(jm, jp, tm, tp)
    toks, _ = zoo.inputs(jm.cfg)
    jx, jaux = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    tx, taux = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_moe_teacher_forced_logits(arch):
    zoo.check_bf16_teacher_forced(*zoo.models(arch, "bfloat16", noise=False))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_config_matches_reference(arch):
    for name in ("get_config", "get_reduced"):
        mine = getattr(tconfigs, name)(arch)
        theirs = getattr(jconfigs, name)(arch)
        assert dataclasses.asdict(mine.moe) == dataclasses.asdict(theirs.moe)
        assert mine.moe.padded_experts == theirs.moe.padded_experts
        assert mine.active_param_count() == theirs.active_param_count()
        assert mine.active_param_count() < mine.param_count()
