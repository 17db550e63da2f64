"""The port's LM zoo configs and its dense archs against the JAX
package's.

Every arch's ``CONFIG`` and ``REDUCED`` equal the reference's field for
field, with equal analytic counts; every model the port builds has the
reference's parameter tree (paths, shapes, count).  The dense archs'
reduced models (qwen2.5-14b: QKV bias and padded heads; qwen3-4b: q/k
norm; llama3-8b) hold to the reference at ``_torch_zoo``'s tolerances:
fp32 prefill logits within 1e-4 and 8 greedy tokens equal, bf16
teacher-forced logits within ten bf16 steps at their magnitude.  The
MoE archs are in ``test_torch_moe.py``, whisper and llava in
``test_torch_encdec.py``.
"""
import dataclasses

import pytest

import _torch_zoo as zoo
from repro import configs as jconfigs
from repro.models import registry as jregistry
from repro_torch import configs as tconfigs
from repro_torch.launch import serve
from repro_torch.models import registry as tregistry

DENSE_ARCHS = ["qwen2.5-14b", "qwen3-4b", "llama3-8b"]
#: the LM archs whose models the port builds (every one; the DLRMs'
#: parameters are held in ``test_torch_dlrm.py``)
BUILT_ARCHS = list(jconfigs.ASSIGNED_ARCHS)
PROPERTIES = ["resolved_head_dim", "padded_heads", "attention_free",
              "sub_quadratic", "has_decoder"]


@pytest.mark.parametrize("name", ["CONFIG", "REDUCED"])
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_config_matches_reference(arch, name):
    get = "get_config" if name == "CONFIG" else "get_reduced"
    mine = getattr(tconfigs, get)(arch)
    theirs = getattr(jconfigs, get)(arch)
    for f in dataclasses.fields(theirs):
        a, b = getattr(mine, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    assert [f.name for f in dataclasses.fields(mine)] == \
        [f.name for f in dataclasses.fields(theirs)]
    for prop in PROPERTIES:
        if prop == "resolved_head_dim" and not theirs.num_heads:
            continue                    # a DLRM has no heads
        assert getattr(mine, prop) == getattr(theirs, prop), prop
    assert mine.param_count() == theirs.param_count()
    assert mine.active_param_count() == theirs.active_param_count()


def test_registry_matches_reference():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert tconfigs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    for arch in ("rm1", "rm2"):
        for v in range(6):
            assert dataclasses.asdict(tconfigs.get_generation(arch, v)) == \
                dataclasses.asdict(jconfigs.get_generation(arch, v))
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("no-such-arch")


def _leaves(tree, fn, path=()):
    """{path: fn(leaf)} over a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, fn, path + (k,)))
        return out
    return {path: fn(tree)}


def _shapes(tree):
    return _leaves(tree, lambda a: tuple(a.shape))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", BUILT_ARCHS)
def test_parameter_tree_matches_reference(arch, reduced):
    get = "get_reduced" if reduced else "get_config"
    jm = jregistry.build(getattr(jconfigs, get)(arch))
    tm = tregistry.build(getattr(tconfigs, get)(arch))
    assert tm.param_count() == jm.param_count()
    assert _shapes(tm.param_shapes()) == _shapes(jm.param_shapes())


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen2.5-14b"])
def test_padded_trees_exceed_their_counts(arch):
    """Padded experts (60 -> 64) and heads (40 -> 48) sit in the trees,
    not in the published counts, in both packages."""
    model = tregistry.build(tconfigs.get_config(arch))
    ref = jregistry.build(jconfigs.get_config(arch))
    assert model.param_count() == ref.param_count()
    assert model.cfg.param_count() == ref.cfg.param_count()
    assert model.param_count() > model.cfg.param_count()


@pytest.mark.parametrize("arch", ["zamba2-7b", "rwkv6-3b"])
def test_unpadded_trees_equal_their_counts(arch):
    """The recurrent archs pad nothing (vocab 32000 and 65536 are
    multiples of 128; no heads or experts to pad): tree and published
    count agree, in both packages."""
    model = tregistry.build(tconfigs.get_config(arch))
    ref = jregistry.build(jconfigs.get_config(arch))
    assert model.param_count() == ref.param_count()
    assert model.param_count() == model.cfg.param_count() == \
        ref.cfg.param_count()


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_fp32_dense_arch_matches_reference(arch):
    jm, jp, tm, tp = zoo.models(arch, "float32")
    zoo.check_fp32(jm, jp, tm, tp)


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_bf16_dense_arch_teacher_forced_logits(arch):
    zoo.check_bf16_teacher_forced(*zoo.models(arch, "bfloat16",
                                              noise=False))


def test_params_from_reference_carries_the_zoo_trees():
    """The new trees (``moe``, ``mm_proj``, ``enc_layers``/``dec_layers``)
    cross over leaf for leaf, with the reference's shapes and dtype."""
    for arch in ("qwen2-moe-a2.7b", "llava-next-mistral-7b",
                 "whisper-large-v3"):
        jm, jp, tm, tp = zoo.models(arch, "bfloat16", noise=False)
        info = lambda a: (tuple(a.shape), str(a.dtype).split(".")[-1])
        assert _leaves(tp, info) == _leaves(jp, info), arch
        assert _leaves(tp, info) == _leaves(tm.param_shapes(), info), arch
        assert any(p[-2:] == ("moe", "router") or p[0] in (
            "mm_proj", "enc_layers") for p in _leaves(tp, info))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "llava-next-mistral-7b",
                                  "whisper-large-v3"])
def test_cli_generates_zoo_arch_on_cpu(arch, capsys):
    assert serve.main(["--arch", arch, "--device", "cpu",
                       "--decode-steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "[serve] generated 3 tokens/seq for 2 sequences: [" in out
