"""The port's disagglint (``repro_torch.analysis``) against the
reference's (``repro.analysis``), fixture for fixture.

Every case of ``tests/test_disagglint.py`` is mirrored: its fixture tree
is written twice, once at the reference's scoped paths
(``<tmp>/ref/src/repro/serving/...``) and linted by the reference's
engine, once at the port's (``<tmp>/port/src/repro_torch/serving/...``)
and linted by the port's; both must give the same findings (rule, file
with the package renamed, line) and the same exit code, and the findings
the reference's test expects.  Paths outside the packages
(``benchmarks/``, ``examples/``, ``tests/``) are the same in both trees.
``pallas-hygiene``'s cases become ``kernel-hygiene``'s (clean, a missing
guard, a missing count, a swallowed launch, silent without wrappers),
each held to its Pallas twin's count of findings and exit code.  The
port's JSON report is byte-stable, its CLI gives the reference's exit
codes, and the port's tree lints clean under its own engine.

Fixtures are string literals (inert when this file is linted).
"""
import json
import os
import re
import subprocess
import sys
import textwrap
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import pytest

from repro.analysis import lint_paths as ref_lint
from repro.analysis.engine import parse_suppressions as ref_parse
from repro_torch.analysis import (Finding, LintResult, lint_paths,
                                  render_json)
from repro_torch.analysis.engine import parse_suppressions

REPO = Path(__file__).resolve().parents[1]


@dataclass
class Case:
    """One mirrored lint run: ``{pkg}`` in a path or source becomes
    ``repro`` or ``repro_torch``; ``expect`` the rule ids the reference's
    test expects (in order), ``message`` a text of the first finding."""
    files: Dict[str, str]
    expect: List[str]
    only: Optional[List[str]] = None
    message: str = ""
    docs: Optional[str] = None
    suppressed: Optional[int] = None
    sort: bool = False
    extra: Dict[str, str] = field(default_factory=dict)


def _write(root: Path, pkg: str, case: Case) -> None:
    for rel, src in case.files.items():
        p = root / rel.format(pkg=pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    if case.docs is not None:
        (root / "docs").mkdir(parents=True, exist_ok=True)
        (root / "docs" / "architecture.md").write_text(case.docs)


def _key(result, pkg):
    return [(f.rule, f.file.replace(f"src/{pkg}/", "src/<pkg>/"), f.line)
            for f in result.findings]


def _both(tmp_path, case: Case):
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    _write(ref_root, "repro", case)
    _write(port_root, "repro_torch", case)
    ref = ref_lint([str(ref_root)], root=str(ref_root), only=case.only)
    port = lint_paths([str(port_root)], root=str(port_root), only=case.only)
    return ref, port


WALLCLOCK_BAD = """
    import time

    def stamp():
        return time.time()
"""
WALLCLOCK_GOOD = """
    def stamp(now_s):
        return now_s
"""
RNG_BAD = """
    import numpy as np

    def f():
        return np.random.rand(3)
"""
RNG_GOOD = """
    import numpy as np

    def f(seed):
        return np.random.RandomState(seed).rand(3)
"""
SET_BAD = """
    def order(names):
        dead = {3, 1, 2}
        out = []
        for j in dead:
            out.append(j)
        return out
"""
SET_GOOD = """
    def order(names):
        dead = {3, 1, 2}
        return [j for j in sorted(dead)]
"""
SET_COMP = """
    def f(xs):
        return [x for x in set(xs)]
"""
FROZEN_BAD = """
    from dataclasses import dataclass

    @dataclass(frozen=True)
    class Spec:
        x: int

        def bump(self):
            object.__setattr__(self, "x", self.x + 1)
"""
FROZEN_GOOD = FROZEN_BAD.replace(
    "def bump(self):\n            object.__setattr__(self, \"x\", "
    "self.x + 1)",
    "def __post_init__(self):\n            object.__setattr__(self, \"x\", "
    "int(self.x))")
REGISTRY_SCENARIO = """
    class ScenarioEvent:
        time_s: float

    class FailMN(ScenarioEvent):
        kind = "fail_mn"

    class Extra(ScenarioEvent):
        kind = "extra"

    EVENT_TYPES = {c.kind: c for c in (FailMN, Extra)}
"""
REGISTRY_TIMELINE = """
    class TimelineDispatcher:
        def _apply(self, ev):
            if isinstance(ev, FailMN):
                return "fail"
            elif isinstance(ev, Extra):
                return "extra"
"""
STATS_CLUSTER = """
    class ClusterStats:
        completed: int
        p95: float
"""
STATS_TIMELINE = """
    def run():
        return ClusterStats(completed=1, p95=0.0)
"""
STATS_DOCS = "| `completed` | queries | | `p95` | seconds |\n"
STATS_MODEL_CLUSTER = """
    class ModelStats:
        queries: int
        p99: float

    class ClusterStats:
        completed: int
"""
STATS_MODEL_TIMELINE = """
    def run():
        ms = ModelStats(queries=1, p99=0.0)
        return ClusterStats(completed=1)
"""
STATS_MODEL_DOCS = ("| `completed` | queries |\n"
                    "| `queries` | per-model count | | `p99` | seconds |\n")
CLI_GOOD = """
    import argparse

    class Topology:
        n_cn: int
        m_mn: int

    def build(argv):
        p = argparse.ArgumentParser()
        p.add_argument("--n-cn", type=int, default=2)
        p.add_argument("--m-mn", type=int, default=4)
        args = p.parse_args(argv)
        return Topology(n_cn=args.n_cn, m_mn=args.m_mn)
"""
SUPPRESS = """
    import time

    def stamp():
        return time.time()  # disagglint: disable={what}
"""

SCN, TML = "src/{pkg}/serving/scenario.py", "src/{pkg}/serving/timeline.py"
CLU = "src/{pkg}/serving/cluster.py"


def _stats(cluster=STATS_CLUSTER, timeline=STATS_TIMELINE, docs=STATS_DOCS,
           **kw):
    return Case({CLU: cluster, TML: timeline}, only=["stats-drift"],
                docs=docs, **kw)


CASES = {
    "wallclock_bad": Case({"src/{pkg}/util.py": WALLCLOCK_BAD},
                          ["wallclock"]),
    "wallclock_good": Case({"src/{pkg}/util.py": WALLCLOCK_GOOD}, []),
    "wallclock_aliases_and_from_import": Case({"src/{pkg}/x.py": """
        import time as _t
        from time import perf_counter

        def f():
            return _t.monotonic() + perf_counter()
    """}, ["wallclock"] * 3),
    "wallclock_out_of_scope": Case({"benchmarks/common.py": WALLCLOCK_BAD},
                                   []),
    "global_rng_bad": Case({"src/{pkg}/a.py": RNG_BAD}, ["global-rng"]),
    "global_rng_good": Case({"src/{pkg}/a.py": RNG_GOOD}, []),
    "global_rng_unseeded_ctor_and_stdlib": Case({"src/{pkg}/a.py": """
        import numpy as np
        import random

        def f():
            a = np.random.RandomState()     # unseeded: entropy
            b = random.random()             # process-global
            c = random.Random(7)            # fine: seeded instance
            return a, b, c
    """}, ["global-rng", "global-rng"]),
    "global_rng_keyed_random_not_flagged": Case({"src/{pkg}/a.py": """
        import jax
        from jax import random

        def f(seed):
            key = jax.random.PRNGKey(seed)
            return random.uniform(random.PRNGKey(seed), (3,)), key
    """}, []),
    "global_rng_applies_to_examples": Case({"examples/demo.py": """
        import numpy as np
        x = np.random.rand(4)
    """}, ["global-rng"]),
    "set_iter_bad": Case({"src/{pkg}/serving/x.py": SET_BAD}, ["set-iter"]),
    "set_iter_good": Case({"src/{pkg}/serving/x.py": SET_GOOD}, []),
    "set_iter_comprehension": Case({"src/{pkg}/serving/y.py": SET_COMP},
                                   ["set-iter"]),
    "set_iter_out_of_scope": Case({"src/{pkg}/core/y.py": SET_COMP}, []),
    "frozen_setattr_bad": Case({"src/{pkg}/spec.py": FROZEN_BAD},
                               ["frozen-setattr"]),
    "frozen_setattr_good": Case({"src/{pkg}/spec.py": FROZEN_GOOD}, []),
    "registry_sync_clean": Case({SCN: REGISTRY_SCENARIO,
                                 TML: REGISTRY_TIMELINE}, [],
                                only=["registry-sync"]),
    "registry_sync_missing_kind": Case(
        {SCN: REGISTRY_SCENARIO.replace('kind = "extra"', "pass"),
         TML: REGISTRY_TIMELINE}, ["registry-sync"],
        only=["registry-sync"], message="kind"),
    "registry_sync_missing_event_types_entry": Case(
        {SCN: REGISTRY_SCENARIO.replace("(FailMN, Extra)", "(FailMN,)"),
         TML: REGISTRY_TIMELINE}, ["registry-sync"],
        only=["registry-sync"], message="EVENT_TYPES"),
    "registry_sync_missing_dispatch_arm": Case(
        {SCN: REGISTRY_SCENARIO, TML: REGISTRY_TIMELINE.replace(
            """elif isinstance(ev, Extra):
                return "extra\"""", "")}, ["registry-sync"],
        only=["registry-sync"], message="dispatch arm"),
    "registry_sync_silent_without_anchors": Case(
        {"src/{pkg}/other.py": "x = 1\n"}, [], only=["registry-sync"]),
    "stats_drift_clean": _stats(expect=[]),
    "stats_drift_missing_serialization_kwarg": _stats(
        timeline=STATS_TIMELINE.replace(", p95=0.0", ""),
        expect=["stats-drift"], message="p95"),
    "stats_drift_missing_docs_entry": _stats(
        docs="| `completed` | queries |\n", expect=["stats-drift"],
        message="docs"),
    "stats_drift_model_stats_clean": _stats(
        cluster=STATS_MODEL_CLUSTER, timeline=STATS_MODEL_TIMELINE,
        docs=STATS_MODEL_DOCS, expect=[]),
    "stats_drift_model_stats_missing_kwarg": _stats(
        cluster=STATS_MODEL_CLUSTER,
        timeline=STATS_MODEL_TIMELINE.replace(", p99=0.0", ""),
        docs=STATS_MODEL_DOCS, expect=["stats-drift"], message="p99"),
    "stats_drift_model_stats_missing_docs_entry": _stats(
        cluster=STATS_MODEL_CLUSTER, timeline=STATS_MODEL_TIMELINE,
        docs="| `completed` | queries |\n", expect=["stats-drift"],
        message="ModelStats"),
    "cli_sync_clean": Case({"src/{pkg}/launch/serve.py": CLI_GOOD}, [],
                           only=["cli-sync"]),
    "cli_sync_dead_flag": Case({"src/{pkg}/launch/serve.py": CLI_GOOD.replace(
        'p.add_argument("--m-mn", type=int, default=4)',
        'p.add_argument("--m-mn", type=int, default=4)\n'
        '        p.add_argument("--orphan", type=int, default=0)')},
        ["cli-sync"], only=["cli-sync"], message="orphan"),
    "cli_sync_unknown_spec_keyword": Case(
        {"src/{pkg}/launch/serve.py": CLI_GOOD.replace(
            "m_mn=args.m_mn", "m_mns=args.m_mn")},
        ["cli-sync"], only=["cli-sync"], message="m_mns"),
    "clock_eq_bad": Case({"src/{pkg}/t.py": """
        def same(start_s, end_s):
            return start_s == end_s
    """}, ["clock-eq"]),
    "clock_eq_good": Case({"src/{pkg}/t.py": """
        def same(start_s, end_s, tol):
            assert start_s == end_s        # declared exact-parity pin
            return abs(start_s - end_s) <= tol
    """}, []),
    "clock_eq_out_of_scope_in_tests": Case(
        {"tests/test_x.py": "def f(a_s, b_s):\n    return a_s == b_s\n"}, []),
    "suppression_with_reason_suppresses": Case(
        {"src/{pkg}/u.py": SUPPRESS.format(
            what="wallclock -- fixture exercising the suppression path")},
        [], suppressed=1),
    "suppression_without_reason_is_a_finding": Case(
        {"src/{pkg}/u.py": SUPPRESS.format(what="wallclock")},
        ["bad-suppression", "wallclock"], sort=True),
    "suppression_wrong_rule_does_not_suppress": Case(
        {"src/{pkg}/u.py": SUPPRESS.format(
            what="clock-eq -- wrong rule on purpose")}, ["wallclock"]),
    "parse_error_is_a_finding": Case({"src/{pkg}/broken.py": "def f(:\n"},
                                     ["parse-error"]),
}


@pytest.mark.parametrize("name", list(CASES))
def test_mirrored_case(tmp_path, name):
    case = CASES[name]
    ref, port = _both(tmp_path, case)
    assert _key(port, "repro_torch") == _key(ref, "repro")
    assert port.exit_code() == ref.exit_code()
    assert port.ok == ref.ok
    got = [f.rule for f in port.findings]
    assert (sorted(got) if case.sort else got) == case.expect
    if case.message:
        assert case.message in port.findings[0].message
    if case.suppressed is not None:
        assert port.suppressed == ref.suppressed == case.suppressed
    if not case.expect:
        assert port.files_checked == ref.files_checked >= 1


def test_directive_inside_string_is_inert():
    src = ('BAD = "x = 1  # disagglint: disable=wallclock"\n'
           'y = 2  # disagglint: disable=clock-eq -- a real comment\n')
    sups, problems = parse_suppressions(src)
    rsups, rproblems = ref_parse(src)
    assert [s.line for s in sups] == [s.line for s in rsups] == [2]
    assert problems == rproblems == []


# ------------------------------------------------------- kernel-hygiene
PALLAS_GOOD = """
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        o_ref[0] = x_ref[0]

    def run(x, interpret=False):
        spec = pl.BlockSpec((1, 4), lambda i: (i, 0))
        return pl.pallas_call(kernel, out_shape=None,
                              interpret=interpret)(x)
"""
PALLAS = {
    "clean": PALLAS_GOOD,
    "missing_guard": PALLAS_GOOD.replace(
        ",\n                              interpret=interpret", ""),
    "missing_count": PALLAS_GOOD.replace(
        "o_ref[0] = x_ref[0]", "if x_ref[0] > 0:\n            o_ref[0] = 1"),
    "swallowed_launch": PALLAS_GOOD.replace("pl.BlockSpec((1, 4)",
                                            "pl.BlockSpec((pick(), 4)"),
    "silent_without_wrappers": """
        def run(x):
            return pallas_call(x)     # not a pallas module: no import
    """,
}
KERNEL_GOOD = """
    LAUNCHES = {"k": 0}

    def refuse_grad(name, *ts):
        pass

    def refuse_dtensor(name, *ts):
        pass

    def is_fake(*ts):
        return False

    def wrapper(x):
        refuse_dtensor("k", x)
        if is_fake(x):
            return x
        if x.device.type == "cpu":
            return plain(x)
        refuse_grad("k", x)
        out = launch(x)
        LAUNCHES["k"] += 1
        return out

    def composite(x):
        return wrapper(x).sum()
"""
KERNEL = {
    "clean": (KERNEL_GOOD, [], ""),
    "missing_guard": (KERNEL_GOOD.replace('        refuse_grad("k", x)\n',
                                          ""), [13], "refuse_grad"),
    "missing_count": (KERNEL_GOOD.replace('        LAUNCHES["k"] += 1\n',
                                          ""), [13], "LAUNCHES"),
    "swallowed_launch": (KERNEL_GOOD.replace(
        "        out = launch(x)\n",
        "        try:\n            out = launch(x)\n"
        "        except RuntimeError:\n            out = plain(x)\n"),
        [20], "swallows"),
    "silent_without_wrappers": ("""
        def wrapper(x):
            if x.device.type == "cpu":
                return plain(x)
            return launch(x)
    """, [], ""),
}


@pytest.mark.parametrize("name", list(KERNEL))
def test_kernel_hygiene_case(tmp_path, name):
    """Each of ``pallas-hygiene``'s cases as a ``kernel-hygiene`` case:
    the port's rule on its wrapper fixture gives the findings (lines) it
    should, and as many and the same exit code as the reference's rule
    on the Pallas twin."""
    src, lines, text = KERNEL[name]
    ref = _write_lint(tmp_path / "ref", "src/repro/kernels/k.py",
                      PALLAS[name], ref_lint, ["pallas-hygiene"])
    port = _write_lint(tmp_path / "port", "src/repro_torch/kernels/ops.py",
                       src, lint_paths, ["kernel-hygiene"])
    assert [f.line for f in port.findings] == lines
    assert {f.rule for f in port.findings} <= {"kernel-hygiene"}
    assert len(port.findings) == len(ref.findings)
    assert port.exit_code() == ref.exit_code()
    if text:
        assert text in port.findings[0].message


def _write_lint(root, rel, src, lint, only):
    p = root / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(src))
    return lint([str(root)], root=str(root), only=only)


def test_kernel_hygiene_sees_every_wrapper(tmp_path):
    """On a copy of the port's ``kernels/ops.py`` the rule finds the five
    wrappers clean, and flags each one whose launch count is removed."""
    src = (REPO / "src/repro_torch/kernels/ops.py").read_text()
    clean = _write_lint(tmp_path / "a", "src/repro_torch/kernels/ops.py",
                        src, lint_paths, ["kernel-hygiene"])
    assert clean.ok
    bad = re.sub(r"LAUNCHES\[\"\w+\"\] \+= 1", "pass", src)
    broken = _write_lint(tmp_path / "b", "src/repro_torch/kernels/ops.py",
                         bad, lint_paths, ["kernel-hygiene"])
    names = sorted(f.message.split(":")[0] for f in broken.findings)
    assert names == sorted(["embedding_bag", "embedding_bag_fused_flat",
                            "embedding_bag_nmp_flat", "flash_attention",
                            "flash_decode_partial"])


# ---------------------------------------------------- engine & reporters
def test_json_report_is_byte_stable():
    r = LintResult(findings=[
        Finding("b.py", 2, "wallclock", "msg"),
        Finding("a.py", 9, "clock-eq", "msg"),
    ], files_checked=2)
    one, two = render_json(r), render_json(r)
    assert one == two
    doc = json.loads(one)
    assert [f["file"] for f in doc["findings"]] == ["a.py", "b.py"]
    assert list(doc) == sorted(doc)
    assert doc["ok"] is False


def test_cli_json_and_exit_codes(tmp_path):
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    f = tmp_path / "src" / "repro_torch" / "m.py"
    f.write_text("import time\nx = time.time()\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.analysis", "src",
           "--root", str(tmp_path), "--format", "json"]
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True)
    assert proc.returncode == 1
    assert json.loads(proc.stdout)["findings"][0]["rule"] == "wallclock"
    f.write_text("x = 1\n")
    proc = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                          text=True)
    assert proc.returncode == 0
    assert json.loads(proc.stdout)["ok"] is True


def test_port_lints_clean():
    """``python -m repro_torch.analysis src/repro_torch`` exits 0, every
    suppression carrying a reason, its JSON report byte-stable."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
           "--format", "json"]
    runs = [subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                           text=True) for _ in range(2)]
    doc = json.loads(runs[0].stdout)
    assert runs[0].returncode == 0, doc["findings"]
    assert doc["ok"] is True and doc["files_checked"] > 50
    assert runs[0].stdout == runs[1].stdout
