"""``repro_torch.analysis`` — the port's determinism & clock-discipline
tooling (disagglint), the counterpart of ``repro.analysis``.

- **Static half** (``engine`` + ``rules_*``): the reference's AST rule
  engine and rules, scoped to the port's tree (``src/repro_torch/``):
  wall-clock bans, seeded-RNG discipline, set-iteration ordering hazards
  in ``serving/``, frozen-spec hygiene, the ``ScenarioEvent``
  registry/dispatcher sync, ``ClusterStats``/``ModelStats`` drift,
  argparse <-> spec-field sync in ``launch/``, exact float comparison on
  ``*_s`` time values, and kernel hygiene (``rules_kernels``, the
  counterpart of the reference's Pallas rule: the discipline of
  ``kernels/ops.py``'s wrappers).  Run it with ``python -m
  repro_torch.analysis [paths] [--format json]``; suppress a finding
  with ``# disagglint: disable=<rule> -- <reason>`` (the reason is
  mandatory).

- **Runtime half** (``clocksan``, ``REPRO_CLOCKSAN=1`` turns it on): the
  clock sanitizer for the depth-d pipelined virtual clock.

``report`` is the findings schema, shared with the scenario lint's
``--format json``.  The package imports only the standard library at
module scope, so the lint CLI starts without loading torch.
"""
from repro_torch.analysis.engine import (LintResult, lint_paths,  # noqa: F401
                                         load_rules, main)
from repro_torch.analysis.report import (Finding, render_json,  # noqa: F401
                                         render_text)
