"""Scenario lint/run CLI: ``python -m repro_torch.serving.scenario_cli``.

A thin wrapper so the command-line entry point is a module the serving
package does NOT import: running ``-m repro_torch.serving.scenario``
directly executes that file a second time as ``__main__`` (runpy warns,
and the ``__main__`` copy's event classes would fail the dispatcher's
isinstance checks — ``scenario.py`` guards against the latter by
delegating, but the dual execution and the warning remain).  This
module exists only in ``sys.modules`` as itself, so the scenario module
loads exactly once, under its canonical name.

  PYTHONPATH=src python -m repro_torch.serving.scenario_cli \\
      examples/scenarios/*.json [--run] [--device cpu] \\
      [--write-presets DIR] [--format text|json]

``--run`` serves each file on ``--device`` (default: the CUDA card).
``--format json`` renders the lint outcome in the shared lint report
schema (``repro_torch.analysis.report``: byte-stable, machine-diffable)
and exits nonzero on findings instead of raising.
"""
import sys

from repro_torch.serving.scenario import main

if __name__ == "__main__":
    sys.exit(main())
