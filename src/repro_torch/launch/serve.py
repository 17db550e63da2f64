"""Serving driver: disaggregated DLRM scoring on the CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rm1 --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --scenario examples/scenarios/failover_storm.json   # declarative
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rm1 --cluster \\
      --cns 2 --mns 4 --mn-type "2xddr_mn+2xnmp_mn" --fail-mn 1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rm1 --cluster \\
      --device cpu                       # plain PyTorch path on the CPU

The PyTorch counterpart of ``repro.launch.serve`` for the DLRM archs:
the single-unit engine and the cluster path, which goes through the
declarative scenario API (``serving.scenario.run_scenario``) with the
flags assembled into a ``ScenarioSpec`` by :func:`spec_from_flags`.
``--elastic``, ``--sla-p99-ms``, ``--models`` and the LM archs need
modules that are not ported yet, and raise.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import configs
from repro_torch.data.queries import QueryDist, dlrm_request_stream
from repro_torch.device import resolve_device
from repro_torch.models.dlrm import DLRMModel
from repro_torch.serving.cluster import parse_mn_types
from repro_torch.serving.engine import DLRMServingEngine, Request
from repro_torch.serving.scenario import (FailMN, ModelRef, ScenarioSpec,
                                          Topology, Workload, run_scenario)


def _not_ported(what: str, module: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} needs {module}, which is not ported yet (ROADMAP Queue 1)")


def spec_from_flags(args) -> ScenarioSpec:
    """The CLI flags, expressed as a ScenarioSpec — the flag combinations
    are a preset builder over the scenario API."""
    if args.models:
        raise _not_ported("--models (fleet serving)", "serving/fleet.py")
    if args.elastic:
        raise _not_ported("--elastic", "serving/autoscaler.py")
    if args.sla_p99_ms is not None:
        raise _not_ported("--sla-p99-ms", "serving/autoscaler.py")
    mn_types = tuple(parse_mn_types(args.mn_type, args.mns))
    events = []
    if args.fail_mn is not None:
        events.append(FailMN(0.001 * args.requests / 2, mn=args.fail_mn))
    return ScenarioSpec(
        name="cli",
        description="scenario assembled from repro_torch.launch.serve flags",
        models=(ModelRef(arch=args.arch, reduced=args.reduced,
                         init_seed=args.seed),),
        topology=Topology(
            n_cn=args.cns, m_mn=args.mns, batch_size=args.batch,
            n_replicas=args.replicas, use_kernel=args.use_kernel,
            mn_types=mn_types, cache_mb=args.cache_mb,
            cache_policy=args.cache_policy,
            inflight_depth=args.inflight_depth,
            cn_router=args.cn_router,
            hedge_multiplier=args.hedge_multiplier),
        workload=Workload(requests=args.requests, mean_size=8.0,
                          max_size=4 * args.batch, alpha=args.alpha,
                          gap_s=0.001, seed=args.seed,
                          arrival=args.arrival,
                          burstiness=args.burstiness,
                          trace_path=args.trace),
        sla_mode=args.sla_mode,
        events=tuple(events),
    )


def _print_report(rep) -> None:
    if rep.results:
        scores = np.concatenate([r.outputs for r in rep.results])
        print(f"[serve] scored {rep.completed}/{rep.total} queries "
              f"({scores.size} samples), mean CTR {scores.mean():.4f}")
    else:
        print(f"[serve] scored 0/{rep.total} queries (empty stream)")
    for line in rep.summary():
        print(line)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="rm1")
    p.add_argument("--models", default=None, metavar="A,B",
                   help="fleet serving on one shared pool (not ported "
                        "yet: raises)")
    p.add_argument("--reduced", action="store_true", default=True)
    p.add_argument("--full", dest="reduced", action="store_false")
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device to run on (default: the CUDA card; "
                        "'cpu' runs the plain PyTorch path)")
    p.add_argument("--scenario", default=None, metavar="PATH",
                   help="run a declarative scenario file "
                        "(examples/scenarios/*.json) through "
                        "run_scenario — ignores the other cluster flags")
    p.add_argument("--cluster", action="store_true",
                   help="serve across {n CN, m MN} via ClusterEngine")
    p.add_argument("--cns", type=int, default=2)
    p.add_argument("--mns", type=int, default=4)
    p.add_argument("--replicas", type=int, default=2)
    p.add_argument("--mn-type", default="ddr_mn",
                   help="memory-pool spec: one type for the whole pool "
                        "('nmp_mn'), a comma list, or counted groups "
                        "('2xddr_mn+2xnmp_mn')")
    p.add_argument("--fail-mn", type=int, default=None,
                   help="kill this MN mid-stream (cluster mode)")
    p.add_argument("--elastic", action="store_true",
                   help="diurnal resize schedule (not ported yet: raises)")
    p.add_argument("--alpha", type=float, default=0.0,
                   help="Zipf row-popularity skew of the query stream "
                        "(0 = uniform; production streams ~1.05)")
    p.add_argument("--cache-mb", type=float, default=0.0,
                   help="per-CN hot-row cache budget in MB (cluster mode; "
                        "0 disables)")
    p.add_argument("--inflight-depth", type=int, default=1,
                   help="max batches concurrently inside the MN stage "
                        "(1 = sequential clock)")
    p.add_argument("--cache-policy", default="lru", choices=["lru", "lfu"],
                   help="hot-row cache eviction policy")
    p.add_argument("--cn-router", default="cpu_free",
                   choices=["cpu_free", "pipeline_free",
                            "least_outstanding"],
                   help="batch -> CN placement policy (cluster mode)")
    p.add_argument("--arrival", default="linear",
                   choices=["linear", "poisson", "bursty", "trace"],
                   help="arrival process of the request stream")
    p.add_argument("--burstiness", type=float, default=4.0,
                   help="bursty arrivals: burst/lull rate swing factor")
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="JSON arrival-timestamp trace file "
                        "(requires --arrival trace)")
    p.add_argument("--sla-p99-ms", type=float, default=None,
                   help="p99 latency SLA feedback (not ported yet: raises)")
    p.add_argument("--sla-mode", default="coupled",
                   choices=["coupled", "decoupled"],
                   help="SLA controller scaling split (with --sla-p99-ms)")
    p.add_argument("--hedge-multiplier", type=float, default=0.0,
                   help="hedged re-issue of straggling MN scans: re-issue "
                        "on a replica once a scan exceeds this multiple "
                        "of its nominal time (0 disables)")
    p.add_argument("--no-kernel", dest="use_kernel", action="store_false",
                   default=True)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.scenario:
        spec = ScenarioSpec.load(args.scenario)
        rep = run_scenario(spec, device=device)
        if spec.description:
            print(f"[serve] scenario {spec.name!r}: {spec.description}")
        _print_report(rep)
        return 0

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    model = DLRMModel(cfg)
    if args.cluster:
        spec = spec_from_flags(args)
        params = model.init(args.seed, device=device)
        _print_report(run_scenario(spec, model=model, params=params,
                                   device=device))
        return 0
    qd = QueryDist(mean_size=8.0, max_size=4 * args.batch, alpha=args.alpha)
    reqs = [Request(*t) for t in
            dlrm_request_stream(cfg, args.requests, seed=args.seed,
                                dist=qd, gap_s=0.001)]
    engine = DLRMServingEngine(model, model.init(args.seed, device=device),
                               batch_size=args.batch,
                               use_kernel=args.use_kernel, device=device)
    results = engine.serve(reqs)
    scores = np.concatenate([r.outputs for r in results])
    print(f"[serve] scored {len(results)} queries "
          f"({scores.size} samples), mean CTR {scores.mean():.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
