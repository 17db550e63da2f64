"""Serving entry point: disaggregated DLRM scoring and LM generation on the
CUDA card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rm1 --requests 64
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --scenario examples/scenarios/failover_storm.json   # declarative
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rm1 --cluster \\
      --cns 2 --mns 4 --mn-type "2xddr_mn+2xnmp_mn" --fail-mn 1
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rm1 --cluster \\
      --device cpu                       # plain PyTorch path on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rm1 --cluster \\
      --cns 3 --mns 6 --elastic          # diurnal resize schedule
  PYTHONPATH=src python -m repro_torch.launch.serve --cluster \\
      --arrival poisson --sla-p99-ms 60  # live traffic + SLA feedback
  PYTHONPATH=src python -m repro_torch.launch.serve --cluster \\
      --models rm1,rm2                   # RM1 + RM2 fleet on one pool
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --full --decode-steps 8            # LM generation
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch whisper-large-v3 --device cpu   # seeded frames, reduced
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --full                             # Mamba2 + shared attention

The PyTorch counterpart of ``repro.launch.serve``: for the DLRM archs
the single-unit engine and the cluster path, which goes through the
declarative scenario API (``serving.scenario.run_scenario``) with the
flags assembled into a ``ScenarioSpec`` by :func:`spec_from_flags`; for
the LM archs greedy generation through ``LMServingEngine`` (two prompts
of 16 seeded tokens, a 128-slot cache, and for llava and whisper the
reference's seeded fp32 ``images``/``frames`` from the same
``RandomState``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch import configs
from repro_torch.data.queries import QueryDist, dlrm_request_stream
from repro_torch.device import resolve_device
from repro_torch.models import registry
from repro_torch.serving.autoscaler import Autoscaler, AutoscalerConfig
from repro_torch.serving.cluster import parse_mn_types
from repro_torch.serving.engine import (DLRMServingEngine, LMServingEngine,
                                        Request)
from repro_torch.serving.scenario import (FailMN, ModelRef, Resize,
                                          ScenarioSpec, Topology, Workload,
                                          run_scenario)


def spec_from_flags(args) -> ScenarioSpec:
    """The CLI flags, expressed as a ScenarioSpec — the flag combinations
    are a preset builder over the scenario API."""
    mn_types = tuple(parse_mn_types(args.mn_type, args.mns))
    if args.models:
        archs = [a.strip() for a in args.models.split(",") if a.strip()]
        models = tuple(ModelRef(arch=a, reduced=args.reduced,
                                init_seed=args.seed) for a in archs)
    else:
        models = (ModelRef(arch=args.arch, reduced=args.reduced,
                           init_seed=args.seed),)
    events = []
    if args.fail_mn is not None:
        events.append(FailMN(0.001 * args.requests / 2, mn=args.fail_mn))
    if args.elastic:
        # one diurnal day mapped onto the stream; the CLI pool sizes are
        # the peak the trough scales down from
        toy = Autoscaler(AutoscalerConfig(
            qps_per_cn=1.0 / args.cns, qps_per_mn=1.0 / args.mns,
            min_cn=1, min_mn=min(2, args.mns),
            max_cn=args.cns, max_mn=args.mns))
        events += [Resize(e.time_s, n_cn=e.n_cn, m_mn=e.m_mn)
                   for e in toy.plan(peak_load=0.95,
                                     duration_s=0.001 * args.requests,
                                     steps=8)]
    return ScenarioSpec(
        name="cli",
        description="scenario assembled from repro_torch.launch.serve flags",
        models=models,
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
        sla_p99_s=(args.sla_p99_ms / 1e3
                   if args.sla_p99_ms is not None else None),
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
                   help="comma list of archs to serve as a fleet on one "
                        "shared pool (cluster mode), e.g. 'rm1,rm2' — "
                        "overrides --arch; rates split evenly and "
                        "per-model stats report on the shared pool")
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
                   help="follow a diurnal resize schedule mapped onto "
                        "the request stream (cluster mode): both pools "
                        "scale down toward the trough and back")
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
                   help="p99 latency SLA in ms (cluster mode): enables "
                        "the feedback SLAController, which watches the "
                        "measured sliding-window p99 and emits live "
                        "Resize events to hold it under the target")
    p.add_argument("--sla-mode", default="coupled",
                   choices=["coupled", "decoupled"],
                   help="SLA controller scaling split (with --sla-p99-ms)")
    p.add_argument("--hedge-multiplier", type=float, default=0.0,
                   help="hedged re-issue of straggling MN scans: re-issue "
                        "on a replica once a scan exceeds this multiple "
                        "of its nominal time (0 disables)")
    p.add_argument("--no-kernel", dest="use_kernel", action="store_false",
                   default=True)
    p.add_argument("--decode-steps", type=int, default=8,
                   help="LM archs: tokens generated per sequence")
    return p


def _generate(args, cfg, model, device) -> None:
    if args.cluster:
        print("[serve] --cluster only applies to dlrm archs; "
              "running single-unit LM generation")
    rng = np.random.RandomState(args.seed)
    engine = LMServingEngine(model, model.init(args.seed, device=device),
                             cache_len=128, device=device)
    toks = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    extra = {}
    if cfg.family == "audio":
        extra["frames"] = rng.randn(
            2, cfg.encdec.encoder_seq, cfg.d_model).astype(np.float32)
    if cfg.family == "vlm":
        extra["images"] = rng.randn(
            2, cfg.vlm.num_patches, cfg.d_model).astype(np.float32)
    out = engine.generate(toks, steps=args.decode_steps, extra=extra)
    print(f"[serve] generated {out.shape[1]} tokens/seq for "
          f"{out.shape[0]} sequences: {out[0].tolist()}")


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
    model = registry.build(cfg)
    if cfg.family != "dlrm":
        _generate(args, cfg, model, device)
        return 0
    if args.cluster:
        spec = spec_from_flags(args)
        if len(spec.models) > 1:
            # fleet specs build their own models (the single prebuilt
            # model/params pair can't cover the fleet)
            _print_report(run_scenario(spec, device=device))
            return 0
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
