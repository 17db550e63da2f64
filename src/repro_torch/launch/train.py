"""Training entry point, on the CUDA card unless ``--device`` says
otherwise: the counterpart of ``repro.launch.train``.

Trains an arch of the zoo (smollm-135m, the ~100M assigned arch, by
default) or the paper's RM1/RM2, at its published widths or its reduced
config, on synthetic data from a seed, with checkpoint/restart fault
tolerance:

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --steps 200 --batch 8 --seq 256          # full width, on the card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --reduced                                # reduced config, CPU

The DLRM archs train on ``dlrm_batch`` and the LMs on ``lm_batch``,
through ``data.queries.ShardedLoader``.  The CLI trains on one device,
as the reference's does (its argparse has no ``--mesh``); training on a
mesh is ``train_loop.run_train_loop(mesh=, rules=)`` or
``make_sharded_train_step``, called by every rank of a
``torch.distributed`` world.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import configs
from repro_torch.data.queries import ShardedLoader, dlrm_batch, lm_batch
from repro_torch.models import registry
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_loop import TrainLoopConfig, run_train_loop


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="smollm-135m")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--reduced", action="store_true",
                   help="use the reduced smoke config")
    p.add_argument("--opt", default="adam", choices=["adam", "adagrad", "sgd"])
    p.add_argument("--compress-grads", action="store_true")
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the plain PyTorch path)")
    return p


def build(args, cfg=None):
    """(model, OptConfig, loader, TrainLoopConfig) for the parsed flags;
    ``cfg`` in place of the flags' arch (a cut config, say)."""
    if cfg is None:
        cfg = (configs.get_reduced(args.arch) if args.reduced
               else configs.get_config(args.arch))
    model = registry.build(cfg)
    opt_cfg = OptConfig(kind=args.opt, lr=args.lr,
                        compress_grads=args.compress_grads)
    if cfg.family == "dlrm":
        def gen(rng):
            return dlrm_batch(cfg, args.batch, rng)
    else:
        def gen(rng):
            return lm_batch(cfg.vocab_size, args.batch, args.seq, rng)
    loader = ShardedLoader(gen, seed=args.seed)
    loop_cfg = TrainLoopConfig(
        steps=args.steps, log_every=args.log_every,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir)
    return model, opt_cfg, loader, loop_cfg


def main(argv=None):
    args = parser().parse_args(argv)
    model, opt_cfg, loader, loop_cfg = build(args)
    params, opt_state, history = run_train_loop(
        model, opt_cfg, loader, loop_cfg, device=args.device)
    if len(history) >= 2:
        print(f"[train] loss {history[0][1]:.4f} -> {history[-1][1]:.4f} "
              f"over {args.steps} steps")
    return 0


if __name__ == "__main__":
    sys.exit(main())
