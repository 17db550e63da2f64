"""Multi-pod dry run: every (arch x shape x mesh) cell's program run
once under fake tensors on the production mesh of 256 or 512 ranks;
record each rank's memory, its cost and its collective traffic.

The counterpart of ``repro.launch.dryrun``, which compiles each cell on
512 placeholder host devices and reads XLA's memory and cost analysis.
PyTorch has no compiler analysis, so the port runs the program itself,
as rank 0 of a fake process group (``torch.distributed``'s ``fake``
backend: every collective returns at once), under ``FakeTensorMode``:
tensors carry shapes and dtypes and no storage, nothing is allocated or
launched, so no card is needed.  ``build_program``'s example arguments
(placed meta DTensors) become DTensors whose local blocks are fake
``cuda:0`` tensors (fake CPU tensors where PyTorch has no CUDA:
:func:`fake_device`); the kernel wrappers take their fake path
(``kernels.ops``: fake outputs, their calls in ``ops.FAKE_LAUNCHES``).

The record has the reference's keys and file names:

- ``memory``: ``argument_bytes``, rank 0's local bytes of the parameters,
  optimizer state, batch and cache; ``output_bytes``, the outputs' local
  bytes; ``alias_bytes``, the outputs that are arguments written in place
  (the parameters and state in train, the cache in decode: the
  reference's ``donate_argnums``); ``temp_bytes``, the peak of the live
  storage that the call allocated, less the outputs' new storage (XLA's
  temp excludes both arguments and outputs), so that
  ``total_per_device_bytes``, the reference's sum, is the call's peak;
- ``cost``: ``flops`` from ``FlopCounterMode`` plus the kernels' own
  counts (``ops.kernel_cost``); ``bytes accessed``, every dispatched op's
  operand and output bytes (views and allocations move none) plus the
  kernels', eager traffic: an upper bound on XLA's fused figure;
- ``collectives``: the tally of ``distributed.sharding.COLLECTIVES`` by
  kind (the reference's keys: bytes a rank, ``total``, ``counts``) and
  ``by_axis``;
- ``kernels``: the kernel calls (``ops.FAKE_LAUNCHES``).

``no_counterpart`` names the reference's fields that have none here
(written as null): ``generated_code_bytes`` (no compiled code),
``hlo_scaled`` (the port's loops run every trip, so ``cost`` is already
the loop-scaled total, but for the cells in ``loop_scaled``) and
``cost.transcendentals``.  rwkv6's ``wkv_scan`` is a Python loop of four
ops a token, which a train step runs in nested checkpointed chunks and
sub-chunks; its cells run each loop's first two bodies (trips, blocks)
and scale the second's cost by the body count (``models.rwkv6.SCAN_HOOK``
and ``BLOCK_HOOK``, hooks that only the dry run sets), as the
reference's ``hlo_cost_scaled`` scales a while body, and the record says
so in ``loop_scaled``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --mesh both \\
      --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import traceback
import weakref
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pytree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.configs.base import (MULTI_POD, SHAPES, SINGLE_POD,
                                      MeshConfig, ModelConfig, ShapeConfig,
                                      shape_applicable)
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import build_program
from repro_torch.models import rwkv6
from repro_torch.models.params import tree_map

#: the reference's record fields with no counterpart here (null)
NO_COUNTERPART = ["generated_code_bytes", "hlo_scaled",
                  "cost.transcendentals"]

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")
_ALLOCS = {torch.ops.aten.empty.memory_format,
           torch.ops.aten.empty_strided.default,
           torch.ops.aten.empty_like.default,
           torch.ops.aten.new_empty.default}


def mesh_config(multi_pod: bool,
                mesh_shape: Optional[Sequence[int]] = None) -> MeshConfig:
    """The production mesh, or ``mesh_shape`` over ("data", "model") or
    ("pod", "data", "model")."""
    if mesh_shape is None:
        return MULTI_POD if multi_pod else SINGLE_POD
    axes = ("data", "model") if len(mesh_shape) == 2 else (
        "pod", "data", "model")
    return MeshConfig(tuple(mesh_shape), axes)


def fake_mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None):
    """The ``DeviceMesh`` of :func:`mesh_config` in the open fake world,
    on the fake tensors' device type."""
    kind = fake_device().type
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device=kind)
    mc = mesh_config(multi_pod, mesh_shape)
    return init_device_mesh(kind, mc.shape, mesh_dim_names=mc.axes)


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A fake process group of ``world_size`` ranks with this process as
    rank 0, torn down on exit; an open fake world at least as large is
    used as it is."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world_size:
            raise RuntimeError(
                f"the dry run needs a fake world of {world_size} ranks; "
                f"this process has a {dist.get_backend()} world of "
                f"{dist.get_world_size()}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------ fake tensors


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree: Any) -> List[torch.Tensor]:
    """The tensors of a nested dict/tuple/list, DTensors as their local
    blocks."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def fake_device() -> torch.device:
    """Where the fake tensors lie: ``cuda:0``, or the CPU on a PyTorch
    built without CUDA, where a fake CUDA tensor can be neither indexed
    (``Tensor.__getitem__`` takes a CUDA device guard) nor differentiated
    (autograd's input metadata does too, and aborts the process).  The
    kernel wrappers take their fake path on either device."""
    return torch.device("cuda:0" if torch.backends.cuda.is_built()
                        else "cpu")


def _to_fake(mode, tree: Any) -> Any:
    """``tree`` with each placed meta DTensor's local block replaced by a
    contiguous fake tensor on :func:`fake_device` (a rank's placed block
    is a copy)."""
    dev = fake_device()

    def conv(x):
        if not isinstance(x, DTensor):
            return x
        loc = x.to_local()
        with mode:
            fake = torch.empty(loc.shape, dtype=loc.dtype, device=dev)
        return DTensor.from_local(fake, x.device_mesh, x.placements,
                                  shape=x.shape, stride=x.stride())
    return tree_map(conv, tree)


class _Cost(TorchDispatchMode):
    """Bytes every dispatched op reads and writes, and the live storage
    the call allocated (current and peak), tracked by each new storage's
    lifetime (meta tensors, which the program makes for their strides,
    hold none)."""

    def __init__(self, arg_storages):
        super().__init__()
        self.args = {id(s) for s in arg_storages}
        self.live: Dict[int, int] = {}
        self.cur = self.peak = self.bytes = 0

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in _pytree_leaves(out) if isinstance(t, torch.Tensor)]
        if not (func.is_view or func in _ALLOCS):
            ins = [t for t in _pytree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for t in outs:
            if t.device.type == "meta":       # a shape's stride, say
                continue
            s = t.untyped_storage()
            key = id(s)
            if key in self.args or key in self.live:
                continue
            self.live[key] = s.nbytes()
            self.cur += s.nbytes()
            self.peak = max(self.peak, self.cur)
            weakref.finalize(s, self._free, key)
        return out


# ------------------------------------------------------------------ a cell


def _collectives() -> Dict[str, Any]:
    """``shd.COLLECTIVES`` in the reference's record form."""
    out: Dict[str, Any] = {k: 0.0 for k in _KINDS}
    counts = {k: 0 for k in _KINDS}
    by_axis: Dict[str, Dict[str, Dict[str, int]]] = {}
    for kind, axes in sorted(shd.COLLECTIVES.items()):
        for axis, (calls, moved) in sorted(axes.items()):
            out[kind] += moved
            counts[kind] += calls
            by_axis.setdefault(kind, {})[axis] = {"calls": calls,
                                                  "bytes": moved}
    out["total"] = float(sum(out[k] for k in _KINDS))
    out["counts"] = counts
    out["by_axis"] = by_axis
    return out


class _Standin(torch.autograd.Function):
    """A loop's output over ``count`` bodies from the ``n`` bodies that
    ran (``ys``, each with the loop's token axis at dim 1) and one
    allocation for the others.  Its backward gives each ``y`` its slice
    of the gradient and each of ``tensors`` (the operands of the bodies
    that did not run) a gradient (unset: no traffic), as those bodies
    would: without it autograd would prune the backward of whatever
    feeds the loop's state alone (rwkv6's decay ``w``)."""

    @staticmethod
    def forward(count, n, *tensors):
        ys = tensors[:n]
        shape = list(ys[0].shape)
        shape[1] *= count - n
        return torch.cat(list(ys) + [ys[0].new_empty(shape)], dim=1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n = inputs[1]
        ctx.sizes = [t.shape[1] for t in inputs[2:2 + ctx.n]]
        ctx.shapes = [t.shape for t in inputs[2 + ctx.n:]]

    @staticmethod
    def backward(ctx, g):
        ends = [sum(ctx.sizes[:i]) for i in range(ctx.n + 1)]
        grads = [torch.empty(s, dtype=g.dtype, device=g.device)
                 if need else None for s, need in
                 zip(ctx.shapes, ctx.needs_input_grad[2 + ctx.n:])]
        return (None, None,
                *(g[:, ends[i]:ends[i + 1]] for i in range(ctx.n)), *grads)


def _scaled_loops(cost: _Cost, flops: FlopCounterMode, extra: List[int]):
    """``rwkv6.SCAN_HOOK`` and ``rwkv6.BLOCK_HOOK`` for the dry run: a
    loop's first two bodies run (trips, or checkpointed blocks of
    trips), and the second's cost stands for the other ``n - 2`` bodies'
    (a later body's state needs a gradient, the first's does not).

    - Forward: the body's flops and bytes, times ``n - 2``, go to
      ``extra`` and ``cost``; one allocation of the other bodies' outputs
      stands for them (the loop keeps every body's output to the end).
    - Under autograd: the storage the second body left alive (what a
      trip's graph keeps, its state saved by the next trip's; a block's
      checkpoint keeps its input state) is allocated ``n - 2`` times
      more, held by the output's graph node, so it lives as long as the
      real graph's would; and, outside a backward pass (a checkpoint's
      recompute runs inside one), the backward of one such body, run
      apart on detached copies of its operands, is costed and added
      ``n - 2`` times (the real backward runs the two bodies'), with,
      for trips, the adds that accumulate each trip's gradient of an
      operand (a block's gradients of its operand blocks are joined by
      the split's backward, which runs in full).  Nested loops nest the
      hook: a block's cost, its recomputation's and its backward's
      include its inner loops' scaled costs.  A train cell's bytes are
      an estimate (within 6% of the full loops' at 64 to 192 tokens);
      its flops and memory equal the full loops'.
    """
    #: a body's backward cost by its loop's shapes: the same body at the
    #: same shapes costs the same, so each is run apart once
    memo: Dict[Any, Any] = {}

    def cost_now():
        return flops.get_total_flops() + extra[0], cost.bytes

    def backward_cost(body, ins, level):
        """(flops, bytes) of one later body's backward, run apart (once
        for each ``level`` and shapes); the run's own cost and peak are
        taken back out."""
        key = (level, tuple((tuple(t.shape), t.dtype, t.requires_grad)
                            for t in ins))
        if key in memo:
            return memo[key]
        peak = cost.peak
        with torch.enable_grad(), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            ins = [t.detach().requires_grad_(i == 0 or t.requires_grad)
                   for i, t in enumerate(ins)]
            c0 = cost_now()
            y, st = body(*ins)
            c1 = cost_now()
            need = [t for t in ins if t.requires_grad]
            torch.autograd.grad((y, st), need, (torch.empty_like(y),
                                                torch.empty_like(st)),
                                allow_unused=True)
            c2 = cost_now()
        del y, st, ins, need
        extra[0] -= c2[0] - c0[0]
        cost.bytes -= c2[1] - c0[1]
        cost.peak = peak
        memo[key] = c2[0] - c1[0], c2[1] - c1[1]
        return memo[key]

    def scaled(body, n: int, state0: torch.Tensor, operands, skipped,
               token_dim: bool):
        """The loop of ``n`` bodies, ``body(i, state, *operands(i))`` the
        i-th; ``skipped``: the tensors that the bodies that do not run
        read; ``token_dim``: a body's y lacks the token axis (a
        trip's)."""
        def run(i, st):
            return body(i, st, *operands(i))

        if n < 3:
            ys, st = [], state0
            for i in range(n):
                y, st = run(i, st)
                ys.append(y)
            return (torch.stack(ys, dim=1) if token_dim
                    else torch.cat(ys, dim=1)), st
        calls = (repr(shd.COLLECTIVES), dict(ops.FAKE_LAUNCHES))
        y0, st0 = run(0, state0)
        c0, live0 = cost_now(), cost.cur
        y1, st = run(1, st0)
        del st0
        c1 = cost_now()
        kept = cost.cur - live0 - y1.untyped_storage().nbytes()
        if (repr(shd.COLLECTIVES), ops.FAKE_LAUNCHES) != calls:
            raise RuntimeError("a scaled loop body ran a collective or a "
                               "kernel: its count cannot be scaled")
        extra[0] += (n - 2) * (c1[0] - c0[0])
        cost.bytes += (n - 2) * (c1[1] - c0[1])
        grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (state0, *operands(1)))
        if grad and torch._C._current_graph_task_id() == -1:
            bf, bb = backward_cost(lambda *ins: body(1, *ins),
                                   (st, *operands(1)), (token_dim, n))
            extra[0] += (n - 2) * bf
            if token_dim:
                # autograd adds each trip's gradient of an operand into
                # its buffer (two reads, a write): n - 1 adds, of which
                # the two trips and the stand-in's gradient make two
                added = 3 * sum(_nbytes(t) for t in operands(1)
                                if t.requires_grad)
                bb += added
                cost.bytes -= added
            cost.bytes += (n - 2) * bb
        if token_dim:
            y0, y1 = y0[:, None], y1[:, None]
        out = _Standin.apply(n, 2, y0, y1, *skipped)
        if grad and kept > 0:
            out.grad_fn.metadata["saved"] = y0.new_empty(
                ((n - 2) * kept,), dtype=torch.uint8)
        return out, st

    def scan(trip, S: int, state0: torch.Tensor, operands):
        return scaled(trip, S, state0, lambda t: operands, operands, True)

    def blocks(body, state0: torch.Tensor, parts):
        return scaled(lambda i, st, *block: body(st, *block), len(parts),
                      state0, lambda i: parts[i],
                      [t for part in parts[2:] for t in part], False)
    return scan, blocks


def _trace(fn, args, scale_scan: bool = False) -> Dict[str, Any]:
    """Run ``fn(*args)`` (fake arguments) under the cost modes;
    ``scale_scan`` runs rwkv6's ``wkv_scan`` loops as
    :func:`_scaled_loops` does."""
    arg_tensors = _tensors(args)
    storages = [t.untyped_storage() for t in arg_tensors]
    cost = _Cost(storages)
    flops = FlopCounterMode(display=False)
    extra = [0]
    shd.reset_collectives()
    ops.reset_fake()
    old_hooks = rwkv6.SCAN_HOOK, rwkv6.BLOCK_HOOK
    if scale_scan:
        rwkv6.SCAN_HOOK, rwkv6.BLOCK_HOOK = _scaled_loops(cost, flops, extra)
    try:
        with flops, cost:
            out = fn(*args)
    finally:
        rwkv6.SCAN_HOOK, rwkv6.BLOCK_HOOK = old_hooks
    outs, seen, alias, new_out = _tensors(out), set(), 0, 0
    arg_ids = {id(s) for s in storages}
    for t in outs:
        s = t.untyped_storage()
        if id(s) in arg_ids:
            alias += _nbytes(t)
        elif id(s) not in seen:
            seen.add(id(s))
            new_out += s.nbytes()
    kern_flops = sum(c[0] for c in ops.FAKE_COST.values())
    kern_bytes = sum(c[1] for c in ops.FAKE_COST.values())
    mem = {"argument_bytes": argument_bytes(args),
           "output_bytes": sum(_nbytes(t) for t in outs),
           "temp_bytes": max(cost.peak - new_out, 0),
           "generated_code_bytes": None,
           "alias_bytes": alias}
    mem["total_per_device_bytes"] = (
        mem["argument_bytes"] + mem["output_bytes"] + mem["temp_bytes"]
        - mem["alias_bytes"])
    rec = {"memory": mem,
           "cost": {"flops": float(flops.get_total_flops() + extra[0]
                                    + kern_flops),
                    "bytes accessed": float(cost.bytes + kern_bytes),
                    "transcendentals": None},
           "collectives": _collectives(),
           "kernels": {k: v for k, v in ops.FAKE_LAUNCHES.items() if v}}
    return rec


def argument_bytes(args) -> int:
    """Rank 0's local bytes of program arguments (DTensors' blocks):
    ``build_program``'s placed meta examples need no trace."""
    return sum(_nbytes(t) for t in _tensors(args))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rule_overrides=None, microbatches: int = 1,
             mesh_shape: Optional[Sequence[int]] = None,
             shape: Optional[ShapeConfig] = None, *,
             cfg: Optional[ModelConfig] = None,
             scale_loops: bool = True) -> dict:
    """The dry run of one cell: ``arch`` at ``shape`` (default
    ``SHAPES[shape_name]``) on the production mesh (or ``mesh_shape``),
    ``cfg`` in place of the arch's config (a reduced one, say);
    ``scale_loops=False`` runs every trip of rwkv6's loop (the reference
    the scaled loop is held to)."""
    cfg = cfg or configs.get_config(arch)
    shape = shape or SHAPES[shape_name]
    head = {"arch": arch, "shape": shape_name,
            "mesh": "multi" if multi_pod else "single"}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return dict(head, status="skip", reason=why)
    mc = mesh_config(multi_pod, mesh_shape)
    with fake_world(mc.num_devices):
        fn, args, _ = build_program(cfg, shape,
                                    fake_mesh(multi_pod, mesh_shape),
                                    rule_overrides=rule_overrides,
                                    microbatches=microbatches)
        out = dict(head, status="ok", devices=mc.num_devices,
                   no_counterpart=list(NO_COUNTERPART),
                   fake_device=str(fake_device()))
        if mesh_shape is not None:
            out["mesh_shape"] = list(mc.shape)
        mode = FakeTensorMode()
        fargs = tuple(_to_fake(mode, a) for a in args)
        scaled = (scale_loops and cfg.family == "ssm"
                  and shape.kind != "decode")
        with mode:
            out.update(_trace(fn, fargs, scale_scan=scaled))
        out["hlo_scaled"] = None
        if scaled:
            out["loop_scaled"] = {"loop": "models.rwkv6.wkv_scan",
                                  "trips": shape.seq_len}
    return out


def record_line(tag: str, rec: dict) -> str:
    """The reference's console line for one record."""
    if rec["status"] != "ok":
        return (f"[dryrun] {tag}: {rec['status']} "
                f"({rec.get('reason', rec.get('error', ''))[:120]})")
    mem = rec.get("memory", {}).get("total_per_device_bytes", 0)
    return (f"[dryrun] {tag}: ok mem/device={mem / 2**30:.2f}GiB"
            f" flops={rec.get('cost', {}).get('flops', 0):.3g}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="all")
    p.add_argument("--shape", default="all")
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--out", default=None, help="directory for JSON records")
    p.add_argument("--microbatches", type=int, default=1)
    p.add_argument("--dump-hlo", default=None,
                   help="refused: the port compiles no HLO")
    p.add_argument("--skip-existing", action="store_true")
    args = p.parse_args(argv)
    if args.dump_hlo is not None:
        p.error("--dump-hlo has no counterpart: the port runs its program "
                "eagerly under fake tensors and compiles no HLO to dump")

    archs = configs.ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    world = max(mesh_config(m).num_devices for m in meshes)
    with fake_world(world):
        for arch in archs:
            for shape in shapes:
                for multi in meshes:
                    name = "multi" if multi else "single"
                    tag = f"{arch}|{shape}|{name}"
                    fn = f"{arch.replace('.', '_')}__{shape}__{name}.json"
                    path = os.path.join(args.out, fn) if args.out else None
                    if args.skip_existing and path and os.path.exists(path):
                        with open(path) as f:
                            old = json.load(f)
                        if old.get("status") in ("ok", "skip"):
                            print(f"[dryrun] {tag}: cached "
                                  f"({old['status']})")
                            continue
                    try:
                        rec = run_cell(arch, shape, multi,
                                       microbatches=args.microbatches)
                    except Exception as e:
                        rec = {"arch": arch, "shape": shape, "mesh": name,
                               "status": "error", "error": str(e),
                               "trace": traceback.format_exc()[-2000:]}
                        failures += 1
                    print(record_line(tag, rec), flush=True)
                    if path:
                        os.makedirs(args.out, exist_ok=True)
                        with open(path, "w") as f:
                            json.dump(rec, f, indent=1)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
