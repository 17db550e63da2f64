"""Logical-axis sharding rules (MaxText-style) mapping model-space axis
names to the axes of a ``torch.distributed`` ``DeviceMesh``.

The counterpart of ``repro.distributed.sharding``.  The DisaggRec mapping
lives here: the ``model`` mesh axis is the "memory node pool" (embedding
tables, experts, KV-cache sequence shards), the ``data`` (+``pod``) axes
are the "compute node pool" (batch replicas).

Placement is DTensor, torch's counterpart of GSPMD's annotations.  A
logical spec resolves under the active rules to one entry per tensor dim
(:func:`resolve`: None, a mesh axis, or a tuple of them, equal to the
reference's ``PartitionSpec`` entries), and those to one placement per
mesh dim (:func:`make_sharding`: ``Shard(d)`` or ``Replicate()``).
Parameters, caches and inputs are placed with :func:`place` (each rank
keeping a copy of its own block, as ``distribute_tensor`` without a
source rank does).

There is no GSPMD to partition the math, so the models' mesh branches
are local code: each rank computes on its blocks and combines them with
explicit collectives over a mesh axis (:func:`psum`, :func:`pmax`,
:func:`all_gather`), as the reference's ``shard_map`` bodies do with
``jax.lax.psum``.  The conventions:

- a plain tensor is a whole, replicated value; a DTensor carries its
  placement.  :func:`lsc` redistributes a DTensor and returns a plain
  tensor unchanged, so with no mesh every path is bitwise what it was;
- :func:`local` is the block of a tensor that this rank computes on
  under a spec: a DTensor redistributed to it and its local tensor, or a
  plain tensor's block (a view, no traffic);
- shards are even: a spec resolves for the tensor's shape
  (:func:`resolve_for_shape`), dropping the mesh axes a dim cannot
  divide, where GSPMD would pad an uneven shard.

A shape dict (``{"data": 16, "model": 16}``) stands for a mesh in rule
resolution (``use_mesh``, ``resolve``, ``registry.make_rules``), for
meshes that no process group has; placing and collectives need a
``DeviceMesh``.

Collectives.  Ranks that share one card take gloo (NCCL refuses two
ranks on one device).  gloo in torch 2.11 runs every c10d collective on
CUDA tensors, all-gather and reduce-scatter included, staging them
through host memory (``tools/gloo_probe.py`` on the H100), but DTensor's
own ``redistribute`` and ``full_tensor``, which go through the functional
collectives, crash there (a segfault in ``wait_tensor``; the probe's
``--funcol`` run).  So every move here takes one route, chosen for
every backend alike: c10d collectives on the mesh axis's group
(:func:`redistribute` un-shards with ``all_gather`` and shards with a
local slice; :func:`psum` and :func:`pmax` are ``all_reduce``), never a
functional collective.  Reductions of bf16/fp16 run in fp32 and round
once: an all-reduce in bf16 would round at each hop, in an order the
backend picks.

Gradients.  When grad mode is on and the input requires grad, each
collective is an autograd function whose backward is its linear
transpose, as JAX defines it for a ``shard_map`` body with
``check_rep=False``: :func:`psum` -> a psum of the cotangent over the
same axes; :func:`all_gather` (and the gathers of :func:`redistribute`,
so of :func:`lsc`, :func:`local`, :func:`full` and :func:`place`) -> a
reduce-scatter (a psum, then this rank's block); taking a block (a
``narrow``) -> zero-padding into the whole, by autograd itself.
:func:`pmax` has no gradient.  Seen as one function of every rank's
tensors these are the exact vector-Jacobian products, so a loss that
every rank computes alike, differentiated as ``loss / world`` on each
rank, gives each rank's copy of a leaf its share of the gradient, and a
psum over the ranks holding copies gives the whole
(``train.train_loop.value_and_grad_mesh``).  The backward runs the same
c10d calls as the forward.  With grad mode off the collectives are the
plain calls, no autograd function in between.

Tally.  Every c10d call of the port (``_reduce`` and ``_gather``, which
``core.sharding.disagg_embedding_lookup`` calls too) adds one call
and its moved bytes to ``COLLECTIVES`` by kind and mesh axis
(:func:`count_collective`), the counterpart of the reference's
collective bytes parsed from its HLO; ``reset_collectives`` zeroes it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import (Dict, List, Mapping, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from repro_torch.models.params import tree_map

MeshLike = Union[DeviceMesh, Mapping[str, int], None]
Entry = Union[None, str, Tuple[str, ...]]

# Logical axis -> mesh axis (or tuple of mesh axes, or None=replicated).
# Axes absent from the active mesh are dropped at resolution time, so one
# rule set serves both the single-pod and multi-pod meshes.
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "ffn": ("model",),
    "vocab": ("model",),
    "experts": ("model",),       # expert parallelism (MN pool)
    "expert_ffn": None,
    "table_shard": ("model",),   # DLRM embedding-table shards (MN pool)
    "kv_seq": ("model",),        # sequence-sharded KV cache at decode
    "layers": None,
    "conv": None,
    "ssm_state": None,
    "opt_shard": ("data",),      # ZeRO-1 optimizer-state sharding
    "qlen": None,
    # Megatron-SP: the residual stream between blocks is sequence-sharded
    # over `model`; blocks gather/reduce-scatter at their boundaries
    "seq_sp": None,
    "mamba_heads": None,
    "table_rows": None,
    # rwkv square (d,d) projections: output dim never shards (the input
    # dim carries attn_din's mode-dependent sharding)
    "rwkv_out": None,
    "rwkv_out_c": None,
    # KV-cache head dim: never sharded (kv_seq carries the model axis)
    "cache_heads": None,
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh: MeshLike = None
        self.rules: Dict[str, Optional[Tuple[str, ...]]] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh: MeshLike, rules: Optional[Dict] = None):
    """Activate a mesh (or a shape dict) + logical rules."""
    old_mesh, old_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    if rules is not None:
        merged = dict(DEFAULT_RULES)
        merged.update(rules)
        _CTX.rules = merged
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old_mesh, old_rules


def bind_mesh(fn):
    """``fn`` run under the mesh and rules active here, wherever it is
    called from.  The context is thread-local, and a checkpointed
    function recomputes in the backward, which on the card runs on
    autograd's device thread, where no mesh is active."""
    mesh, rules = _CTX.mesh, _CTX.rules

    def run(*args, **kwargs):
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)
    return run


def current_mesh() -> MeshLike:
    return _CTX.mesh


def mesh_shape(mesh: MeshLike) -> Dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or a shape dict ({} for
    None): the counterpart of ``jax.sharding.Mesh.shape``."""
    if mesh is None:
        return {}
    if isinstance(mesh, DeviceMesh):
        return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}
    return dict(mesh)


def device_mesh() -> Optional[DeviceMesh]:
    """The active mesh when it is a ``DeviceMesh`` (None for a shape
    dict or no mesh): the mesh that places tensors."""
    m = _CTX.mesh
    return m if isinstance(m, DeviceMesh) else None


def axis_size(name: str) -> int:
    return mesh_shape(_CTX.mesh).get(name, 1)


def resolve(names: Sequence[Optional[str]]) -> Tuple[Entry, ...]:
    """Logical axis names -> one entry per dim under the active
    mesh+rules (the reference's ``PartitionSpec`` entries)."""
    mesh = _CTX.mesh
    shape = mesh_shape(mesh)
    out = []
    for n in names:
        target = None if n is None else _CTX.rules.get(n)
        if target is None:
            out.append(None)
            continue
        if isinstance(target, str):
            target = (target,)
        present = tuple(a for a in target if mesh is None or a in shape)
        out.append(present if len(present) > 1
                   else (present[0] if present else None))
    return tuple(out)


def resolve_for_shape(names: Sequence[Optional[str]],
                      shape) -> Tuple[Entry, ...]:
    """resolve(), but drop mesh axes a dimension cannot divide (e.g.
    global_batch=1 under a 16-way data axis)."""
    mesh = _CTX.mesh
    base = resolve(names)
    if mesh is None:
        return base
    sizes = mesh_shape(mesh)
    out = []
    for dim, entry in zip(shape, base + (None,) * (len(shape) - len(base))):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        keep, prod = [], 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(keep[0] if len(keep) == 1 else (tuple(keep) or None))
    return tuple(out)


def placements(spec: Sequence[Entry],
               mesh: DeviceMesh) -> Tuple[Placement, ...]:
    """Resolved entries -> one placement per mesh dim.  A dim sharded
    over several axes takes them in the mesh's order (the order DTensor
    nests its shards in)."""
    dims = mesh.mesh_dim_names
    out = [Replicate()] * len(dims)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [dims.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"dim {d} shards over {axes}, against the "
                             f"mesh's axis order {dims}")
        for p in pos:
            out[p] = Shard(d)
    return tuple(out)


def make_sharding(names: Sequence[Optional[str]],
                  shape=None) -> Optional[Tuple[Placement, ...]]:
    """The placements of ``names`` on the active ``DeviceMesh`` (None
    without one), resolved for ``shape`` when it is given."""
    mesh = device_mesh()
    if mesh is None:
        return None
    spec = resolve(names) if shape is None else resolve_for_shape(names, shape)
    return placements(spec, mesh)


def tree_shardings(spec_tree):
    """Map a tree of logical-name tuples to placements (or None)."""
    return tree_map(lambda names: make_sharding(names), spec_tree)


def tree_shardings_for_shapes(spec_tree, shape_tree):
    """Shape-aware tree_shardings: divisibility-filtered per leaf."""
    return tree_map(lambda names, s: make_sharding(tuple(names), s.shape),
                    spec_tree, shape_tree)


# ------------------------------------------------------------ collectives

#: collective kind -> mesh axis -> [calls, moved bytes a rank] since the
#: last :func:`reset_collectives`
COLLECTIVES: Dict[str, Dict[str, List[int]]] = {}


def reset_collectives() -> None:
    """Zero the tally of collectives (``COLLECTIVES``)."""
    COLLECTIVES.clear()


def moved_bytes(kind: str, result_bytes: int, group_size: int) -> int:
    """A rank's link bytes for one collective of ``result_bytes`` over a
    group of ``group_size`` ranks (ring algorithm), by the reference's
    convention (``benchmarks/roofline.py`` ``_moved_bytes``): an
    all-gather moves its per-rank payload (the result over the group),
    an all-reduce twice its payload (a reduce-scatter and an
    all-gather).  The port makes no other kind."""
    if kind == "all-gather":
        return result_bytes // group_size
    if kind == "all-reduce":
        return result_bytes * 2
    raise ValueError(f"no collective of kind {kind!r} in the port")


def count_collective(kind: str, axis: str, result_bytes: int,
                     group_size: int) -> None:
    """Add one ``kind`` collective over mesh ``axis`` to ``COLLECTIVES``."""
    row = COLLECTIVES.setdefault(kind, {}).setdefault(axis, [0, 0])
    row[0] += 1
    row[1] += moved_bytes(kind, result_bytes, group_size)


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _reduce(x: torch.Tensor, mesh: DeviceMesh, mesh_dim: int,
            op) -> torch.Tensor:
    y = x.float() if x.dtype in (torch.bfloat16, torch.float16) else x.clone()
    dist.all_reduce(y, op=op, group=mesh.get_group(mesh_dim))
    count_collective("all-reduce", mesh.mesh_dim_names[mesh_dim], _nbytes(y),
                     mesh.size(mesh_dim))
    return y.to(x.dtype)


def _gather(x: torch.Tensor, mesh: DeviceMesh, mesh_dim: int,
            dim: int) -> torch.Tensor:
    """The blocks of every rank along ``mesh_dim``, concatenated on
    ``dim`` in rank order."""
    n = mesh.size(mesh_dim)
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(mesh_dim))
    count_collective("all-gather", mesh.mesh_dim_names[mesh_dim],
                     _nbytes(x) * n, n)
    return torch.cat(parts, dim=dim)


def _psum_dims(x: torch.Tensor, mesh: DeviceMesh, dims) -> torch.Tensor:
    for i in dims:
        x = _reduce(x, mesh, i, dist.ReduceOp.SUM)
    return x


def _grad_needed(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _Psum(torch.autograd.Function):
    """psum whose backward is the psum of the cotangent over the same
    axes: the transpose JAX gives ``psum`` in a ``shard_map`` body."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        ctx.mesh, ctx.dims = mesh, dims
        return _psum_dims(x, mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return _psum_dims(g.contiguous(), ctx.mesh, ctx.dims), None, None


class _Gather(torch.autograd.Function):
    """all-gather on ``dim`` over one mesh dim, whose backward is the
    reduce-scatter: the cotangent psummed over that mesh dim, then this
    rank's block of it."""

    @staticmethod
    def forward(ctx, x, mesh, mesh_dim, dim):
        ctx.mesh, ctx.mesh_dim, ctx.dim = mesh, mesh_dim, dim
        ctx.size = x.shape[dim]
        return _gather(x, mesh, mesh_dim, dim)

    @staticmethod
    def backward(ctx, g):
        g = _psum_dims(g.contiguous(), ctx.mesh, [ctx.mesh_dim])
        i = ctx.mesh.get_local_rank(ctx.mesh_dim)
        return g.narrow(ctx.dim, i * ctx.size, ctx.size), None, None, None


def _gather_ad(x: torch.Tensor, mesh: DeviceMesh, mesh_dim: int,
               dim: int) -> torch.Tensor:
    """:func:`_gather`, differentiable when ``x`` requires grad."""
    if _grad_needed(x):
        return _Gather.apply(x, mesh, mesh_dim, dim)
    return _gather(x, mesh, mesh_dim, dim)


def _mesh_dims(entry: Entry):
    """The active DeviceMesh and its dims named by ``entry`` (a mesh
    axis, a tuple of them, or None for none)."""
    mesh = device_mesh()
    if mesh is None:
        raise RuntimeError("collectives need an active DeviceMesh")
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    return mesh, [mesh.mesh_dim_names.index(a) for a in axes]


def psum(x: torch.Tensor, entry: Entry) -> torch.Tensor:
    """Sum of every rank's ``x`` over the mesh axes of ``entry``: the
    counterpart of ``jax.lax.psum`` in a ``shard_map`` body.  Its
    gradient is the psum of the cotangent over the same axes."""
    mesh, dims = _mesh_dims(entry)
    if dims and _grad_needed(x):
        return _Psum.apply(x, mesh, dims)
    return _psum_dims(x, mesh, dims)


def pmax(x: torch.Tensor, entry: Entry) -> torch.Tensor:
    """Elementwise max of every rank's ``x`` over the mesh axes.  It has
    no gradient: it serves only as the shift of a softmax or a
    logsumexp, whose value does not depend on the shift, so the caller
    passes a detached ``x``; a grad-requiring ``x`` raises."""
    if _grad_needed(x):
        raise ValueError("pmax has no gradient: pass a detached tensor "
                         "(a softmax or logsumexp shift)")
    mesh, dims = _mesh_dims(entry)
    for i in dims:
        x = _reduce(x, mesh, i, dist.ReduceOp.MAX)
    return x


def all_gather(x: torch.Tensor, entry: Entry, dim: int) -> torch.Tensor:
    """The whole of a dim sharded over ``entry`` from every rank's block
    ``x``: the blocks concatenated on ``dim`` in the axes' rank order
    (the innermost axis first, as DTensor nests the shards).  Its
    gradient is the reduce-scatter of the cotangent."""
    mesh, dims = _mesh_dims(entry)
    for i in reversed(dims):
        x = _gather_ad(x, mesh, i, dim)
    return x


def entry_index(entry: Entry) -> Tuple[int, int]:
    """(this rank's block, number of blocks) of a dim sharded over
    ``entry`` ((0, 1) for None): the counterpart of
    ``jax.lax.axis_index`` over those axes."""
    mesh, dims = _mesh_dims(entry)
    i, n = 0, 1
    for d in dims:
        i = i * mesh.size(d) + mesh.get_local_rank(d)
        n *= mesh.size(d)
    return i, n


def spec(x, *names) -> Tuple[Entry, ...]:
    """``names`` resolved for ``x``'s (global) shape."""
    return resolve_for_shape(names, x.shape)


# ------------------------------------------------------------- placement


def block(x: torch.Tensor, pl: Sequence[Placement],
          mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a whole tensor under ``pl`` (a view)."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(i)
            step = x.shape[p.dim] // n
            x = x.narrow(p.dim, coord[i] * step, step)
    return x


def unbind0(x):
    """``x.unbind(0)`` of a tensor whose dim 0 is not sharded (a stacked
    layer axis): a DTensor's slices as DTensors on its mesh."""
    if not isinstance(x, DTensor):
        return x.unbind(0)
    if any(isinstance(p, Shard) and p.dim == 0 for p in x.placements):
        raise ValueError(f"unbind0: dim 0 is sharded ({x.placements})")
    pl = [Shard(p.dim - 1) if isinstance(p, Shard) else p
          for p in x.placements]
    shape = x.shape[1:]
    stride = torch.empty(shape, device="meta").stride()
    return tuple(DTensor.from_local(t, x.device_mesh, pl, shape=shape,
                                    stride=stride)
                 for t in x.to_local().unbind(0))


def redistribute(x: DTensor, pl: Sequence[Placement]) -> DTensor:
    """``x`` with placements ``pl`` on its mesh (``Shard`` and
    ``Replicate`` only), by c10d all-gathers and local slices."""
    mesh, cur, pl = x.device_mesh, list(x.placements), tuple(pl)
    if tuple(cur) == pl:
        return x
    if not all(isinstance(p, (Shard, Replicate)) for p in cur + list(pl)):
        raise ValueError(f"redistribute: {cur} -> {pl}: only Shard and "
                         f"Replicate placements")
    first = next(i for i, (a, b) in enumerate(zip(cur, pl)) if a != b)
    loc = x.to_local()
    # un-shard the mesh dims from the first change on, innermost first
    # (DTensor nests a later mesh dim's shards inside an earlier one's)
    for i in reversed(range(first, len(cur))):
        if isinstance(cur[i], Shard):
            loc = _gather_ad(loc, mesh, i, cur[i].dim)
    coord = mesh.get_coordinate()
    for i in range(first, len(pl)):
        if isinstance(pl[i], Shard):
            step = loc.shape[pl[i].dim] // mesh.size(i)
            loc = loc.narrow(pl[i].dim, coord[i] * step, step)
    return DTensor.from_local(loc.contiguous(), mesh, pl, shape=x.shape,
                              stride=x.stride())


def lsc(x, *names):
    """Logical sharding constraint: a DTensor redistributed to ``names``
    on the active mesh; any other value unchanged."""
    if device_mesh() is None or not isinstance(x, DTensor):
        return x
    return redistribute(x, make_sharding(names, x.shape))


def local(x, *names):
    """The block of ``x`` this rank computes on under ``names``: a
    DTensor's local tensor after :func:`lsc`, a plain (whole) tensor's
    block; ``x`` itself without a DeviceMesh."""
    mesh = device_mesh()
    if mesh is None:
        return x
    if isinstance(x, DTensor):
        return lsc(x, *names).to_local()
    return block(x, make_sharding(names, x.shape), mesh)


def local_tensor(x):
    """A DTensor's local tensor, or ``x``."""
    return x.to_local() if isinstance(x, DTensor) else x


def like(p, loc: torch.Tensor):
    """``loc`` as the local tensor of a DTensor placed as ``p``, or
    ``loc`` itself when ``p`` is a plain tensor."""
    if not isinstance(p, DTensor):
        return loc
    return DTensor.from_local(loc, p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride())


def full(x):
    """The whole value of a DTensor (gathered on its own mesh), or ``x``."""
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, [Replicate()] * x.device_mesh.ndim).to_local()


def place(x, names, mesh: Optional[DeviceMesh] = None) -> DTensor:
    """``x`` placed on ``mesh`` (default: the active one) under
    ``names``: a plain (whole) tensor as ``distribute_tensor(...,
    src_data_rank=None)`` places it, from this rank's own data with no
    traffic, each rank keeping a copy of its block and nothing more (no
    transient copy of the whole: a bank shared by CUDA IPC stays
    shared); a DTensor on that mesh redistributed."""
    mesh = mesh or device_mesh()
    with use_mesh(mesh, _CTX.rules):
        pl = make_sharding(tuple(names), x.shape)
    if isinstance(x, DTensor):
        return redistribute(x, pl)
    return place_with(x, pl, mesh)


def place_with(x: torch.Tensor, pl: Sequence[Placement],
               mesh: DeviceMesh) -> DTensor:
    """A plain (whole) tensor placed on ``mesh`` with placements ``pl``:
    a copy of this rank's block."""
    stride = torch.empty(x.shape, device="meta").stride()
    return DTensor.from_local(block(x, pl, mesh).clone(), mesh, tuple(pl),
                              shape=x.shape, stride=stride)


def place_local(loc: torch.Tensor, names, shape) -> DTensor:
    """A DTensor of global ``shape`` from this rank's block ``loc``
    under ``names`` on the active mesh."""
    mesh = device_mesh()
    pl = make_sharding(tuple(names), shape)
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(loc, mesh, pl, shape=torch.Size(shape),
                              stride=stride)


def place_local_tree(loc, names, whole):
    """:func:`place_local` over a tree: each leaf of ``loc`` (this
    rank's block) placed under the matching names of ``names`` at the
    global shape of the matching leaf of ``whole`` (a tensor, DTensor or
    meta tensor); a leaf already placed stays as it is."""
    return tree_map(lambda t, n, w: t if isinstance(t, DTensor)
                    else place_local(t, n, w.shape), loc, names, whole)


def placed_zeros(shape, names, dtype: torch.dtype, device) -> DTensor:
    """Zeros of global ``shape`` placed under ``names`` on the active
    mesh, made from this rank's block only."""
    mesh = device_mesh()
    pl = make_sharding(tuple(names), shape)
    blk = block(torch.empty(shape, device="meta"), pl, mesh).shape
    return place_local(torch.zeros(blk, dtype=dtype, device=device), names,
                       shape)


def placed_dims(x) -> Tuple[list, list]:
    """(the mesh dims a DTensor is sharded on, those it is replicated
    on); a plain tensor on the active mesh is replicated on every dim."""
    if isinstance(x, DTensor):
        pl = x.placements
    else:
        pl = [Replicate()] * device_mesh().ndim
    return ([i for i, p in enumerate(pl) if isinstance(p, Shard)],
            [i for i, p in enumerate(pl) if not isinstance(p, Shard)])


def dims_entry(mesh: DeviceMesh, dims) -> Entry:
    """The entry (axis names) of mesh ``dims``."""
    names = tuple(mesh.mesh_dim_names[i] for i in dims)
    return None if not names else (names[0] if len(names) == 1 else names)
