"""DisaggRec's communication pattern on ``torch.distributed`` (C1).

`disagg_embedding_lookup` is the production-path embedding op: tables are
table-sharded over the ``model`` axis of a ``DeviceMesh`` (shards = memory
nodes, laid out by the greedy allocator), every shard pools **locally**
(near-memory reduction — optionally through the stacked embedding-bag
kernel), and only the pooled Fsum crosses the interconnect via one
all-gather. The indices scatter is implicit: every rank of the model axis
holds its batch slice's whole index tensor (it is tiny: P*4 bytes per bag
vs P*D*4 gathered rows — the paper's core traffic argument).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from repro_torch.core import embedding_manager as em
from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.kernels.ref import embedding_bag_ref


def permutation_from_assignment(shards: List[List[int]], n_tables: int):
    """Flatten per-shard table lists into a permutation + inverse."""
    perm = [t for sh in shards for t in sh]
    if sorted(perm) != list(range(n_tables)):
        raise ValueError(f"not a permutation of {n_tables} tables: {shards}")
    inv = np.empty(n_tables, np.int32)
    for pos, t in enumerate(perm):
        inv[t] = pos
    return np.asarray(perm, np.int32), inv


def disagg_embedding_lookup(tables: torch.Tensor, idx: torch.Tensor,
                            mesh=None, axis: str = "model",
                            use_kernel: bool = False) -> torch.Tensor:
    """Pooled (B, T, D) embeddings of a table-sharded stack.

    Without a mesh (or with a mesh whose ``axis`` is absent or of size 1)
    this is the single-host path: tables (T, R, D) and idx (B, T, P)
    int32, -1 padded.  On a ``DeviceMesh`` every rank passes what the
    reference's per-shard function receives: its own table shard
    (T/n, R, D) and its batch slice of idx (B_loc, T, P); it pools its
    tables' columns and all-gathers the pooled shards over ``axis`` in
    rank order, returning (B_loc, T, D).
    """
    def pool(tbl, ix):
        if use_kernel:
            return ops.embedding_bag(tbl, ix)
        return embedding_bag_ref(tbl, ix)

    names = (mesh.mesh_dim_names or ()) if mesh is not None else ()
    if axis not in names or mesh.size(names.index(axis)) == 1:
        return pool(tables, idx)

    n_shards = mesh.size(names.index(axis))
    t_loc = tables.shape[0]
    if idx.shape[1] != t_loc * n_shards:
        raise ValueError(f"idx {tuple(idx.shape)} must index {n_shards} "
                         f"shards of {t_loc} tables")
    shard = mesh.get_local_rank(axis)
    ix_loc = idx[:, shard * t_loc:(shard + 1) * t_loc].contiguous()
    pooled = pool(tables, ix_loc)                     # (B_loc, T_loc, D)
    # Fsum all-gather: only pooled vectors cross the network
    return shd._gather(pooled, mesh, names.index(axis), dim=1)


def greedy_table_layout(model_cfg, m: int, n_tasks: int = 1,
                        heterogeneous_seed: Optional[int] = None):
    """Run the paper's greedy allocation+routing for a DLRM config and
    return (perm, inv_perm, alloc, routing) for `m` shards."""
    r = model_cfg.dlrm
    rng = np.random.RandomState(heterogeneous_seed or 0)
    tables = []
    for t in range(r.num_tables):
        rows = r.rows_per_table
        if heterogeneous_seed is not None:
            rows = int(r.rows_per_table * float(rng.lognormal(0.0, 0.5)))
        tables.append(em.TableInfo(t, rows, r.embed_dim,
                                   r.avg_pooling, 4))
    cap = sum(t.size_bytes for t in tables)
    caps = [cap // m + cap // (4 * m)] * m     # capacity for ~1.25 replicas
    alloc = em.allocate_greedy(tables, caps)
    routing = em.route_greedy(tables, alloc, n_tasks, m)
    shards = em.shard_assignment(alloc, routing, r.num_tables, m)
    # balance shard cardinality for the stacked-array layout (pad by moving
    # tables from over-full shards — routing stays balanced by bytes)
    want = r.num_tables // m
    overflow = []
    for sh in shards:
        while len(sh) > want:
            overflow.append(sh.pop())
    for sh in shards:
        while len(sh) < want:
            sh.append(overflow.pop())
    perm, inv = permutation_from_assignment(shards, r.num_tables)
    return perm, inv, alloc, routing
