"""Elastic scaling: re-shard a running job onto a different mesh.

The counterpart of ``repro.distributed.elastic``.  Node failures shrink
the healthy device set; DisaggRec's failure handling (§IV-A) maps at
serving time to: rebuild the mesh from the survivors -> place the
parameters with the new mesh's shardings -> serve again.  Here a device
is a process of the ``torch.distributed`` world (a rank), and a shrunken
mesh is a ``DeviceMesh`` over a subgroup of the survivors' ranks.

``elastic_restore`` (a checkpoint restored onto the new mesh) waits for
the training half of the mesh (ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models.params import tree_map


def healthy_mesh(axes: Dict[str, int], failed_fraction: float = 0.0,
                 devices: Optional[Sequence[int]] = None,
                 device: DeviceLike = None) -> DeviceMesh:
    """Build the largest ("data", "model") mesh with the requested
    ``model`` size from the surviving ranks (``devices``, default the
    whole world, in order; the first ``1 - failed_fraction`` of them
    survive): failures cost data-parallel slices, never model shards.
    Every rank of the world calls it (the mesh's groups are made
    collectively); on a rank outside the mesh ``get_coordinate()`` is
    None.  ``device`` gives the mesh's device type (default: the CUDA
    card)."""
    kind = resolve_device(device).type
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    n_ok = int(len(ranks) * (1.0 - failed_fraction))
    model = axes.get("model", 1)
    data = max(1, n_ok // model)
    # shrink data-parallel dim to fit the survivors
    use = np.asarray(ranks[:data * model]).reshape(data, model)
    return DeviceMesh(kind, use.tolist(),
                      mesh_dim_names=("data", "model"))


def reshard_tree(tree, spec_tree, mesh: DeviceMesh, rules=None):
    """Every leaf placed on ``mesh`` under its logical names
    (``sharding.place``): a plain (whole) tensor by taking this rank's
    block, a DTensor on ``mesh`` redistributed, a DTensor on another
    mesh first made whole there (so every rank of that mesh calls
    this).  Returns None on a rank outside ``mesh``."""
    tree = tree_map(lambda x: shd.full(x) if isinstance(x, DTensor)
                    and x.device_mesh != mesh else x, tree)
    if mesh.get_coordinate() is None:
        return None
    with shd.use_mesh(mesh, rules):
        return tree_map(lambda x, names: shd.place(x, names), tree,
                        spec_tree)
