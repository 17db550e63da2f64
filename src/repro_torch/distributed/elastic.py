"""Elastic scaling: re-shard a running job onto a different mesh.

The counterpart of ``repro.distributed.elastic``.  Node failures shrink
the healthy device set; DisaggRec's failure handling (§IV-A) maps at
training and serving time to: checkpoint -> rebuild the mesh from the
survivors -> restore with the new mesh's shardings (``elastic_restore``)
or place the live parameters there (``reshard_tree``) -> train or serve
again.  Here a device is a process of the ``torch.distributed`` world (a
rank), and a shrunken mesh is a ``DeviceMesh`` over a subgroup of the
survivors' ranks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
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
    this).  A None subtree (an optimizer's absent ``err``) stays None.
    Returns None on a rank outside ``mesh``."""
    tree = tree_map(lambda x: shd.full(x) if isinstance(x, DTensor)
                    and x.device_mesh != mesh else x, tree)
    if mesh.get_coordinate() is None:
        return None
    with shd.use_mesh(mesh, rules):
        return tree_map(lambda x, names: None if x is None
                        else shd.place(x, names), tree, spec_tree)


def elastic_restore(ckpt_dir: str, model, opt_cfg, mesh: DeviceMesh,
                    rules=None):
    """The latest checkpoint in ``ckpt_dir`` restored onto ``mesh``:
    (params, opt_state, step) with the parameters placed under the
    model's ``param_specs`` and the state under ``optimizer.state_specs``
    (ZeRO-1 on the new mesh's ``data`` axis), each rank keeping its
    blocks.  None when there is no checkpoint, and on a rank outside
    ``mesh`` (every rank of the world calls ``healthy_mesh``, only the
    mesh's ranks this)."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt_mod

    if mesh.get_coordinate() is None:
        return None
    dev = _mesh_device(mesh)
    params_tpl = model.param_shapes()
    params_tpl = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                                device="meta"), params_tpl)
    opt_tpl = opt_mod.init_state(opt_cfg, params_tpl)
    out = ckpt.try_restore(ckpt_dir, params_tpl, opt_tpl, device=dev)
    if out is None:
        return None
    params, opt_state, step = out
    with shd.use_mesh(mesh, rules):
        pspecs = model.param_specs()
        sspecs = opt_mod.state_specs(opt_cfg, pspecs, model.param_shapes())
    params = reshard_tree(params, pspecs, mesh, rules)
    opt_state = reshard_tree(opt_state, sspecs, mesh, rules)
    return params, opt_state, step


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
