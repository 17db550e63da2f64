"""Mesh construction over the ``torch.distributed`` world.

The counterpart of ``repro.launch.mesh``: functions, not module-level
constants, so importing this module touches no process group.  A
"device" of the mesh is a rank of the world; the caller has initialised
the process group (``torch.distributed.init_process_group``) and, on the
card, picked each rank's device.

``make_production_mesh`` builds the production meshes of
``configs.base`` (``SINGLE_POD``, ``MULTI_POD``) over a world of 256 or
512 ranks: a real one, or the fake process group of the dry run
(``launch.dryrun``).  ``init_device_mesh`` sets a rank's CUDA device only
when the backend is a real one and no device was picked yet (rank modulo
the cards of the host); the fake backend skips it, so building the mesh
needs no card.
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs.base import MULTI_POD, SINGLE_POD
from repro_torch.device import DeviceLike, resolve_device


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), on ``device``'s type (default: the CUDA card; the
    type only, so the fake world of the dry run needs no card)."""
    cfg = MULTI_POD if multi_pod else SINGLE_POD
    kind = "cuda" if device is None else resolve_device(device).type
    return init_device_mesh(kind, cfg.shape, mesh_dim_names=cfg.axes)


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the world, ``model``
    of them on the model axis (capped at the world size), on ``device``'s
    type (default: the CUDA card)."""
    kind = resolve_device(device).type
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))
