"""Mesh construction over the ``torch.distributed`` world.

The counterpart of ``repro.launch.mesh``: a function, not a module-level
constant, so importing this module touches no process group.  A
"device" of the mesh is a rank of the world; the caller has initialised
the process group (``torch.distributed.init_process_group``) and, on the
card, picked each rank's device.

``make_production_mesh`` (16 x 16, or 2 x 16 x 16 over pods) waits for
the dry-run, which needs a fake process group of 256 or 512 ranks
(ROADMAP Queue 1 item 8d).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import DeviceLike, resolve_device


def make_host_mesh(model: int = 1, device: DeviceLike = None) -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the world, ``model``
    of them on the model axis (capped at the world size), on ``device``'s
    type (default: the CUDA card)."""
    kind = resolve_device(device).type
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(kind, (n // model, model),
                            mesh_dim_names=("data", "model"))
