"""Checkpointing: atomic save and restore, in the reference's format
(the counterpart of ``repro.train.checkpoint``).

Format: one ``.npz`` with the flattened leaves, keys ``p/<path>`` for the
parameters and ``o/<path>`` for the optimizer state (``<path>`` the dict
keys joined by ``/``; a None subtree has no key), bf16 stored as fp32;
and a msgpack sidecar ``latest`` ({"step", "file"}).  Saves are atomic
(tmp + rename), and ``latest`` names the newest complete checkpoint, so
a crash mid-save never corrupts the restore state.  A checkpoint that
either package wrote restores in the other.

On a mesh the leaves are DTensors: ``save`` makes each leaf whole on
every rank of its mesh (``sharding.full``, a collective, so every rank
calls ``save``), rank 0 alone writes the files, and a barrier follows;
a DTensor template restores as that rank's block in the template's
placements.  ``restore_resharded`` places the parameters with the
placements of another mesh: the elastic-scaling path (restore a
checkpoint of one mesh onto a smaller one).
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import msgpack
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as shd
from repro_torch.models.params import tree_leaves, tree_map


def _flatten(tree, path=(), flat=None) -> dict:
    flat = {} if flat is None else flat
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), flat)
    elif tree is not None:
        t = shd.full(tree).detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()               # npz-safe; restore casts back
        flat["/".join(path)] = t.numpy()
    return flat


def _unflatten_into(template, flat: dict, path=(), device=None):
    """A tree shaped as ``template`` from ``flat``, each leaf in its
    template leaf's dtype and on its device (``device`` for a meta
    template leaf); a DTensor template leaf gives this rank's block in
    its placements."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, path + (str(k),), device)
                for k, v in template.items()}
    if template is None:
        return None
    arr = flat["/".join(path)]
    dev = shd.local_tensor(template).device
    if dev.type == "meta":
        dev = device
    t = torch.from_numpy(np.array(arr)).to(device=dev, dtype=template.dtype)
    if isinstance(template, DTensor):
        return shd.place_with(t, template.placements, template.device_mesh)
    return t


def _mesh_of(*trees):
    """The DeviceMesh of the trees' DTensor leaves (None without one)."""
    return next((x.device_mesh for t in trees for x in tree_leaves(t)
                 if isinstance(x, DTensor)), None)


def _barrier(mesh) -> None:
    """Every rank of ``mesh`` past this point: a barrier on each mesh
    dim's groups in turn (transitively the whole mesh)."""
    for i in range(mesh.ndim):
        dist.barrier(group=mesh.get_group(i))


def save(ckpt_dir: str, params, opt_state, step: int) -> Optional[str]:
    """Write the trees at ``step``; returns the file's path.  On a mesh
    every rank of it calls this: each leaf is gathered whole, the rank
    at the mesh's origin writes (the others return None) and a barrier
    follows, so the files are complete on every rank's return."""
    mesh = _mesh_of(params, opt_state)
    flat = {f"p/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"o/{k}": v for k, v in _flatten(opt_state).items()})
    final = None
    if mesh is None or not any(mesh.get_coordinate()):
        final = _write(ckpt_dir, flat, step)
    if mesh is not None:
        _barrier(mesh)
    return final


def _write(ckpt_dir: str, flat: dict, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"ckpt_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp.npz")
    final = os.path.join(ckpt_dir, name + ".npz")
    np.savez(tmp, **flat)
    os.rename(tmp, final)
    meta = {"step": step, "file": name + ".npz"}
    mtmp = os.path.join(ckpt_dir, "latest.tmp")
    with open(mtmp, "wb") as f:
        f.write(msgpack.packb(meta))
    os.rename(mtmp, os.path.join(ckpt_dir, "latest"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    try:
        with open(os.path.join(ckpt_dir, "latest"), "rb") as f:
            return msgpack.unpackb(f.read())["step"]
    except FileNotFoundError:
        return None


def try_restore(ckpt_dir: str, params_tpl, opt_tpl, device=None
                ) -> Optional[Tuple[Any, Any, int]]:
    """(params, opt_state, step) of the latest checkpoint, shaped, typed
    and placed as the templates (on ``device`` for meta templates); None
    when there is none."""
    meta_path = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path, "rb") as f:
        meta = msgpack.unpackb(f.read())
    with np.load(os.path.join(ckpt_dir, meta["file"])) as data:
        flat = {k: data[k] for k in data.files}
    params = _unflatten_into(
        params_tpl, {k[2:]: v for k, v in flat.items() if k.startswith("p/")},
        device=device)
    opt = _unflatten_into(
        opt_tpl, {k[2:]: v for k, v in flat.items() if k.startswith("o/")},
        device=device)
    return params, opt, int(meta["step"])


def restore_resharded(ckpt_dir: str, params_tpl, opt_tpl, shardings=None,
                      device=None):
    """Elastic restore: the latest checkpoint with each parameter placed
    by ``shardings`` (a tree of placements on the active DeviceMesh, as
    ``sharding.tree_shardings`` gives; a None leaf keeps the restored
    leaf), the state as its template.  None when there is none."""
    out = try_restore(ckpt_dir, params_tpl, opt_tpl, device=device)
    if out is None:
        return None
    params, opt, step = out
    if shardings is not None:
        mesh = shd.device_mesh()
        params = tree_map(
            lambda x, pl: x if pl is None else shd.place_with(
                shd.full(x), pl, mesh), params, shardings)
    return params, opt, step
