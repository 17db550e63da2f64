"""Checkpointing: atomic save and restore, in the reference's format
(the counterpart of ``repro.train.checkpoint``).

Format: one ``.npz`` with the flattened leaves, keys ``p/<path>`` for the
parameters and ``o/<path>`` for the optimizer state (``<path>`` the dict
keys joined by ``/``; a None subtree has no key), bf16 stored as fp32;
and a msgpack sidecar ``latest`` ({"step", "file"}).  Saves are atomic
(tmp + rename), and ``latest`` names the newest complete checkpoint, so
a crash mid-save never corrupts the restore state.  A checkpoint that
either package wrote restores in the other.

``restore_resharded`` (a restore onto another mesh) waits for the
training half of the mesh (ROADMAP Queue 1 item 8b).
"""
from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import msgpack
import numpy as np
import torch


def _flatten(tree, path=(), flat=None) -> dict:
    flat = {} if flat is None else flat
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], path + (str(k),), flat)
    elif tree is not None:
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()               # npz-safe; restore casts back
        flat["/".join(path)] = t.numpy()
    return flat


def _unflatten_into(template, flat: dict, path=()):
    """A tree shaped as ``template`` from ``flat``, each leaf in its
    template leaf's dtype and on its device."""
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, path + (str(k),))
                for k, v in template.items()}
    if template is None:
        return None
    arr = flat["/".join(path)]
    return torch.from_numpy(np.array(arr)).to(device=template.device,
                                              dtype=template.dtype)


def save(ckpt_dir: str, params, opt_state, step: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"ckpt_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp.npz")
    final = os.path.join(ckpt_dir, name + ".npz")
    flat = {f"p/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"o/{k}": v for k, v in _flatten(opt_state).items()})
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


def try_restore(ckpt_dir: str, params_tpl, opt_tpl
                ) -> Optional[Tuple[Any, Any, int]]:
    """(params, opt_state, step) of the latest checkpoint, shaped, typed
    and placed as the templates; None when there is none."""
    meta_path = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(meta_path):
        return None
    with open(meta_path, "rb") as f:
        meta = msgpack.unpackb(f.read())
    with np.load(os.path.join(ckpt_dir, meta["file"])) as data:
        flat = {k: data[k] for k in data.files}
    params = _unflatten_into(
        params_tpl, {k[2:]: v for k, v in flat.items() if k.startswith("p/")})
    opt = _unflatten_into(
        opt_tpl, {k[2:]: v for k, v in flat.items() if k.startswith("o/")})
    return params, opt, int(meta["step"])
