"""Single-unit serving engine: batched request execution with the
paper's sequential (lock-step) semantics, in PyTorch on the device.

The counterpart of ``repro.serving.engine``: the request and result
records; ``DLRMServingEngine``, which packs requests into fixed-size
batches (-1 padded), splits an oversized request across batches, and
scores each batch in one step (on a mesh: every rank packs the same
batches, scores its block under ``use_mesh`` and gathers the scores);
and ``LMServingEngine``, greedy
prefill + decode generation for the LM archs (decoder LMs and
whisper).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, require_on, resolve_device
from repro_torch.distributed import sharding as shd


@dataclass
class Request:
    rid: int
    payload: Dict[str, np.ndarray]      # per-sample model inputs
    size: int
    arrival: float
    # owning model index under fleet serving (0 for single-model streams)
    model: int = 0


@dataclass
class Result:
    rid: int
    outputs: np.ndarray
    latency: float


class DLRMServingEngine:
    """Batched CTR scoring over a (possibly sharded) DLRM on ``device``
    (default: the CUDA card); ``params`` must already lie there.  With a
    ``mesh`` (a DeviceMesh; ``rules`` from ``registry.make_rules``) every
    rank of it serves the same requests: the params are replicated plain
    tensors or DTensors (``elastic.reshard_tree``)."""

    def __init__(self, model, params, batch_size: int = 128,
                 use_kernel: bool = False, device: DeviceLike = None,
                 mesh=None, rules=None):
        self.device = resolve_device(device)
        require_on(shd.local_tensor(params["embed"]), self.device)
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.use_kernel = use_kernel
        self.mesh = mesh
        self.rules = rules

    def _pad_concat(self, reqs: List[Request]) -> Dict[str, torch.Tensor]:
        dense = np.concatenate([r.payload["dense"] for r in reqs])
        idx = np.concatenate([r.payload["indices"] for r in reqs])
        pad = self.batch_size - dense.shape[0]
        if pad > 0:
            dense = np.concatenate([dense, np.zeros_like(dense[:1]).repeat(pad, 0)])
            idx = np.concatenate([idx, -np.ones_like(idx[:1]).repeat(pad, 0)])
        return {"dense": torch.from_numpy(dense).to(self.device),
                "indices": torch.from_numpy(idx).to(self.device)}

    def _step(self, batch: Dict[str, torch.Tensor]) -> np.ndarray:
        if self.mesh is None:
            scores = self.model.serve_step(self.params, batch,
                                           use_kernel=self.use_kernel)
        else:
            with shd.use_mesh(self.mesh, self.rules):
                scores = shd.full(self.model.serve_step(
                    self.params, batch, use_kernel=self.use_kernel))
        return scores.cpu().numpy()

    def serve(self, requests: List[Request]) -> List[Result]:
        """Sequential query processing: requests are executed in complete
        batches, in arrival order; one query's lookups never interleave
        with another's inside the step."""
        out: List[Result] = []
        i = 0
        while i < len(requests):
            group: List[Request] = []
            n = 0
            while i < len(requests) and n + requests[i].size <= self.batch_size:
                group.append(requests[i])
                n += requests[i].size
                i += 1
            if not group:           # oversized request: split
                r = requests[i]
                i += 1
                scores = []
                for s0 in range(0, r.size, self.batch_size):
                    chunk = {k: v[s0:s0 + self.batch_size]
                             for k, v in r.payload.items()}
                    sub = Request(r.rid, chunk,
                                  min(self.batch_size, r.size - s0),
                                  r.arrival)
                    batch = self._pad_concat([sub])
                    scores.append(self._step(batch)[:sub.size])
                out.append(Result(r.rid, np.concatenate(scores), 0.0))
                continue
            batch = self._pad_concat(group)
            scores = self._step(batch)
            o = 0
            for r in group:
                out.append(Result(r.rid, scores[o:o + r.size], 0.0))
                o += r.size
        return out


class LMServingEngine:
    """Prefill + decode serving for the LM archs (greedy sampling) on
    ``device`` (default: the CUDA card); ``params`` must already lie
    there."""

    def __init__(self, model, params, cache_len: int = 256,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        require_on(params["embed"], self.device)
        self.model = model
        self.params = params
        self.cache_len = cache_len

    @torch.no_grad()
    def generate(self, tokens: np.ndarray, steps: int = 16,
                 extra: Optional[Dict[str, Any]] = None) -> np.ndarray:
        """Greedy generation: ``argmax`` over the last logits after the
        prefill and after each of ``steps`` decode calls -> (B, steps)
        int32 tokens.  Each step reads back only its sampled token.
        ``extra`` holds the prefill's other inputs (a VLM's ``images``,
        whisper's ``frames``), numpy arrays or tensors, which go to the
        device in their own dtype.  Runs under ``torch.no_grad``, so
        parameters that a train step marked ``requires_grad`` serve
        through the kernels too."""
        batch = {"tokens": torch.from_numpy(
            np.asarray(tokens, np.int32)).to(self.device)}
        if extra:
            batch.update({k: torch.as_tensor(v, device=self.device)
                          for k, v in extra.items()})
        logits, cache = self.model.prefill(self.params, batch,
                                           cache_len=self.cache_len)
        out = []
        tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        for _ in range(steps):
            out.append(tok.cpu().numpy())
            logits, cache = self.model.decode_step(self.params, cache,
                                                   {"tokens": tok})
            tok = logits[:, -1].argmax(dim=-1)[:, None].to(torch.int32)
        return np.concatenate(out, axis=1)
