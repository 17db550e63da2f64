"""Single-unit serving engine: batched request execution with the
paper's sequential (lock-step) semantics, in PyTorch on the device.

The counterpart of the DLRM half of ``repro.serving.engine``: the
request and result records, and ``DLRMServingEngine``, which packs
requests into fixed-size batches (-1 padded), splits an oversized
request across batches, and scores each batch in one step.  The LM
engine arrives with the LM zoo.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch.device import DeviceLike, require_on, resolve_device


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
    """Batched CTR scoring over a DLRM on ``device`` (default: the CUDA
    card); ``params`` must already lie there."""

    def __init__(self, model, params, batch_size: int = 128,
                 use_kernel: bool = False, device: DeviceLike = None):
        self.device = resolve_device(device)
        require_on(params["embed"], self.device)
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self.use_kernel = use_kernel

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
        scores = self.model.serve_step(self.params, batch,
                                       use_kernel=self.use_kernel)
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
