"""RWKV6 ("Finch"), the attention-free LM with data-dependent decay, in
PyTorch: the counterpart of ``repro.models.rwkv6``, for generation and
training.

Recurrence (per head, K=V=head_dim):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = r_t^T (diag(u) k_t v_t^T + S_{t-1})

The WKV scan.  The reference's ``wkv_chunked`` nests a scan over chunks
and one over sub-chunks around ``_wkv_scan``, only to bound autodiff
memory: its sums still run token by token, in ``_wkv_scan``'s order.  So
the port's serving path is one loop over the tokens (:func:`wkv_scan`),
built on ``_wkv_scan``'s step; the chunk size changes nothing.  It is
plain PyTorch on the device: the reference has no Pallas kernel here.
Decode carries the (S, prev-x) state, O(1) per token.

The parameter tree is the reference's (per-layer leaves stacked on a
leading ``(L, ...)`` axis), and the reference's scan over layers is a
Python loop.  Differences from the reference, each deliberate:

- ``time_mix``'s group norm takes the population variance, as
  ``jnp.var`` does: ``var(..., correction=0)`` (torch's default is the
  unbiased one).
- Mixed dtypes follow JAX's promotion (bf16 with fp32 gives fp32), as
  ``layers.matmul`` does.

A forward returns new state tensors and leaves the ones it was given as
they are; a decode step makes no host sync.

``loss`` (mean CE, unchunked as in the reference) checkpoints each layer
as ``cfg.remat`` says.  Under autograd each token of ``wkv_scan`` keeps
a few (B, H, K, K) fp32 tensors, about 2 MB a sequence at rwkv6-3b's
widths; the per-layer checkpoint keeps one layer's loop at a time, as
the reference's nested checkpointed scans bound theirs.
``cache_logical`` and the mesh branches wait for ROADMAP Queue 1 item
8c.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import params as pm
from repro_torch.models import transformer as tfm
from repro_torch.models.params import Spec

_LORA = 32

States = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def rwkv6_table(cfg: ModelConfig) -> dict:
    d, dff = cfg.d_model, cfg.d_ff
    return {
        "ln1": L.norm_table(d),
        "ln2": L.norm_table(d),
        "tm": {  # time mix
            "x_maa": Spec((d,), ("embed",), "zeros"),
            "maa": Spec((5, d), (None, "embed"), "zeros"),
            "maa_w1": Spec((d, 5 * _LORA), ("embed", None), "normal:0.02"),
            "maa_w2": Spec((5, _LORA, d), (None, None, "embed"),
                           "normal:0.02"),
            "decay": Spec((d,), ("embed",), "const:-6.0"),
            "decay_w1": Spec((d, _LORA), ("embed", None), "normal:0.02"),
            "decay_w2": Spec((_LORA, d), (None, "embed"), "normal:0.02"),
            "u": Spec((d,), ("embed",), "zeros"),
            "wr": Spec((d, d), ("attn_din", "rwkv_out")),
            "wk": Spec((d, d), ("attn_din", "rwkv_out")),
            "wv": Spec((d, d), ("attn_din", "rwkv_out")),
            "wg": Spec((d, d), ("attn_din", "rwkv_out")),
            "wo": Spec((d, d), ("attn_din", "rwkv_out")),
            "ln_x_w": Spec((d,), ("embed",), "zeros"),
            "ln_x_b": Spec((d,), ("embed",), "zeros"),
        },
        "cm": {  # channel mix
            "k_maa": Spec((d,), ("embed",), "zeros"),
            "r_maa": Spec((d,), ("embed",), "zeros"),
            "wk": Spec((d, dff), ("embed", "ffn")),
            "wv": Spec((dff, d), ("ffn", "embed")),
            "wr": Spec((d, d), ("attn_din", "rwkv_out")),
        },
    }


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, state0: torch.Tensor):
    """Sequential WKV, one step a token (the reference's ``_wkv_scan``,
    which ``wkv_chunked`` runs in the same order). r,k,v,w: (B,S,H,K)
    fp32; u: (H,K); state: (B,H,K,K). Returns (y: (B,S,H,K), final
    state).

    A step is four launches: the outer product k v^T, ``S + u * kv``
    and ``w * S + kv`` as ``addcmul``s, and ``r^T (...)`` as one batched
    product over the (B*H) heads, whose r rows are laid out once per
    call so that a token's rows are a view."""
    B, S, H, K = r.shape
    rows = r.transpose(1, 2).contiguous()                 # (B,H,S,K)
    ub = u[None, :, :, None]
    St = state0
    ys = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]     # (B,H,K,K)
        m = torch.addcmul(St, ub, kv)                      # S + u kv
        ys.append(torch.bmm(rows[:, :, t].reshape(B * H, 1, K),
                            m.reshape(B * H, K, K)).reshape(B, H, K))
        St = torch.addcmul(kv, w[:, t, :, :, None], St)    # w S + kv
    return torch.stack(ys, dim=1), St


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """prev-token mix. x: (B,S,d); prev: (B,d) carry from decode or zeros."""
    if x.shape[1] == 1:
        return prev[:, None, :]
    return torch.cat([prev[:, None, :], x[:, :-1]], dim=1)


def time_mix(p: dict, x: torch.Tensor, cfg: ModelConfig,
             prev_x: torch.Tensor, state0: torch.Tensor):
    """-> (out, the last token's x for the next shift, WKV state)."""
    B, S, d = x.shape
    H = cfg.num_heads
    K = cfg.resolved_head_dim
    xx = _token_shift(x, prev_x)
    sx = xx - x
    xxx = x + sx * p["x_maa"]
    m = torch.tanh(L.matmul(xxx, p["maa_w1"])).reshape(B, S, 5, _LORA)
    m = torch.einsum("bsfl,fld->bsfd", m, p["maa_w2"])
    xw, xk, xv, xr, xg = [
        x + sx * (p["maa"][i] + m[:, :, i]) for i in range(5)]

    r = L.matmul(xr, p["wr"]).reshape(B, S, H, K)
    kk = L.matmul(xk, p["wk"]).reshape(B, S, H, K)
    vv = L.matmul(xv, p["wv"]).reshape(B, S, H, K)
    g = F.silu(L.matmul(xg, p["wg"]).float()).to(x.dtype)

    dec = p["decay"] + L.matmul(torch.tanh(L.matmul(xw, p["decay_w1"])),
                                p["decay_w2"])
    w = torch.exp(-torch.exp(dec.float())).reshape(B, S, H, K)
    u = p["u"].reshape(H, K).float()

    y, Sf = wkv_scan(r.float(), kk.float(), vv.float(), w, u, state0)
    # per-head group norm, population variance as jnp.var
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    yh = (y - mu) * torch.rsqrt(var + 64e-5)
    y = yh.reshape(B, S, d) * (1.0 + p["ln_x_w"]) + p["ln_x_b"]
    out = L.matmul(y.to(x.dtype) * g, p["wo"])
    return out, x[:, -1], Sf


def channel_mix(p: dict, x: torch.Tensor, prev_x: torch.Tensor):
    """-> (out, the last token's x for the next shift)."""
    xx = _token_shift(x, prev_x)
    sx = xx - x
    xk = x + sx * p["k_maa"]
    xr = x + sx * p["r_maa"]
    k = torch.square(F.relu(L.matmul(xk, p["wk"]).float())).to(x.dtype)
    v = L.matmul(k, p["wv"])
    r = torch.sigmoid(L.matmul(xr, p["wr"]).float()).to(x.dtype)
    return r * v, x[:, -1]


class RWKV6Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.vp = tfm.padded_vocab(cfg.vocab_size)

    def _top_table(self) -> dict:
        return {
            "embed": L.embed_table(self.vp, self.cfg.d_model),
            "final_norm": L.norm_table(self.cfg.d_model),
            "head": L.head_table(self.vp, self.cfg.d_model),
        }

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict:
        """Random parameters in ``cfg.param_dtype`` from one
        ``torch.Generator`` seeded with ``seed`` on ``device`` (default:
        the CUDA card); the reference's distributions, not its
        numbers."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dt = tfm._dtype(self.cfg.param_dtype)
        params = pm.init_table(gen, self._top_table(), dt, dev)
        params["layers"] = pm.init_table(gen, rwkv6_table(self.cfg), dt, dev,
                                         stack=self.cfg.num_layers)
        return params

    def param_specs(self) -> Dict:
        """The logical-name tree of the parameters (``optimizer.
        state_specs`` reads it); its mesh branches wait for ROADMAP
        Queue 1 item 8c."""
        specs = pm.table_specs(self._top_table())
        specs["layers"] = pm.table_specs(rwkv6_table(self.cfg),
                                         prefix=("layers",))
        return specs

    def param_shapes(self, dtype: Optional[torch.dtype] = None) -> Dict:
        dt = dtype or tfm._dtype(self.cfg.param_dtype)
        shapes = pm.shape_tree(self._top_table(), dt)
        shapes["layers"] = pm.shape_tree(rwkv6_table(self.cfg), dt,
                                         stack=self.cfg.num_layers)
        return shapes

    def param_count(self) -> int:
        return (pm.table_size(self._top_table())
                + pm.table_size(rwkv6_table(self.cfg)) * self.cfg.num_layers)

    def _layer(self, lp, x, tm_state, tm_prev, cm_prev):
        cfg = self.cfg
        h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
        dt_, tm_prev_new, tm_state_new = time_mix(
            lp["tm"], h, cfg, tm_prev, tm_state)
        x = x + dt_
        h = L.rmsnorm(x, lp["ln2"], cfg.norm_eps)
        dc, cm_prev_new = channel_mix(lp["cm"], h, cm_prev)
        return x + dc, tm_state_new, tm_prev_new, cm_prev_new

    def _zero_states(self, B: int, device) -> States:
        cfg = self.cfg
        H, K = cfg.num_heads, cfg.resolved_head_dim
        tm_state = torch.zeros((cfg.num_layers, B, H, K, K),
                               dtype=torch.float32, device=device)
        tm_prev = torch.zeros((cfg.num_layers, B, cfg.d_model),
                              dtype=tfm._dtype(cfg.dtype), device=device)
        return tm_state, tm_prev, torch.zeros_like(tm_prev)

    def forward(self, params: Dict, batch: Dict,
                states: Optional[States] = None, train: bool = False):
        """Hidden states after the final norm, and the new (tm_state,
        tm_prev, cm_prev), each stacked over layers; ``states`` (zeros
        when None) is read, not written.  ``train`` checkpoints each
        layer as ``cfg.remat`` says."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"])
        if states is None:
            states = self._zero_states(x.shape[0], x.device)
        new = tuple(torch.empty_like(s) for s in states)
        layer = tfm._remat(self._layer, cfg.remat if train else "none")
        for i, lp in enumerate(pm.unstack(params["layers"],
                                          cfg.num_layers)):
            x, *st = layer(lp, x, *(s[i] for s in states))
            for buf, s in zip(new, st):
                buf[i].copy_(s)
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), new

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        x, _ = self.forward(params, batch, train=True)
        logits = L.unembed(x, params["head"], tied=False)
        return tfm.cross_entropy(logits, batch["labels"],
                                 self.cfg.vocab_size).mean()

    # serving ----------------------------------------------------------
    def prefill(self, params: Dict, batch: Dict,
                cache_len: Optional[int] = None):
        """-> (last_logits, cache).  The recurrent state is O(1):
        ``cache_len`` is accepted for the uniform model API and
        ignored, as in the reference."""
        x, (tm_state, tm_prev, cm_prev) = self.forward(params, batch)
        logits = L.unembed(x[:, -1:], params["head"], tied=False)
        cache = {"tm_state": tm_state, "tm_prev": tm_prev,
                 "cm_prev": cm_prev,
                 "pos": torch.full((), batch["tokens"].shape[1] - 1,
                                   dtype=torch.int32, device=x.device)}
        return logits, cache

    def decode_step(self, params: Dict, cache: Dict, batch: Dict):
        """One token for the whole batch. batch: {"tokens": (B,1)}."""
        states = (cache["tm_state"], cache["tm_prev"], cache["cm_prev"])
        x, (st, tp, cp) = self.forward(params, batch, states=states)
        logits = L.unembed(x, params["head"], tied=False)
        return logits, {"tm_state": st, "tm_prev": tp, "cm_prev": cp,
                        "pos": cache["pos"] + 1}

    # specs --------------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The batch of a ``shape`` cell as meta tensors."""
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": pm.meta((B, 1), torch.int32)}
        spec = {"tokens": pm.meta((B, S), torch.int32)}
        if shape.kind == "train":
            spec["labels"] = pm.meta((B, S), torch.int32)
        return spec

    def cache_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B = shape.global_batch
        H, K = cfg.num_heads, cfg.resolved_head_dim
        prev = pm.meta((cfg.num_layers, B, cfg.d_model),
                       tfm._dtype(cfg.dtype))
        return {"tm_state": pm.meta((cfg.num_layers, B, H, K, K),
                                    torch.float32),
                "tm_prev": prev, "cm_prev": prev,
                "pos": pm.meta((), torch.int32)}

    def init_cache(self, shape: ShapeConfig,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """A zero cache of ``cache_specs(shape)`` on ``device`` (default:
        the CUDA card)."""
        return pm.zeros_from(self.cache_specs(shape), resolve_device(device))
