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

On a mesh (``distributed.sharding.use_mesh`` with a DeviceMesh and
``registry.make_rules``) each rank computes on its batch block.  The
five square time-mix projections and the channel mix's ``wr`` are
``("attn_din", "rwkv_out")``, used as ``("attn_din_c", "rwkv_out_c")``
(``layers.linear``): whole under head-TP prefill rules, gathered from
their ``data`` blocks under FSDP, and under decode rules contracted on
``model`` (a psum).  The channel mix's ``wk``/``wv`` are Megatron over
``ffn`` (a psum), the WKV recurrence and the per-head group norm run on
whole heads (``rwkv_out`` never shards), the embedding, head and CE are
vocab-parallel, and the states are batch-blocked as ``cache_logical``
says.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
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


#: the square projections' names at use (``rwkv6_table`` stores them
#: as ``("attn_din", "rwkv_out")``)
_SQUARE = ("attn_din_c", "rwkv_out_c")


#: ``launch.dryrun``'s hook, set only there: None runs every trip of
#: :func:`wkv_scan`; else ``SCAN_HOOK(trip, S, state0, operands)``
#: stands for the loop, (y, final state), running ``trip(t, state,
#: *operands)`` as it chooses
SCAN_HOOK = None


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
    S = r.shape[1]
    operands = (r.transpose(1, 2).contiguous(),           # (B,H,S,K)
                k, v, w, u[None, :, :, None])
    if SCAN_HOOK is not None:
        return SCAN_HOOK(_wkv_trip, S, state0, operands)
    St = state0
    ys = []
    for t in range(S):
        y, St = _wkv_trip(t, St, *operands)
        ys.append(y)
    return torch.stack(ys, dim=1), St


def _wkv_trip(t: int, St: torch.Tensor, rows: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, w: torch.Tensor, ub: torch.Tensor):
    """Token ``t`` of :func:`wkv_scan`: (y (B,H,K), the next state)."""
    B, H, _, K = rows.shape
    kv = k[:, t, :, :, None] * v[:, t, :, None, :]         # (B,H,K,K)
    m = torch.addcmul(St, ub, kv)                          # S + u kv
    y = torch.bmm(rows[:, :, t].reshape(B * H, 1, K),
                  m.reshape(B * H, K, K)).reshape(B, H, K)
    return y, torch.addcmul(kv, w[:, t, :, :, None], St)  # w S + kv


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
    # the square projections go to layers.linear whole; the rest are
    # this rank's blocks (the leaves themselves with no mesh)
    w_ = {k: p[k] for k in ("wr", "wk", "wv", "wg", "wo")}
    names = rwkv6_table(cfg)["tm"]
    p = {k: shd.local(v, *names[k].names) for k, v in p.items()
         if k not in w_}
    xx = _token_shift(x, prev_x)
    sx = xx - x
    xxx = x + sx * p["x_maa"]
    m = torch.tanh(L.matmul(xxx, p["maa_w1"])).reshape(B, S, 5, _LORA)
    m = torch.einsum("bsfl,fld->bsfd", m, p["maa_w2"])
    xw, xk, xv, xr, xg = [
        x + sx * (p["maa"][i] + m[:, :, i]) for i in range(5)]

    r = L.linear(xr, w_["wr"], _SQUARE).reshape(B, S, H, K)
    kk = L.linear(xk, w_["wk"], _SQUARE).reshape(B, S, H, K)
    vv = L.linear(xv, w_["wv"], _SQUARE).reshape(B, S, H, K)
    g = F.silu(L.linear(xg, w_["wg"], _SQUARE).float()).to(x.dtype)

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
    out = L.linear(y.to(x.dtype) * g, w_["wo"], _SQUARE)
    return out, x[:, -1], Sf


def channel_mix(p: dict, x: torch.Tensor, prev_x: torch.Tensor):
    """-> (out, the last token's x for the next shift).  On a mesh
    ``wk``/``wv`` are Megatron over ``ffn``: this rank's hidden columns,
    then a psum."""
    fspec = (None if shd.device_mesh() is None
             else shd.spec(p["wk"], "embed", "ffn")[1])
    xx = _token_shift(x, prev_x)
    sx = xx - x
    xk = x + sx * shd.local(p["k_maa"], "embed")
    xr = x + sx * shd.local(p["r_maa"], "embed")
    k = torch.square(F.relu(L.matmul(
        xk, shd.local(p["wk"], "embed", "ffn")).float())).to(x.dtype)
    v = L.psum_matmul(k, shd.local(p["wv"], "ffn", "embed"), fspec)
    r = torch.sigmoid(L.linear(xr, p["wr"], _SQUARE).float()).to(x.dtype)
    return r * v, x[:, -1]


class RWKV6Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.vp = tfm.padded_vocab(cfg.vocab_size)
        self._lm = tfm.DecoderLM(cfg)   # the vocab-parallel head and CE

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
        state_specs`` and the mesh placement read it)."""
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
        h = L.rmsnorm(x, shd.local(lp["ln1"], "embed"), cfg.norm_eps)
        dt_, tm_prev_new, tm_state_new = time_mix(
            lp["tm"], h, cfg, tm_prev, tm_state)
        x = x + dt_
        h = L.rmsnorm(x, shd.local(lp["ln2"], "embed"), cfg.norm_eps)
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
        layer as ``cfg.remat`` says.  On a mesh the hidden states and
        ``states`` are this rank's batch block."""
        cfg = self.cfg
        x = L.mesh_embed(params["embed"], batch["tokens"])
        if states is None:
            states = self._zero_states(x.shape[0], x.device)
        new = tuple(torch.empty_like(s) for s in states)
        layer = tfm._remat(self._layer, cfg.remat if train else "none")
        for i, lp in enumerate(L.unstack(params["layers"],
                                         cfg.num_layers)):
            x, *st = layer(lp, x, *(s[i] for s in states))
            for buf, s in zip(new, st):
                buf[i].copy_(s)
        return L.rmsnorm(x, shd.local(params["final_norm"], "embed"),
                         cfg.norm_eps), new

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Mean next-token CE; on a mesh vocab-parallel over the global
        batch (``DecoderLM.mean_ce``)."""
        return self._lm.mean_ce(params, self.forward(params, batch,
                                                     train=True)[0], batch)

    # serving ----------------------------------------------------------
    def prefill(self, params: Dict, batch: Dict,
                cache_len: Optional[int] = None):
        """-> (last_logits, cache).  The recurrent state is O(1):
        ``cache_len`` is accepted for the uniform model API and
        ignored, as in the reference."""
        x, (tm_state, tm_prev, cm_prev) = self.forward(params, batch)
        logits = self._lm._logits(params, x[:, -1:])
        cache = {"tm_state": tm_state, "tm_prev": tm_prev,
                 "cm_prev": cm_prev,
                 "pos": torch.full((), batch["tokens"].shape[1] - 1,
                                   dtype=torch.int32, device=x.device)}
        if shd.device_mesh() is not None:
            whole = self.cache_specs(ShapeConfig(
                "state", 1, batch["tokens"].shape[0], "prefill"))
            cache = shd.place_local_tree(cache, self.cache_logical(None),
                                         whole)
        return self._lm._place_logits(batch, logits), cache

    def decode_step(self, params: Dict, cache: Dict, batch: Dict):
        """One token for the whole batch. batch: {"tokens": (B,1)}."""
        names = self.cache_logical(None)
        states = tuple(shd.local(cache[k], *names[k])
                       for k in ("tm_state", "tm_prev", "cm_prev"))
        x, (st, tp, cp) = self.forward(params, batch, states=states)
        logits = self._lm._logits(params, x)
        new = {"tm_state": st, "tm_prev": tp, "cm_prev": cp,
               "pos": shd.local(cache["pos"]) + 1}
        if shd.device_mesh() is not None:
            new = shd.place_local_tree(new, names, cache)
        return self._lm._place_logits(batch, logits), new

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

    def input_logical(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        out = {"tokens": ("batch", None)}
        if shape.kind == "train":
            out["labels"] = ("batch", None)
        return out

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

    def cache_logical(self, shape: Optional[ShapeConfig]) -> Dict[str, Tuple]:
        return {"tm_state": ("layers", "batch", None, None, None),
                "tm_prev": ("layers", "batch", "embed"),
                "cm_prev": ("layers", "batch", "embed"),
                "pos": ()}

    def init_cache(self, shape: ShapeConfig,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """A zero cache of ``cache_specs(shape)`` on ``device`` (default:
        the CUDA card)."""
        return pm.zeros_from(self.cache_specs(shape), resolve_device(device))
