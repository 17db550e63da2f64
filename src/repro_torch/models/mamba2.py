"""Mamba2 (SSD) block and the Zamba2 hybrid stack, in PyTorch: the
counterpart of ``repro.models.mamba2``, for generation and training.

Zamba2 structure: groups of ``attn_every`` Mamba2 layers, one *shared*
attention+MLP block applied after each group (its weights reused by all
the groups), and a tail of leftover Mamba2 layers (81 = 13 * 6 + 3 at
full width).  The parameter tree is the reference's: the groups' leaves
stacked ``(n_groups, group, ...)``, the tail's ``(tail, ...)``, so
``transformer.params_from_reference`` carries it over as it is.  The
reference's scans over groups, layers and chunks are Python loops here.

SSD keeps the reference's chunked algorithm: chunks of
``pick_block(S, chunk)`` tokens (the result depends on the chunk size
through its summation order, so the port cuts the same chunks, and a
prompt length with no divisor near ``chunk`` gets small chunks, unpadded,
as in the reference), the intra-chunk quadratic form, and a loop over the
chunks that carries the fp32 state.  The one-token decode step is the
recurrence ``h = h * exp(dt A) + dt x B^T``.

Prefill attention runs the flash-attention kernel and decode attention
the flash-decode kernel, through ``DecoderLM._attention`` and
``_decode_attention``, as the reference reuses its own.

Differences from the reference, each deliberate:

- Mixed dtypes.  JAX's einsum promotes bf16 with fp32 to fp32; torch's
  refuses two dtypes.  Every product that mixes them (``ssd_chunked``'s
  ``att`` and ``y_off``, the decode ``upd``) widens its bf16 operands to
  fp32 first, and casts back where the reference casts
  (``h_prevs.astype(Cr.dtype)``, ``y.astype(x.dtype)``).
- Decode keeps ``pos`` a device int32 tensor and writes the cache IN
  PLACE, where the reference returns updated copies: the 13 shared
  attention KV caches ``attn_k``/``attn_v`` ``(n_groups, B, T, kv, D)``
  at ``pos``, and every layer's fp32 SSM state and conv states
  (``group_ssm``, ``group_conv``, ``tail_ssm``, ``tail_conv``).
  ``decode_step`` returns the same buffers; a caller that wants the
  cache before the step keeps a copy.  A step makes no host sync: no
  ``.item()``, no boolean indexing, no branch on a device value.

``loss`` (mean CE, unchunked as in the reference) runs the shared
block's attention through the differentiable
``layers.flash_attention_blocked`` and checkpoints as the reference's
scans do (``cfg.remat``): each Mamba2 layer, and each group (its layers
and the shared block) around them.

On a mesh (``distributed.sharding.use_mesh`` with a DeviceMesh and
``registry.make_rules``) each rank computes on its batch block, sharded
as the reference's table says: ``in_x``, ``in_z``, ``conv_x`` and
``gnorm`` on ``ffn`` (this rank's d_inner columns), ``in_dt``,
``A_log``, ``D`` and ``dt_bias`` on ``mamba_heads``, ``in_bc`` and
``conv_bc`` whole, ``out`` row-parallel (one psum).  The SSD and the
decode recurrence run on the rank's heads.  Two places need more than
the local code:

- the gated RMSNorm normalises over the whole d_inner: its mean of
  squares is the psum of the blocks' sums (``layers.rmsnorm_sharded``);
- where ``mamba_heads`` does not shard as ``ffn`` does (whole heads
  while ``ffn`` shards: a rank's columns cut through heads), x is
  gathered to whole heads for the SSD and y cut back to the rank's
  columns (``layers.reblock``).

The shared block takes ``DecoderLM``'s mesh branches (head-TP or
context parallelism at prefill, the sequence-sharded cache at decode)
and its MLP is Megatron over ``ffn`` (``layers.mesh_mlp``); the
embedding, head and CE are vocab-parallel, the states are placed as
``cache_logical`` says.  Training differentiates the shared block once
per application; autograd sums them into its one gradient before the
DP all-reduce.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import params as pm
from repro_torch.models import transformer as tfm
from repro_torch.models.params import Spec

# --------------------------------------------------------------- tables


def mamba2_table(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    return {
        "norm": L.norm_table(d),
        "in_x": Spec((d, di), ("embed", "ffn")),
        "in_z": Spec((d, di), ("embed", "ffn")),
        "in_bc": Spec((d, 2 * s.d_state), ("embed", None)),
        "in_dt": Spec((d, nh), ("embed", "mamba_heads")),
        "conv_x": Spec((s.conv_width, di), ("conv", "ffn"), "normal:0.5"),
        "conv_bc": Spec((s.conv_width, 2 * s.d_state), ("conv", None),
                        "normal:0.5"),
        "A_log": Spec((nh,), ("mamba_heads",), "zeros"),
        "D": Spec((nh,), ("mamba_heads",), "ones"),
        "dt_bias": Spec((nh,), ("mamba_heads",), "zeros"),
        "gnorm": Spec((di,), ("ffn",), "zeros"),
        "out": Spec((di, d), ("ffn", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv. u: (B,S,C), w: (W,C). Returns (y, new_state)
    where state carries the last W-1 inputs for decode."""
    W = w.shape[0]
    if state is None:
        state = u.new_zeros((u.shape[0], W - 1, u.shape[2]))
    ext = torch.cat([state, u], dim=1)
    y = sum(ext[:, i:i + u.shape[1]] * w[i] for i in range(W))
    return y, ext[:, -(W - 1):]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., Q). Returns (..., Q, Q) lower-tri pairwise sums
    cum[t]-cum[s] for s<=t (exclusive of a[s], inclusive of a[t]), -inf
    above the diagonal.  The ``where`` comes before any ``exp``: the
    masked entries become -inf here, never inf - inf."""
    Q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None):
    """SSD (Mamba2) chunked scan.

    x: (B,S,H,P); dt: (B,S,H) fp32; A: (H,) negative fp32; Bm/Cm:
    (B,S,N).  Returns (y: (B,S,H,P) in x's dtype, h_final: (B,H,P,N)
    fp32).  The bf16 operands of a product with fp32 ones are widened
    first (JAX's promotion); ``h_prevs`` is rounded to Cm's dtype before
    its product, as in the reference.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = L.pick_block(S, chunk)
    nc = S // Q

    xr = x.reshape(Bsz, nc, Q, H, P)
    dtr = dt.reshape(Bsz, nc, Q, H)
    Br = Bm.reshape(Bsz, nc, Q, N).float()
    Cr = Cm.reshape(Bsz, nc, Q, N)
    a = dtr * A                                    # (B,nc,Q,H) negative
    xdt = xr * dtr[..., None]                      # fp32 by promotion

    cum = torch.cumsum(a, dim=2)                   # (B,nc,Q,H)
    # intra-chunk
    Lm = torch.exp(_segsum(a.transpose(2, 3)))     # (B,nc,H,Q,Q)
    att = torch.einsum("bcqn,bcsn->bcqs", Cr.float(), Br)[:, :, None] * Lm
    y = torch.einsum("bchqs,bcshp->bcqhp", att, xdt)
    # chunk -> state
    decay_st = torch.exp(cum[:, :, -1:, :] - cum)  # (B,nc,Q,H)
    states = torch.einsum("bcsn,bcshp->bchpn", Br,
                          xdt * decay_st[..., None])
    # inter-chunk scan: h_prevs[c] is the state entering chunk c
    chunk_decay = torch.exp(cum[:, :, -1, :])      # (B,nc,H)
    h = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
         if h0 is None else h0)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    hp = torch.stack(h_prevs, dim=1).to(Cr.dtype).float()   # (B,nc,H,P,N)
    y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cr.float(), hp)
             * torch.exp(cum)[..., None])
    y = (y + y_off).reshape(Bsz, S, H, P)
    return y.to(x.dtype), h


def mamba2_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                 ssm_state: Optional[torch.Tensor] = None,
                 conv_state: Optional[dict] = None):
    """Full-sequence (prefill) or single-step (decode) Mamba2 ->
    (x + out, h_final fp32, {"x", "bc"} conv states).

    Decode when x has S == 1 and states are provided: the recurrence,
    with the bf16 ``Bm`` widened to fp32 for ``upd`` and the new state
    rounded to ``Cm``'s dtype for ``y``, as in the reference.
    """
    s = cfg.ssm
    di = s.expand * cfg.d_model
    B, S, _ = x.shape
    fspec = hspec = None
    if shd.device_mesh() is not None:
        fspec = shd.spec(p["in_x"], "embed", "ffn")[1]
        hspec = shd.spec(p["in_dt"], "embed", "mamba_heads")[1]
    names = mamba2_table(cfg)
    p = {k: shd.local(v, *names[k].names) for k, v in p.items()}

    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    xz = L.matmul(h, p["in_x"])
    z = L.matmul(h, p["in_z"])
    bc = L.matmul(h, p["in_bc"])
    dt_raw = L.matmul(h, p["in_dt"])

    xz, conv_state_x = _causal_conv(
        xz, p["conv_x"], None if conv_state is None else conv_state["x"])
    bc, conv_state_bc = _causal_conv(
        bc, p["conv_bc"], None if conv_state is None else conv_state["bc"])
    xz = F.silu(xz.float()).to(x.dtype)
    bc = F.silu(bc.float()).to(x.dtype)
    Bm, Cm = bc[..., :s.d_state], bc[..., s.d_state:]

    A = -torch.exp(p["A_log"].float())
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    # the columns of this rank's heads (all of them with no mesh)
    xz = L.reblock(xz, fspec, hspec)
    nh = xz.shape[-1] // s.head_dim
    xh = xz.reshape(B, S, nh, s.head_dim)

    if S == 1 and ssm_state is not None:
        # recurrent decode step
        a = torch.exp(dt[:, 0] * A)                        # (B,H)
        upd = ((dt[:, 0, :, None] * xh[:, 0].float())[..., None]
               * Bm[:, 0, None, None, :].float())          # (B,H,P,N)
        h_fin = ssm_state * a[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], h_fin.to(Cm.dtype))
        y = y.reshape(B, 1, nh, s.head_dim)
    else:
        y, h_fin = ssd_chunked(xh, dt, A, Bm, Cm, s.chunk, h0=ssm_state)

    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = L.reblock(y.reshape(B, S, nh * s.head_dim), hspec, fspec)
    y = L.rmsnorm_sharded(y * F.silu(z.float()).to(x.dtype), p["gnorm"],
                          fspec, di, cfg.norm_eps)
    out = L.psum_matmul(y, p["out"], fspec)
    return x + out, h_fin, {"x": conv_state_x, "bc": conv_state_bc}


# --------------------------------------------------------------- zamba2


class Zamba2Model:
    """Hybrid: n_groups groups of (group mamba layers + the shared
    attn/mlp block), then a tail of mamba layers."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.vp = tfm.padded_vocab(cfg.vocab_size)
        k = cfg.ssm.attn_every
        self.n_groups = cfg.num_layers // k if k else 0
        self.group = k
        self.tail = cfg.num_layers - self.n_groups * k
        self._lm = tfm.DecoderLM(cfg)   # reuse the attention/mlp pieces

    # params -----------------------------------------------------------
    def _attn_block_table(self) -> dict:
        cfg = self.cfg
        return {
            "ln1": L.norm_table(cfg.d_model),
            "attn": L.attn_table(cfg),
            "ln2": L.norm_table(cfg.d_model),
            "mlp": L.mlp_table(cfg.d_model, cfg.d_ff),
        }

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
        mt = mamba2_table(self.cfg)
        grp = pm.init_table(gen, mt, dt, dev,
                            stack=self.n_groups * self.group)
        params["groups"] = pm.tree_map(
            lambda a: a.reshape((self.n_groups, self.group) + a.shape[1:]),
            grp)
        params["tail"] = pm.init_table(gen, mt, dt, dev, stack=self.tail)
        params["shared_attn"] = pm.init_table(gen, self._attn_block_table(),
                                              dt, dev)
        return params

    def param_specs(self) -> Dict:
        """The logical-name tree of the parameters (``optimizer.
        state_specs`` and the mesh placement read it)."""
        mt = mamba2_table(self.cfg)
        specs = pm.table_specs(self._top_table())
        specs["groups"] = pm.table_specs(mt, prefix=("layers", "layers"))
        specs["tail"] = pm.table_specs(mt, prefix=("layers",))
        specs["shared_attn"] = pm.table_specs(self._attn_block_table())
        return specs

    def param_shapes(self, dtype: Optional[torch.dtype] = None) -> Dict:
        dt = dtype or tfm._dtype(self.cfg.param_dtype)
        mt = mamba2_table(self.cfg)
        shapes = pm.shape_tree(self._top_table(), dt)
        shapes["groups"] = pm.tree_map(
            lambda s: pm.ShapeDtype((self.n_groups,) + s.shape, dt),
            pm.shape_tree(mt, dt, stack=self.group))
        shapes["tail"] = pm.shape_tree(mt, dt, stack=self.tail)
        shapes["shared_attn"] = pm.shape_tree(self._attn_block_table(), dt)
        return shapes

    def param_count(self) -> int:
        n = pm.table_size(self._top_table())
        n += pm.table_size(mamba2_table(self.cfg)) * self.cfg.num_layers
        n += pm.table_size(self._attn_block_table())
        return n

    # forward ----------------------------------------------------------
    def _attn_block(self, ap: dict, x: torch.Tensor, pos: torch.Tensor,
                    train: bool = False):
        cfg = self.cfg
        h, kv = self._lm._attention(
            ap["attn"], L.rmsnorm(x, shd.local(ap["ln1"], "embed"),
                                  cfg.norm_eps), pos, train)
        x = x + h
        return x + L.mesh_mlp(ap["mlp"], L.rmsnorm(
            x, shd.local(ap["ln2"], "embed"), cfg.norm_eps)), kv

    def _groups(self, params: Dict) -> list:
        """Each group's per-layer parameter trees."""
        return [L.unstack(gp, self.group)
                for gp in L.unstack(params["groups"], self.n_groups)]

    def _layers(self, params: Dict):
        """(group index or None for the tail, layer index in it, the
        layer's parameters) in the order the stack runs them."""
        for i, gp in enumerate(self._groups(params)):
            for j, lp in enumerate(gp):
                yield i, j, lp
        for j, lp in enumerate(L.unstack(params["tail"], self.tail)):
            yield None, j, lp

    def _final(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return L.rmsnorm(x, shd.local(params["final_norm"], "embed"),
                         self.cfg.norm_eps)

    def _stack(self, params: Dict, x: torch.Tensor,
               cache: Optional[Dict] = None):
        """The stack over full sequences: each mamba layer, and after
        each group the shared block.  With ``cache`` (state buffers from
        :meth:`_state_buffers`) each layer's final SSM and conv states
        are written into it, and the shared block's K/V of each group
        are returned; -> (hidden states after the final norm, [(k, v)])."""
        cfg = self.cfg
        pos = torch.arange(x.shape[1], device=x.device)
        kvs = []
        for i, j, lp in self._layers(params):
            x, h_fin, conv = mamba2_apply(lp, x, cfg)
            if cache is not None:
                self._store(cache, i, j, h_fin, conv)
            if i is not None and j == self.group - 1:
                x, kv = self._attn_block(params["shared_attn"], x, pos)
                if cache is not None:
                    kvs.append(kv)
        return self._final(params, x), kvs

    def forward(self, params: Dict, batch: Dict, train: bool = False):
        """Full-sequence hidden states after the final norm, and 0.0 (no
        aux loss), as the reference returns.  ``train`` runs the
        differentiable attention and checkpoints each layer and each
        group as ``cfg.remat`` says."""
        cfg = self.cfg
        x = L.mesh_embed(params["embed"], batch["tokens"])
        if not train:
            return self._stack(params, x)[0], 0.0
        pos = torch.arange(x.shape[1], device=x.device)
        layer = tfm._remat(lambda lp, x: mamba2_apply(lp, x, cfg)[0],
                           cfg.remat)

        def group(layers, x):
            for lp in layers:
                x = layer(lp, x)
            return self._attn_block(params["shared_attn"], x, pos, True)[0]

        group = tfm._remat(group, cfg.remat)
        for gp in self._groups(params):
            x = group(gp, x)
        for lp in L.unstack(params["tail"], self.tail):
            x = layer(lp, x)
        return self._final(params, x), 0.0

    def loss(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Mean next-token CE; on a mesh vocab-parallel over the global
        batch (``DecoderLM.mean_ce``)."""
        return self._lm.mean_ce(params, self.forward(params, batch,
                                                     train=True)[0], batch)

    # serving ----------------------------------------------------------
    _STATES = ("group_ssm", "group_conv", "tail_ssm", "tail_conv")

    def _state_buffers(self, B: int, device) -> Dict:
        """Empty per-layer state buffers of a batch of ``B``, stacked as
        the reference's scans stack them: ssm (..., B, nh, P, N) fp32,
        conv (..., B, W-1, C) in ``cfg.dtype``; on a mesh this rank's
        blocks of them."""
        specs = self.cache_specs(ShapeConfig("state", 1, B, "prefill"))
        names = self.cache_logical(None)
        mesh = shd.device_mesh()

        def buf(s, n):
            shape = s.shape
            if mesh is not None:
                shape = shd.block(s, shd.make_sharding(n, s.shape),
                                  mesh).shape
            return torch.empty(shape, dtype=s.dtype, device=device)

        return {k: pm.tree_map(buf, specs[k], names[k])
                for k in self._STATES}

    @staticmethod
    def _slot(cache: Dict, i: Optional[int], j: int):
        """(ssm state, {"x", "bc"} conv states) of layer j of group i (or
        of the tail when i is None): views into the cache."""
        if i is None:
            return (cache["tail_ssm"][j],
                    {k: v[j] for k, v in cache["tail_conv"].items()})
        return (cache["group_ssm"][i, j],
                {k: v[i, j] for k, v in cache["group_conv"].items()})

    def _store(self, cache: Dict, i: Optional[int], j: int,
               h_fin: torch.Tensor, conv: Dict) -> None:
        """Write layer (i, j)'s new states into the cache, in place."""
        ssm, cv = self._slot(cache, i, j)
        ssm.copy_(h_fin)
        for k in cv:
            cv[k].copy_(conv[k])

    def prefill(self, params: Dict, batch: Dict,
                cache_len: Optional[int] = None):
        """Full-sequence forward; returns (last_logits, cache).

        cache_len pads the shared block's KV caches beyond the prompt so
        decode steps have room (defaults to prompt length)."""
        dt = tfm._dtype(self.cfg.dtype)
        B = batch["tokens"].shape[0]
        x = L.mesh_embed(params["embed"], batch["tokens"])
        cache = self._state_buffers(B, x.device)
        x, kvs = self._stack(params, x, cache)
        logits = self._lm._logits(params, x[:, -1:])
        for n, name in enumerate(("attn_k", "attn_v")):
            cache[name] = tfm.pad_cache(
                torch.stack([kv[n].to(dt) for kv in kvs]), cache_len)
        cache["pos"] = torch.full((), x.shape[1] - 1, dtype=torch.int32,
                                  device=x.device)
        if shd.device_mesh() is not None:
            # the K/V as DecoderLM places them: this rank's kv_seq slice
            for name in ("attn_k", "attn_v"):
                cache[name] = tfm.place_kv_cache(cache[name], B)
            cache = shd.place_local_tree(
                cache, self.cache_logical(None),
                self.cache_specs(ShapeConfig("state", 1, B, "prefill")))
        return self._lm._place_logits(batch, logits), cache

    def decode_step(self, params: Dict, cache: Dict, batch: Dict):
        """One token for the whole batch. batch: {"tokens": (B,1)}.

        Writes the new K/V of each group's shared block into
        ``cache["attn_k"][i]``/``["attn_v"][i]`` and every layer's new SSM
        and conv states into the cache, all in place; returns (logits,
        the same buffers with the advanced device ``pos``)."""
        cfg = self.cfg
        mesh = shd.device_mesh()
        x = L.mesh_embed(params["embed"], batch["tokens"])
        names = self.cache_logical(None)
        loc = {k: pm.tree_map(lambda t, n: shd.local(t, *n), v, names[k])
               for k, v in cache.items()}
        pos = loc["pos"] + 1
        se = (None if mesh is None else shd.resolve_for_shape(
            ("kv_seq",), (cache["attn_k"].shape[2],))[0])
        ap = params["shared_attn"]
        for i, j, lp in self._layers(params):
            ssm, cv = self._slot(loc, i, j)
            x, h_fin, conv = mamba2_apply(lp, x, cfg, ssm_state=ssm,
                                          conv_state=cv)
            self._store(loc, i, j, h_fin, conv)
            if i is not None and j == self.group - 1:
                h = L.rmsnorm(x, shd.local(ap["ln1"], "embed"), cfg.norm_eps)
                h, _, _ = self._lm._decode_attention(
                    ap["attn"], h, pos, loc["attn_k"][i], loc["attn_v"][i],
                    se)
                x = x + h
                x = x + L.mesh_mlp(ap["mlp"], L.rmsnorm(
                    x, shd.local(ap["ln2"], "embed"), cfg.norm_eps))
        logits = self._lm._logits(params, self._final(params, x))
        if mesh is not None:
            # the cache's own DTensors hold the writes; the blocks of
            # plain whole leaves are placed
            loc = shd.place_local_tree(
                {k: pm.tree_map(lambda c, b: c if isinstance(c, DTensor)
                                else b, cache[k], v)
                 for k, v in loc.items() if k != "pos"} | {"pos": pos},
                names, cache)
        else:
            loc["pos"] = pos
        return self._lm._place_logits(batch, logits), loc

    # specs -------------------------------------------------------------
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

    def cache_specs(self, shape: ShapeConfig) -> Dict:
        cfg, s = self.cfg, self.cfg.ssm
        B, T = shape.global_batch, shape.seq_len
        di = s.expand * cfg.d_model
        nh = di // s.head_dim
        kv, D = cfg.num_kv_heads, cfg.resolved_head_dim
        dt = tfm._dtype(cfg.dtype)

        def ssm(lead):
            return pm.meta(lead + (B, nh, s.head_dim, s.d_state),
                           torch.float32)

        def conv(lead):
            return {"x": pm.meta(lead + (B, s.conv_width - 1, di), dt),
                    "bc": pm.meta(lead + (B, s.conv_width - 1,
                                          2 * s.d_state), dt)}

        g, t = (self.n_groups, self.group), (self.tail,)
        attn = (self.n_groups, B, T, kv, D)
        return {"attn_k": pm.meta(attn, dt), "attn_v": pm.meta(attn, dt),
                "group_ssm": ssm(g), "group_conv": conv(g),
                "tail_ssm": ssm(t), "tail_conv": conv(t),
                "pos": pm.meta((), torch.int32)}

    def cache_logical(self, shape: Optional[ShapeConfig]) -> Dict:
        return {"attn_k": tfm.CACHE_LOGICAL, "attn_v": tfm.CACHE_LOGICAL,
                "group_ssm": ("layers", "layers", "batch", "mamba_heads",
                              None, None),
                "group_conv": {"x": ("layers", "layers", "batch", None,
                                     "ffn"),
                               "bc": ("layers", "layers", "batch", None,
                                      None)},
                "tail_ssm": ("layers", "batch", "mamba_heads", None, None),
                "tail_conv": {"x": ("layers", "batch", None, "ffn"),
                              "bc": ("layers", "batch", None, None)},
                "pos": ()}

    def init_cache(self, shape: ShapeConfig,
                   device: DeviceLike = None) -> Dict:
        """A zero cache of ``cache_specs(shape)`` on ``device`` (default:
        the CUDA card)."""
        return pm.zeros_from(self.cache_specs(shape), resolve_device(device))
