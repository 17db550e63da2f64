"""Decoder-only transformer LM (dense / MoE / VLM) in PyTorch: the
counterpart of ``repro.models.transformer.DecoderLM``, for generation
and training.

Parameters are the reference's pytree: a nested dict whose per-layer
leaves are stacked on a leading ``(L, ...)`` axis, so
:func:`params_from_reference` carries the JAX parameters over as they
are.  The reference's ``lax.scan`` over layers is a Python loop over
that axis here.  Prefill attention runs the flash-attention kernel
(``layers.flash_attention``), decode attention the flash-decode kernel
(``layers.decode_attention_unsharded``).  An MoE config swaps each
layer's MLP for ``models.moe.moe_apply``; a VLM config prepends its
image patch embeddings, through the ``mm_proj`` projector, to the text.

Differences from the reference, each deliberate:

- GQA prefill: with no mesh the reference repeats K/V to all heads
  before its jnp attention; the kernel reads kv head ``h // G`` instead.
  The numbers are the same, and the cache holds the un-repeated K/V in
  both.
- Decode keeps ``pos`` a device int32 tensor and writes each new K/V
  into the cache in place (the reference returns updated copies):
  ``decode_step`` mutates ``cache["k"]`` and ``cache["v"]``.  It reads
  nothing back to the host; the engine reads back only the sampled
  token.
- Attention partials stay in fp32 (see ``layers``).

Training (``loss``) runs the reference's own differentiable attention,
``layers.flash_attention_blocked``, chosen by the ``train`` argument that
``loss`` passes through ``forward`` to ``_attention``: the CUDA kernels
have no backward (``kernels.ops.refuse_grad``).  Each layer is
checkpointed as ``cfg.remat`` says (``_remat``), the stacked leaves are
cut per layer by one ``unbind`` (``params.unstack``), and the CE runs in
checkpointed chunks of 1024 positions, as in the reference.
``input_specs`` and ``cache_specs`` give meta tensors, the counterpart
of ``jax.ShapeDtypeStruct``.

Serving on a mesh (``distributed.sharding.use_mesh`` with a DeviceMesh
and ``registry.make_rules``): each rank computes on its batch block and
its weight blocks, with explicit collectives where GSPMD partitions the
reference's math.  Prefill takes head-TP (each rank's heads, K/V
repeated to the padded heads as in the reference; the kernel on local
heads) or, when the heads do not divide the model axis, context
parallelism (``layers.context_parallel_attention``); the MLP is
Megatron-TP over ``ffn``, the MoE expert-parallel, the embedding
vocab-parallel.  Decode keeps the cache sequence-sharded over ``model``
(``layers.sharded_decode_attention``, the Fsum) and contracts the
attention weights on their ``model``-sharded d_model dims.  Parameters,
inputs and caches are DTensors or plain whole tensors; the logits come
back placed ``("batch", "seq", "vocab")`` and the cache as
``cache_logical`` says.

Training on a mesh (``train_loop.make_sharded_train_step``): ``loss``
takes the same branches with the blocked attention on the local heads
(head-TP) or the local rows (context parallelism), never a kernel; the
CE is vocab-parallel (``cross_entropy_mesh``: a pmax shift, a psum of
``sum(exp)`` and of the label's logit from the rank that owns it) and
its sum over this rank's batch block is psummed over the batch axes
before the division by the global count; the MoE aux covers every
rank's tokens.  The collectives are differentiated by their transposes
(``distributed.sharding``), so every rank's loss is the global one.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import params as pm
from repro_torch.models.params import Spec


def padded_vocab(v: int) -> int:
    return -(-v // 128) * 128


#: the matrix products whose outputs ``remat="dots"`` keeps, as
#: ``jax.checkpoint_policies.checkpoint_dots`` keeps every dot_general's
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default]


def _remat(fn: Callable, mode: str) -> Callable:
    """``fn`` checkpointed as the reference's ``_remat`` does: ``"full"``
    recomputes everything in the backward, ``"dots"`` keeps the matrix
    products' outputs and recomputes the rest, ``"none"`` keeps all.
    The recomputation runs under the mesh active here
    (``sharding.bind_mesh``)."""
    if mode == "none":
        return fn
    kw = {}
    if mode == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _DOTS)
    return functools.partial(checkpoint, shd.bind_mesh(fn),
                             use_reentrant=False, **kw)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_real: int) -> torch.Tensor:
    """Stable CE with padded-vocab masking, in fp32. logits (..., Vp)."""
    logits = logits.float()
    Vp = logits.shape[-1]
    if Vp > vocab_real:
        logits = torch.where(
            torch.arange(Vp, device=logits.device) < vocab_real, logits,
            -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    # the reference reduces a one-hot (not take_along_axis) only so that
    # a vocab-sharded logits dim partitions without an all-gather; with
    # no mesh a gather picks the same element, so the same bits, without
    # a pass over the (..., Vp) logits
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse - ll


def cross_entropy_mesh(logits: torch.Tensor, labels: torch.Tensor,
                       vocab_real: int, entry: shd.Entry) -> torch.Tensor:
    """:func:`cross_entropy` of logits whose vocab dim is sharded over
    ``entry`` (vocab-parallel): ``logits`` is this rank's (..., Vp/n)
    block at vocab offset ``i * Vp/n``.  A pmax of the block's max is
    the shift (no gradient flows through it: the logsumexp does not
    depend on it), a psum of ``sum(exp)`` gives the logsumexp, and the
    rank that owns each label's logit contributes it to a psum.  The
    padded-vocab mask reads the global vocab index."""
    logits = logits.float()
    i, _ = shd.entry_index(entry)
    Vl = logits.shape[-1]
    off = i * Vl
    col = off + torch.arange(Vl, device=logits.device)
    logits = torch.where(col < vocab_real, logits, -1e30)
    m = shd.pmax(logits.detach().amax(-1), entry)
    se = shd.psum(torch.exp(logits - m[..., None]).sum(-1), entry)
    lse = m + torch.log(se)
    t = labels.long() - off
    hit = (t >= 0) & (t < Vl)
    ll = logits.gather(-1, t.clamp(0, Vl - 1)[..., None])[..., 0]
    ll = shd.psum(torch.where(hit, ll, 0.0), entry)
    return lse - ll


def mean_ce_mesh(logits: torch.Tensor, labels: torch.Tensor,
                 vocab_real: int, vocab_entry: shd.Entry,
                 batch_entry: shd.Entry) -> torch.Tensor:
    """The mean CE over the global batch of a rank's logits block
    (its batch block over ``batch_entry``, its vocab block over
    ``vocab_entry``): :func:`cross_entropy_mesh` summed over the block,
    psummed over the batch axes, over the global count."""
    ce = cross_entropy_mesh(logits, labels, vocab_real, vocab_entry)
    return (shd.psum(ce.sum(), batch_entry)
            / (ce.numel() * shd.entry_index(batch_entry)[1]))


def place_kv_cache(c: torch.Tensor, batch: int) -> torch.Tensor:
    """A stacked (L, B, T, kv, D) cache of this rank's batch block,
    placed as ``CACHE_LOGICAL`` on the active mesh: the rank keeps its
    ``kv_seq`` slice of its block (``batch`` is the global batch)."""
    shape = (c.shape[0], batch) + tuple(c.shape[2:])
    sspec = shd.resolve_for_shape(("kv_seq",), (shape[2],))[0]
    i, n = shd.entry_index(sspec)
    t = shape[2] // n
    return shd.place_local(c.narrow(2, i * t, t).contiguous(), CACHE_LOGICAL,
                           shape)


def pad_cache(kv: torch.Tensor, cache_len: Optional[int],
              axis: int = 2) -> torch.Tensor:
    """Pad a stacked (L,B,S,...) prefill cache out to cache_len slots."""
    if cache_len is None or cache_len <= kv.shape[axis]:
        return kv
    pad = [0, 0] * (kv.dim() - 1 - axis) + [0, cache_len - kv.shape[axis]]
    return F.pad(kv, pad)


#: the KV cache's logical axes: sequence-sharded, every kv head
CACHE_LOGICAL = ("layers", "batch", "kv_seq", "cache_heads", "head_dim")

#: the attention table's small leaves and their names
_SMALL = {"bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
          "bv": ("kv_heads", "head_dim"), "q_norm": ("head_dim",),
          "k_norm": ("head_dim",), "w1": ("embed", None), "b1": (None,),
          "w2": (None, "embed"), "b2": ("embed",)}


def _local_small(p: dict) -> dict:
    """This rank's blocks of the biases and norms of an attention table
    (or of the VLM projector) under their names."""
    return {k: shd.local(v, *_SMALL[k]) for k, v in p.items() if k in _SMALL}


def _qkv_mesh(lp: dict, x: torch.Tensor):
    """Decode's q, k, v on a mesh: the weights' d_model dim is sharded
    (``attn_din``), so each rank contracts its slice of x against the
    three weights side by side and one psum sums the partials
    (``layers.psum_matmul``)."""
    names = {"wq": ("attn_din", "heads", "head_dim"),
             "wk": ("attn_din", "kv_heads", "head_dim"),
             "wv": ("attn_din", "kv_heads", "head_dim")}
    din = shd.spec(lp["wq"], *names["wq"])[0]
    i, n = shd.entry_index(din)
    step = x.shape[-1] // n
    xs = x.narrow(-1, i * step, step)
    ws = [shd.local(lp[w], *names[w]) for w in names]
    sizes = [w.shape[1] for w in ws]
    cat = torch.cat([w.flatten(1) for w in ws], dim=-1)
    out = L.psum_matmul(xs, cat, din).unflatten(-1, (sum(sizes), -1))
    return out.split(sizes, dim=-2)


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def params_from_reference(tree: Any, device: DeviceLike = None) -> Any:
    """Convert a reference parameter tree (nested dicts of numpy arrays,
    e.g. ``jax.tree.map(np.asarray, params)``; bf16 arrives as the
    ``ml_dtypes`` bfloat16 numpy type) into the port's tensors on
    ``device`` (default: the CUDA card), with the same dtypes."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":        # numpy has no bf16 of its own
            bits = torch.from_numpy(a.view(np.int16).copy())
            return bits.view(torch.bfloat16).to(dev)
        return torch.from_numpy(np.array(a)).to(dev)

    return pm.tree_map(leaf, tree)


class DecoderLM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.vp = padded_vocab(cfg.vocab_size)

    # ------------------------------------------------------------ params
    def _layer_table(self) -> dict:
        cfg = self.cfg
        t = {
            "ln1": L.norm_table(cfg.d_model),
            "attn": L.attn_table(cfg),
            "ln2": L.norm_table(cfg.d_model),
        }
        if cfg.moe is not None:
            t["moe"] = moe_mod.moe_table(cfg)
        else:
            t["mlp"] = L.mlp_table(cfg.d_model, cfg.d_ff)
        return t

    def _top_table(self) -> dict:
        cfg = self.cfg
        t = {
            "embed": L.embed_table(self.vp, cfg.d_model),
            "final_norm": L.norm_table(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            t["head"] = L.head_table(self.vp, cfg.d_model)
        if cfg.family == "vlm":
            d = cfg.d_model
            t["mm_proj"] = {
                "w1": Spec((d, d), ("embed", None)),
                "b1": Spec((d,), (None,), "zeros"),
                "w2": Spec((d, d), (None, "embed")),
                "b2": Spec((d,), ("embed",), "zeros"),
            }
        return t

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict:
        """Random parameters in ``cfg.param_dtype`` drawn from one
        ``torch.Generator`` seeded with ``seed`` on ``device`` (default:
        the CUDA card).  The draws follow the reference's distributions,
        not its numbers: JAX's PRNG is its own."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dt = _dtype(self.cfg.param_dtype)
        params = pm.init_table(gen, self._top_table(), dt, dev)
        params["layers"] = pm.init_table(gen, self._layer_table(), dt, dev,
                                         stack=self.cfg.num_layers)
        return params

    def param_specs(self) -> Dict:
        specs = pm.table_specs(self._top_table())
        specs["layers"] = pm.table_specs(self._layer_table(),
                                         prefix=("layers",))
        return specs

    def param_shapes(self, dtype: Optional[torch.dtype] = None) -> Dict:
        dt = dtype or _dtype(self.cfg.param_dtype)
        shapes = pm.shape_tree(self._top_table(), dt)
        shapes["layers"] = pm.shape_tree(self._layer_table(), dt,
                                         stack=self.cfg.num_layers)
        return shapes

    def param_count(self) -> int:
        n = pm.table_size(self._top_table())
        n += pm.table_size(self._layer_table()) * self.cfg.num_layers
        return n

    # ----------------------------------------------------------- forward
    def _attention(self, lp, x, pos, train: bool = False):
        """-> (out, (k, v)); ``train`` takes the differentiable blocked
        attention, else the kernel."""
        cfg = self.cfg
        if shd.device_mesh() is not None:
            return self._attention_mesh(lp, x, pos, train)
        q, k, v = L._project_qkv(lp, x, cfg, pos)
        kv = (k, v)
        o = self._local_attention(q, k, v, train)
        mask = L.head_mask(cfg, o.dtype, o.device)
        if mask is not None:
            o = o * mask[None, None, :, None]
        out = o.flatten(-2) @ lp["wo"].flatten(0, 1)
        return out, kv

    def _attention_mesh(self, lp, x, pos, train: bool = False, kv_src=None,
                        causal: bool = True, keep_kv: bool = True):
        """Prefill (or train) attention on a mesh: this rank's heads under
        head-TP, its query rows under context parallelism; the cache's
        K/V with every kv head.  ``train`` takes the blocked attention
        where serving takes the kernel.  ``kv_src`` (whisper's encoder
        output) gives the K/V in place of ``x``, ``pos`` None skips rope,
        and with ``keep_kv`` False no K/V is returned, so that under
        head-TP with the kv heads cut as the heads a rank keeps its own
        and gathers none."""
        cfg = self.cfg
        Hp, Hkv = cfg.padded_heads, cfg.num_kv_heads
        hspec = shd.resolve_for_shape(("heads",), (Hp,))[0]
        kvspec = shd.resolve_for_shape(("kv_heads",), (Hkv,))[0]
        src = x if kv_src is None else kv_src
        q = L.mesh_heads(x, lp["wq"], ("attn_din_c", "heads", "head_dim"))
        k = L.mesh_heads(src, lp["wk"], ("attn_din_c", "kv_heads",
                                         "head_dim"))
        v = L.mesh_heads(src, lp["wv"], ("attn_din_c", "kv_heads",
                                         "head_dim"))
        q, k, v = L._finish_qkv(_local_small(lp), q, k, v, cfg, pos)
        own = not keep_kv and hspec is not None and kvspec == hspec
        if not own:
            k, v = shd.all_gather(k, kvspec, 2), shd.all_gather(v, kvspec, 2)
        kv = (k, v) if keep_kv else None
        i, n = shd.entry_index(hspec)
        if hspec is not None:
            # GQA + head-TP: expand kv to the (padded) heads, then this
            # rank's (its own kv heads' groups are already its heads):
            # the kernel runs on its local heads
            G, h = Hp // Hkv, Hp // n
            k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
            if not own:
                k, v = k.narrow(2, i * h, h), v.narrow(2, i * h, h)
            o = self._local_attention(q, k.contiguous(), v.contiguous(),
                                      train, causal)
        elif L.use_context_parallel(shd.device_mesh(), q.shape[1]):
            o = L.context_parallel_attention(q, k, v, causal=causal)
        else:
            o = self._local_attention(q, k, v, train, causal)
        mask = L.head_mask(cfg, o.dtype, o.device)
        if mask is not None:
            mask = mask.narrow(0, i * (Hp // n), Hp // n)
            o = o * mask[None, None, :, None]
        out = L.mesh_out(o, lp["wo"], ("heads", "head_dim", "attn_dout_c"))
        return out, kv

    @staticmethod
    def _local_attention(q, k, v, train: bool, causal: bool = True):
        """Attention on this device's (or rank's) heads: the blocked
        attention in training (the kernel has no backward), else the
        kernel in q's and k's promoted dtype (whisper's bf16 q meets its
        fp32 encoder's K/V), its output in q's."""
        if train:
            return L.flash_attention_blocked(
                q, k, v, causal=causal, q_block=min(512, q.shape[1]),
                kv_block=min(1024, k.shape[1]))
        dt = torch.promote_types(q.dtype, k.dtype)
        return L.flash_attention(q.to(dt), k.to(dt), v.to(dt),
                                 causal=causal).to(q.dtype)

    def _ffn(self, lp, hn, batch_entry: shd.Entry = None,
             train: bool = False):
        """The layer's MLP, or its MoE FFN -> (out, aux loss).  On a
        mesh ``hn`` is this rank's batch block, sharded over
        ``batch_entry``."""
        if self.cfg.moe is not None:
            return moe_mod.moe_apply(lp["moe"], hn, self.cfg,
                                     batch_entry=batch_entry, train=train)
        return L.mesh_mlp(lp["mlp"], hn), 0.0

    def _layer(self, lp, x, pos, train: bool = False,
               batch_entry: shd.Entry = None):
        cfg = self.cfg
        h, kv = self._attention(
            lp["attn"], L.rmsnorm(x, shd.local(lp["ln1"], "embed"),
                                  cfg.norm_eps), pos, train)
        x = x + h
        h2, aux = self._ffn(lp, L.rmsnorm(x, shd.local(lp["ln2"], "embed"),
                                          cfg.norm_eps), batch_entry, train)
        return x + h2, kv, aux

    def _layers(self, params) -> list:
        """The per-layer parameter trees (DTensors on a mesh)."""
        return L.unstack(params["layers"], self.cfg.num_layers)

    def _batch_entry(self, batch) -> shd.Entry:
        """The mesh axes the batch block is sharded over (None without
        a mesh, or when the batch does not divide them)."""
        mesh = shd.device_mesh()
        if mesh is None:
            return None
        return L.batch_pspec_entry(batch["tokens"].shape[0], mesh)

    def _embed_inputs(self, params, batch) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        cfg = self.cfg
        x = L.mesh_embed(params["embed"], batch["tokens"])
        if cfg.family == "vlm":
            mp = _local_small(params["mm_proj"])
            img = shd.local(batch["images"], "batch", None, None).to(x.dtype)
            img = torch.tanh(img @ mp["w1"] + mp["b1"]) @ mp["w2"] + mp["b2"]
            x = torch.cat([img, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x, pos

    def forward(self, params, batch, train: bool = False):
        """Full-sequence hidden states after the final norm, and the MoE
        aux loss summed over layers (0.0 without MoE).  ``train`` runs
        the differentiable attention and checkpoints each layer as
        ``cfg.remat`` says."""
        cfg = self.cfg
        x, pos = self._embed_inputs(params, batch)
        be = self._batch_entry(batch)

        def body(lp, x):
            y, _, aux = self._layer(lp, x, pos, train, be)
            return y, aux

        body = _remat(body, cfg.remat if train else "none")
        total = 0.0
        for lp in self._layers(params):
            x, aux = body(lp, x)
            total = total + aux
        return L.rmsnorm(x, shd.local(params["final_norm"], "embed"),
                         cfg.norm_eps), total

    def _logits(self, params, x):
        """Logits over the vocab; on a mesh over this rank's vocab block."""
        if self.cfg.tie_embeddings:
            return L.unembed(x, shd.local(params["embed"], "vocab", "embed"),
                             tied=True)
        return L.unembed(x, shd.local(params["head"], "embed", "vocab"),
                         tied=False)

    def _vocab_entry(self, params) -> shd.Entry:
        """The mesh axes the logits' vocab dim is sharded over (None
        without a mesh)."""
        if shd.device_mesh() is None:
            return None
        if self.cfg.tie_embeddings:
            return shd.spec(params["embed"], "vocab", "embed")[0]
        return shd.spec(params["head"], "embed", "vocab")[1]

    def _place_logits(self, batch, logits):
        """On a mesh, this rank's logits block placed ("batch", "seq",
        "vocab"); the logits themselves without one."""
        if shd.device_mesh() is None:
            return logits
        shape = (batch["tokens"].shape[0],) + tuple(logits.shape[1:-1]) + (
            self.vp,)
        return shd.place_local(logits, ("batch", "seq", "vocab"), shape)

    def mean_ce(self, params, x, batch) -> torch.Tensor:
        """The mean next-token CE of hidden states ``x`` against
        ``batch["labels"]``, unchunked and unmasked (whisper's, zamba2's
        and rwkv6's loss); on a mesh vocab-parallel over the global
        batch (:func:`mean_ce_mesh`)."""
        logits = self._logits(params, x)
        if shd.device_mesh() is None:
            return cross_entropy(logits, batch["labels"],
                                 self.cfg.vocab_size).mean()
        return mean_ce_mesh(logits, shd.local(batch["labels"], "batch", None),
                            self.cfg.vocab_size, self._vocab_entry(params),
                            self._batch_entry(batch))

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE (over ``loss_mask`` when the batch has one;
        a VLM's text positions only), plus the MoE router aux loss."""
        cfg = self.cfg
        x, aux = self.forward(params, batch, train=True)
        on_mesh = shd.device_mesh() is not None
        be = self._batch_entry(batch)
        labels = shd.local(batch["labels"], "batch", None)
        mask = batch.get("loss_mask")
        if mask is not None:
            mask = shd.local(mask, "batch", None)
        if cfg.family == "vlm":  # loss only over text positions
            x = x[:, -labels.shape[1]:]

        def ce_of(xc, lc):
            if on_mesh:
                return cross_entropy_mesh(self._logits(params, xc), lc,
                                          cfg.vocab_size,
                                          self._vocab_entry(params))
            return cross_entropy(self._logits(params, xc), lc,
                                 cfg.vocab_size)

        # CE in chunks of positions to bound the fp32 logits, each chunk
        # checkpointed: its logits are otherwise kept for the backward
        S = x.shape[1]
        chunk = min(1024, S)
        nc = S // chunk if S % chunk == 0 else 1
        if nc > 1:
            ce_of = shd.bind_mesh(ce_of)
            ce = torch.cat([
                checkpoint(ce_of, x[:, c * chunk:(c + 1) * chunk],
                           labels[:, c * chunk:(c + 1) * chunk],
                           use_reentrant=False) for c in range(nc)], dim=1)
        else:
            ce = ce_of(x, labels)
        # on a mesh the sums run over this rank's batch block, then a
        # psum over the batch axes gives every rank the global ones
        if mask is not None:
            mask = mask.to(torch.float32)
            ce = ce * mask
            msum = shd.psum(mask.sum(), be) if on_mesh else mask.sum()
            denom = msum.clamp(min=1.0)
        else:
            denom = ce.numel() * (shd.entry_index(be)[1] if on_mesh else 1)
        total = (shd.psum(ce.sum(), be) if on_mesh else ce.sum()) / denom
        if cfg.moe is not None:
            total = total + cfg.moe.router_aux_loss * aux
        return total

    # ----------------------------------------------------------- serving
    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Full-sequence forward; returns (last_logits, cache).

        cache_len pads the emitted KV cache beyond the prompt so decode
        steps have room (defaults to prompt length).
        """
        cfg = self.cfg
        dt = _dtype(cfg.dtype)
        x, pos = self._embed_inputs(params, batch)
        be = self._batch_entry(batch)
        ks, vs = [], []
        for lp in self._layers(params):
            x, (k, v), _ = self._layer(lp, x, pos, batch_entry=be)
            ks.append(k.to(dt))
            vs.append(v.to(dt))
        x = L.rmsnorm(x, shd.local(params["final_norm"], "embed"),
                      cfg.norm_eps)
        logits = self._logits(params, x[:, -1:, :])
        cache = {"k": pad_cache(torch.stack(ks), cache_len),
                 "v": pad_cache(torch.stack(vs), cache_len),
                 "pos": torch.full((), x.shape[1] - 1, dtype=torch.int32,
                                   device=x.device)}
        if shd.device_mesh() is not None:
            # this rank keeps its kv_seq slice of its batch block's cache
            B = batch["tokens"].shape[0]
            for name in ("k", "v"):
                cache[name] = place_kv_cache(cache[name], B)
            cache["pos"] = shd.place_local(cache["pos"], (), ())
        return self._place_logits(batch, logits), cache

    def _decode_attention(self, lp, x, pos, kc, vc, seq_entry=None):
        """x: (B,1,d); kc/vc: (B,T,kv,D), updated in place; on a mesh
        this rank's slice of a cache sharded on T over ``seq_entry``."""
        cfg = self.cfg
        if shd.device_mesh() is None:
            q, k, v = L._project_qkv(lp, x, cfg, pos[None])
        else:
            if shd.spec(lp["wq"], "attn_din", "heads", "head_dim")[1]:
                raise ValueError("decode on a mesh takes the heads whole "
                                 "(registry.make_rules' decode rules)")
            q, k, v = _qkv_mesh(lp, x)
            q, k, v = L._finish_qkv(_local_small(lp), q, k, v, cfg, pos[None])
        q, k, v = q[:, 0], k[:, 0], v[:, 0]          # (B,H,D)/(B,kv,D)
        if seq_entry is not None:
            o, kc, vc = L.sharded_decode_attention(q, kc, vc, k, v, pos,
                                                   seq_entry)
        else:
            o, kc, vc = L.decode_attention_unsharded(q, kc, vc, k, v, pos)
        mask = L.head_mask(cfg, o.dtype, o.device)
        if mask is not None:
            o = o * mask[None, :, None]
        out = L.mesh_out(o, lp["wo"],
                         ("heads", "head_dim", "attn_dout"))[:, None, :]
        return out, kc, vc

    def decode_step(self, params, cache, batch):
        """One token for the whole batch. batch: {"tokens": (B,1)}.

        Writes the new K/V into ``cache["k"]``/``cache["v"]`` in place
        and returns (logits, {"k", "v", "pos"}) with the same buffers and
        the advanced device ``pos``."""
        cfg = self.cfg
        mesh = shd.device_mesh()
        x = L.mesh_embed(params["embed"], batch["tokens"])
        pos = shd.local(cache["pos"]) + 1
        ks = shd.local(cache["k"], *CACHE_LOGICAL)
        vs = shd.local(cache["v"], *CACHE_LOGICAL)
        se = (None if mesh is None else
              shd.resolve_for_shape(("kv_seq",), (cache["k"].shape[2],))[0])
        be = self._batch_entry(batch)
        for i, lp in enumerate(self._layers(params)):
            h = L.rmsnorm(x, shd.local(lp["ln1"], "embed"), cfg.norm_eps)
            h, _, _ = self._decode_attention(lp["attn"], h, pos, ks[i], vs[i],
                                             se)
            x = x + h
            h2, _ = self._ffn(lp, L.rmsnorm(x, shd.local(lp["ln2"], "embed"),
                                            cfg.norm_eps), be)
            x = x + h2
        x = L.rmsnorm(x, shd.local(params["final_norm"], "embed"),
                      cfg.norm_eps)
        logits = self._place_logits(batch, self._logits(params, x))
        if mesh is not None:
            ks, vs = (c if isinstance(c, DTensor) else shd.place_local(
                loc, CACHE_LOGICAL, c.shape)
                for c, loc in ((cache["k"], ks), (cache["v"], vs)))
            pos = shd.place_local(pos, (), ())
        return logits, {"k": ks, "v": vs, "pos": pos}

    # ------------------------------------------------------------- specs
    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The batch of a ``shape`` cell as meta tensors."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": pm.meta((B, 1), torch.int32)}
        n_img = cfg.vlm.num_patches if cfg.family == "vlm" else 0
        spec = {"tokens": pm.meta((B, S - n_img), torch.int32)}
        if shape.kind == "train":
            spec["labels"] = pm.meta((B, S - n_img), torch.int32)
        if n_img:
            spec["images"] = pm.meta((B, n_img, cfg.d_model),
                                     _dtype(cfg.dtype))
        return spec

    def input_logical(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        out = {"tokens": ("batch", None)}
        if shape.kind == "train":
            out["labels"] = ("batch", None)
        if self.cfg.family == "vlm" and shape.kind in ("train", "prefill"):
            out["images"] = ("batch", None, None)
        return out

    def cache_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, T = shape.global_batch, shape.seq_len
        kv = (cfg.num_layers, B, T, cfg.num_kv_heads, cfg.resolved_head_dim)
        dt = _dtype(cfg.dtype)
        return {"k": pm.meta(kv, dt), "v": pm.meta(kv, dt),
                "pos": pm.meta((), torch.int32)}

    def cache_logical(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        return {"k": CACHE_LOGICAL, "v": CACHE_LOGICAL, "pos": ()}

    def init_cache(self, shape: ShapeConfig,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """A zero cache of ``cache_specs(shape)`` on ``device`` (default:
        the CUDA card)."""
        return pm.zeros_from(self.cache_specs(shape), resolve_device(device))
