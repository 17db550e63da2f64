"""Whisper-large-v3 backbone, encoder-decoder, in PyTorch: the
counterpart of ``repro.models.whisper.WhisperModel``, for generation
and training.

As in the reference, the conv/mel frontend is a stub (the caller passes
frame embeddings ``(B, 1500, d_model)``), the decoder uses RoPE in place
of the original learned position table, and the cross-attention K/V are
computed once at prefill and cached.  Every attention runs the kernels:
the encoder's (non-causal, S = T = 1500), the decoder's self-attention
(causal) and its cross-attention (non-causal over the encoder's rows)
through ``layers.flash_attention`` at prefill; at decode the
self-attention through ``DecoderLM._decode_attention`` and the
cross-attention through ``layers.decode_attention_local`` over the
whole cross cache, with a device ``pos`` of ``encoder_seq`` (past the
last row, as the reference's Python int is).

Dtypes follow JAX's promotion: fp32 frames (the CLI sends them) meet
bf16 weights in fp32 (``layers.matmul``), so the encoder and the cross
K/V run in fp32; the prefill cross-attention casts its bf16 q and fp32
K/V to the promoted dtype for the one-dtype kernel and its output back
to q's, as ``flash_attention_jnp`` returns q's dtype.  The caches hold
``cfg.dtype``.  Decode writes the self-attention cache in place, as
``DecoderLM`` does; the cross cache is never written.

``loss`` (mean CE over the decoder's positions, unchunked as in the
reference) runs all three attentions through the differentiable
``layers.flash_attention_blocked``, which takes the mixed dtypes as the
reference's jnp attention does; each encoder and decoder layer is
checkpointed as ``cfg.remat`` says.

On a mesh (``distributed.sharding.use_mesh`` with a DeviceMesh and
``registry.make_rules``) each rank computes on its batch block.  Every
prefill (and training) attention, the encoder's, the decoder's self-
and its cross-attention, is ``DecoderLM._attention_mesh`` (``kv_src``
the encoder output for the cross-attention, no rope where ``pos`` is
None): head-TP when the heads divide ``model`` (the kernel on this
rank's heads; the encoder keeps no K/V, so it gathers none) and
otherwise FSDP with context parallelism over the query rows
(``layers.context_parallel_attention``), as the reference's ``_attn``
does; the MLPs are Megatron over ``ffn``.  The residual stream stays
whole on each rank, so the encoder output is there once for every
decoder layer, as the reference gathers it once.  At decode the
self-attention takes ``DecoderLM``'s sequence-sharded cache, the
cross-attention's q the decode rules' contraction over ``model``, and
the rank's batch block of the whole-head cross cache.  The tied
embedding is vocab-parallel (lookup, unembed and CE).

The cache hand-off differs from the reference's on a mesh: the
reference's prefill leaves the cross cache with its kv heads on
``model`` (the prefill rules) and its decode program refuses that
layout; the port's prefill emits every leaf in the layout that the
decode rules give ``cache_logical`` (the cross cache batch-blocked
with every head), so a prefill's cache feeds decode as it is.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed import sharding as shd
from repro_torch.models import layers as L
from repro_torch.models import params as pm
from repro_torch.models import transformer as tfm


def _enc_layer_table(cfg):
    return {
        "ln1": L.norm_table(cfg.d_model),
        "attn": L.attn_table(cfg),
        "ln2": L.norm_table(cfg.d_model),
        "mlp": L.mlp_table(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_table(cfg):
    return {
        "ln1": L.norm_table(cfg.d_model),
        "self_attn": L.attn_table(cfg),
        "ln_x": L.norm_table(cfg.d_model),
        "cross_attn": L.attn_table(cfg),
        "ln2": L.norm_table(cfg.d_model),
        "mlp": L.mlp_table(cfg.d_model, cfg.d_ff),
    }


#: the cross cache's names as the port's prefill emits it: the layout
#: the decode rules give ``cache_logical``'s (kv heads whole)
CROSS_DECODE = ("layers", "batch", None, None, "head_dim")


def _sinusoid(S: int, d: int, device) -> torch.Tensor:
    """(S, d) fp32 sinusoidal positions: sines then cosines."""
    pos = torch.arange(S, device=device, dtype=torch.float32)[:, None]
    i = torch.arange(d // 2, device=device, dtype=torch.float32)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * i / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class WhisperModel:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.vp = tfm.padded_vocab(cfg.vocab_size)
        self._lm = tfm.DecoderLM(cfg)

    def _top_table(self):
        return {
            "embed": L.embed_table(self.vp, self.cfg.d_model),
            "enc_norm": L.norm_table(self.cfg.d_model),
            "final_norm": L.norm_table(self.cfg.d_model),
        }

    def init(self, seed: int = 0, device: DeviceLike = None) -> Dict:
        """Random parameters in ``cfg.param_dtype`` from one
        ``torch.Generator`` seeded with ``seed`` on ``device`` (default:
        the CUDA card): the reference's distributions, not its numbers."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        dt = tfm._dtype(cfg.param_dtype)
        params = pm.init_table(gen, self._top_table(), dt, dev)
        params["enc_layers"] = pm.init_table(
            gen, _enc_layer_table(cfg), dt, dev,
            stack=cfg.encdec.num_encoder_layers)
        params["dec_layers"] = pm.init_table(
            gen, _dec_layer_table(cfg), dt, dev, stack=cfg.num_layers)
        return params

    def param_specs(self) -> Dict:
        """The logical-name tree of the parameters (``optimizer.
        state_specs`` and the mesh placement read it)."""
        specs = pm.table_specs(self._top_table())
        specs["enc_layers"] = pm.table_specs(_enc_layer_table(self.cfg),
                                             prefix=("layers",))
        specs["dec_layers"] = pm.table_specs(_dec_layer_table(self.cfg),
                                             prefix=("layers",))
        return specs

    def param_shapes(self, dtype: Optional[torch.dtype] = None) -> Dict:
        cfg = self.cfg
        dt = dtype or tfm._dtype(cfg.param_dtype)
        shapes = pm.shape_tree(self._top_table(), dt)
        shapes["enc_layers"] = pm.shape_tree(
            _enc_layer_table(cfg), dt, stack=cfg.encdec.num_encoder_layers)
        shapes["dec_layers"] = pm.shape_tree(
            _dec_layer_table(cfg), dt, stack=cfg.num_layers)
        return shapes

    def param_count(self) -> int:
        cfg = self.cfg
        return (pm.table_size(self._top_table())
                + pm.table_size(_enc_layer_table(cfg))
                * cfg.encdec.num_encoder_layers
                + pm.table_size(_dec_layer_table(cfg)) * cfg.num_layers)

    # --------------------------------------------------------------- enc
    def encode(self, params, frames: torch.Tensor,
               train: bool = False) -> torch.Tensor:
        """The encoder's output; on a mesh ``frames`` is the global
        batch and the output this rank's batch block."""
        cfg = self.cfg
        frames = shd.local(frames, "batch", None, None)
        x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                               frames.device).to(frames.dtype)

        def body(lp, x):
            h, _ = self._attn(lp["attn"], self._norm(lp["ln1"], x),
                              causal=False, train=train, keep_kv=False)
            x = x + h
            return x + L.mesh_mlp(lp["mlp"], self._norm(lp["ln2"], x))

        body = tfm._remat(body, cfg.remat if train else "none")
        for lp in L.unstack(params["enc_layers"],
                            cfg.encdec.num_encoder_layers):
            x = body(lp, x)
        return self._norm(params["enc_norm"], x)

    def _norm(self, scale, x: torch.Tensor) -> torch.Tensor:
        return L.rmsnorm(x, shd.local(scale, "embed"), self.cfg.norm_eps)

    def _attn(self, ap, x, causal: bool, kv_src=None, pos=None,
              train: bool = False, keep_kv: bool = True):
        """Self or cross attention (kv_src = encoder output for cross)
        -> (out, (k, v)); ``train`` takes the differentiable blocked
        attention, else the kernel.  On a mesh it is
        ``DecoderLM._attention_mesh`` (no K/V returned without
        ``keep_kv``)."""
        cfg = self.cfg
        if shd.device_mesh() is not None:
            return self._lm._attention_mesh(ap, x, pos, train, kv_src=kv_src,
                                            causal=causal, keep_kv=keep_kv)
        src = x if kv_src is None else kv_src
        q = L._heads(x, ap["wq"])
        k = L._heads(src, ap["wk"])
        v = L._heads(src, ap["wv"])
        if pos is not None:
            q = L.rope(q, pos, cfg.rope_theta)
            k = L.rope(k, pos, cfg.rope_theta)
        o = self._lm._local_attention(q, k, v, train, causal)
        out = L.matmul(o.flatten(-2), ap["wo"].flatten(0, 1))
        return out, (k, v)

    # --------------------------------------------------------------- dec
    def _dec_layer(self, lp, x, enc, pos, train: bool = False):
        """-> (x, self K/V, cross K/V); on a mesh training returns no
        K/V (None)."""
        h, kv = self._attn(lp["self_attn"], self._norm(lp["ln1"], x),
                           causal=True, pos=pos, train=train,
                           keep_kv=not train)
        x = x + h
        h, cross_kv = self._attn(lp["cross_attn"], self._norm(lp["ln_x"], x),
                                 causal=False, kv_src=enc, train=train,
                                 keep_kv=not train)
        x = x + h
        x = x + L.mesh_mlp(lp["mlp"], self._norm(lp["ln2"], x))
        return x, kv, cross_kv

    def forward(self, params, batch, train: bool = False) -> torch.Tensor:
        """Full-sequence decoder hidden states after the final norm.
        ``train`` runs the differentiable attention and checkpoints each
        layer as ``cfg.remat`` says."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"], train)
        x = L.mesh_embed(params["embed"], batch["tokens"])
        pos = torch.arange(x.shape[1], device=x.device)

        def body(lp, x):
            return self._dec_layer(lp, x, enc, pos, train)[0]

        body = tfm._remat(body, cfg.remat if train else "none")
        for lp in L.unstack(params["dec_layers"], cfg.num_layers):
            x = body(lp, x)
        return self._norm(params["final_norm"], x)

    def loss(self, params, batch) -> torch.Tensor:
        """Mean next-token CE over the decoder's positions; on a mesh
        vocab-parallel over the global batch (``DecoderLM.mean_ce``)."""
        return self._lm.mean_ce(params, self.forward(params, batch, True),
                                batch)

    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Encode the frames, run the decoder over the prompt -> (last
        logits, cache with the self-attention K/V padded to cache_len
        and the cross-attention K/V)."""
        cfg = self.cfg
        dt = tfm._dtype(cfg.dtype)
        enc = self.encode(params, batch["frames"])
        x = L.mesh_embed(params["embed"], batch["tokens"])
        S = x.shape[1]
        pos = torch.arange(S, device=x.device)
        ks, vs, cks, cvs = [], [], [], []
        for lp in L.unstack(params["dec_layers"], cfg.num_layers):
            x, (k, v), (ck, cv) = self._dec_layer(lp, x, enc, pos)
            ks.append(k.to(dt))
            vs.append(v.to(dt))
            cks.append(ck.to(dt))
            cvs.append(cv.to(dt))
        x = self._norm(params["final_norm"], x)
        logits = self._lm._logits(params, x[:, -1:])
        cache = {
            "k": tfm.pad_cache(torch.stack(ks), cache_len),
            "v": tfm.pad_cache(torch.stack(vs), cache_len),
            "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs),
            "pos": torch.full((), S - 1, dtype=torch.int32,
                              device=x.device),
        }
        if shd.device_mesh() is not None:
            # the layouts decode takes: the self cache's kv_seq slice,
            # the cross cache's batch block with every head
            B = batch["tokens"].shape[0]
            for name in ("k", "v"):
                cache[name] = tfm.place_kv_cache(cache[name], B)
            for name in ("cross_k", "cross_v"):
                c = cache[name]
                cache[name] = shd.place_local(
                    c, CROSS_DECODE, (c.shape[0], B) + tuple(c.shape[2:]))
            cache["pos"] = shd.place_local(cache["pos"], (), ())
        return self._lm._place_logits(batch, logits), cache

    def decode_step(self, params, cache, batch):
        """One token for the whole batch. batch: {"tokens": (B,1)}.
        Writes the new self-attention K/V into ``cache["k"]``/``["v"]``
        in place and returns (logits, cache with the advanced ``pos``)."""
        cfg = self.cfg
        mesh = shd.device_mesh()
        x = L.mesh_embed(params["embed"], batch["tokens"])
        pos = shd.local(cache["pos"]) + 1
        ks = shd.local(cache["k"], *tfm.CACHE_LOGICAL)
        vs = shd.local(cache["v"], *tfm.CACHE_LOGICAL)
        cks = shd.local(cache["cross_k"], *CROSS_DECODE)
        cvs = shd.local(cache["cross_v"], *CROSS_DECODE)
        se = (None if mesh is None else shd.resolve_for_shape(
            ("kv_seq",), (cache["k"].shape[2],))[0])
        # every cross-cache row is live: the reference's Python int
        # ``ck.shape[1]``, here filled on the device (no host copy)
        cross_pos = torch.full((), cks.shape[2], dtype=torch.int32,
                               device=x.device)
        for i, lp in enumerate(L.unstack(params["dec_layers"],
                                         cfg.num_layers)):
            h = self._norm(lp["ln1"], x)
            h, _, _ = self._lm._decode_attention(lp["self_attn"], h, pos,
                                                 ks[i], vs[i], se)
            x = x + h
            h = self._norm(lp["ln_x"], x)
            # on a mesh the decode rules: d_model on ``model``, heads whole
            q = L.mesh_heads(h, lp["cross_attn"]["wq"],
                             ("attn_din", "heads", "head_dim"))[:, 0]
            o, l, m = L.decode_attention_local(q, cks[i], cvs[i], cross_pos)
            o = L.combine_partials(o, l, m).to(q.dtype)
            x = x + L.mesh_out(o, lp["cross_attn"]["wo"],
                               ("heads", "head_dim", "attn_dout"))[:, None]
            x = x + L.mesh_mlp(lp["mlp"], self._norm(lp["ln2"], x))
        x = self._norm(params["final_norm"], x)
        logits = self._lm._place_logits(batch, self._lm._logits(params, x))
        if mesh is None:
            return logits, dict(cache, k=ks, v=vs, pos=pos)
        # the cache's own DTensors hold the writes
        kvs = {n: c if isinstance(c, DTensor) else shd.place_local(
            loc, tfm.CACHE_LOGICAL, c.shape)
            for n, c, loc in (("k", cache["k"], ks), ("v", cache["v"], vs))}
        return logits, dict(cache, **kvs, pos=shd.place_local(pos, (), ()))

    # ------------------------------------------------------------- specs
    def input_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        """The batch of a ``shape`` cell as meta tensors."""
        cfg = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": pm.meta((B, 1), torch.int32)}
        spec = {"frames": pm.meta((B, cfg.encdec.encoder_seq, cfg.d_model),
                                  tfm._dtype(cfg.dtype)),
                "tokens": pm.meta((B, S), torch.int32)}
        if shape.kind == "train":
            spec["labels"] = pm.meta((B, S), torch.int32)
        return spec

    def input_logical(self, shape: ShapeConfig) -> Dict[str, Tuple]:
        out = {"tokens": ("batch", None)}
        if shape.kind in ("train", "prefill"):
            out["frames"] = ("batch", None, None)
        if shape.kind == "train":
            out["labels"] = ("batch", None)
        return out

    def cache_specs(self, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B, T = shape.global_batch, shape.seq_len
        kv, D = cfg.num_kv_heads, cfg.resolved_head_dim
        E = cfg.encdec.encoder_seq
        dt = tfm._dtype(cfg.dtype)
        s = (cfg.num_layers, B, T, kv, D)
        c = (cfg.num_layers, B, E, kv, D)
        return {"k": pm.meta(s, dt), "v": pm.meta(s, dt),
                "cross_k": pm.meta(c, dt), "cross_v": pm.meta(c, dt),
                "pos": pm.meta((), torch.int32)}

    def cache_logical(self, shape: Optional[ShapeConfig]) -> Dict[str, Tuple]:
        cross = ("layers", "batch", None, "kv_heads", "head_dim")
        return {"k": tfm.CACHE_LOGICAL, "v": tfm.CACHE_LOGICAL,
                "cross_k": cross, "cross_v": cross, "pos": ()}

    def init_cache(self, shape: ShapeConfig,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """A zero cache of ``cache_specs(shape)`` on ``device`` (default:
        the CUDA card)."""
        return pm.zeros_from(self.cache_specs(shape), resolve_device(device))
