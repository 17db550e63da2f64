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
checkpointed as ``cfg.remat`` says.  The mesh branches (context
parallelism in the encoder) wait for ROADMAP Queue 1 item 8c.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
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
        state_specs`` reads it); its mesh branches wait for ROADMAP
        Queue 1 item 8c."""
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
        cfg = self.cfg
        x = frames + _sinusoid(frames.shape[1], cfg.d_model,
                               frames.device).to(frames.dtype)

        def body(lp, x):
            h, _ = self._attn(lp["attn"],
                              L.rmsnorm(x, lp["ln1"], cfg.norm_eps),
                              causal=False, train=train)
            x = x + h
            return x + L.mlp_apply(lp["mlp"],
                                   L.rmsnorm(x, lp["ln2"], cfg.norm_eps))

        body = tfm._remat(body, cfg.remat if train else "none")
        for lp in pm.unstack(params["enc_layers"],
                             cfg.encdec.num_encoder_layers):
            x = body(lp, x)
        return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)

    def _attn(self, ap, x, causal: bool, kv_src=None, pos=None,
              train: bool = False):
        """Self or cross attention (kv_src = encoder output for cross)
        -> (out, (k, v)); ``train`` takes the differentiable blocked
        attention, else the kernel."""
        cfg = self.cfg
        src = x if kv_src is None else kv_src
        q = L._heads(x, ap["wq"])
        k = L._heads(src, ap["wk"])
        v = L._heads(src, ap["wv"])
        if pos is not None:
            q = L.rope(q, pos, cfg.rope_theta)
            k = L.rope(k, pos, cfg.rope_theta)
        if train:
            o = L.flash_attention_blocked(
                q, k, v, causal=causal, q_block=min(512, q.shape[1]),
                kv_block=min(1024, k.shape[1]))
        else:
            dt = torch.promote_types(q.dtype, k.dtype)
            o = L.flash_attention(q.to(dt), k.to(dt), v.to(dt),
                                  causal=causal).to(q.dtype)
        out = L.matmul(o.flatten(-2), ap["wo"].flatten(0, 1))
        return out, (k, v)

    # --------------------------------------------------------------- dec
    def _dec_layer(self, lp, x, enc, pos, train: bool = False):
        cfg = self.cfg
        h, kv = self._attn(lp["self_attn"],
                           L.rmsnorm(x, lp["ln1"], cfg.norm_eps),
                           causal=True, pos=pos, train=train)
        x = x + h
        h, cross_kv = self._attn(lp["cross_attn"],
                                 L.rmsnorm(x, lp["ln_x"], cfg.norm_eps),
                                 causal=False, kv_src=enc, train=train)
        x = x + h
        x = x + L.mlp_apply(lp["mlp"], L.rmsnorm(x, lp["ln2"], cfg.norm_eps))
        return x, kv, cross_kv

    def forward(self, params, batch, train: bool = False) -> torch.Tensor:
        """Full-sequence decoder hidden states after the final norm.
        ``train`` runs the differentiable attention and checkpoints each
        layer as ``cfg.remat`` says."""
        cfg = self.cfg
        enc = self.encode(params, batch["frames"], train)
        x = L.embed_lookup(params["embed"], batch["tokens"])
        pos = torch.arange(x.shape[1], device=x.device)

        def body(lp, x):
            return self._dec_layer(lp, x, enc, pos, train)[0]

        body = tfm._remat(body, cfg.remat if train else "none")
        for lp in pm.unstack(params["dec_layers"], cfg.num_layers):
            x = body(lp, x)
        return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)

    def loss(self, params, batch) -> torch.Tensor:
        x = self.forward(params, batch, train=True)
        logits = L.unembed(x, params["embed"], tied=True)
        return tfm.cross_entropy(logits, batch["labels"],
                                 self.cfg.vocab_size).mean()

    def prefill(self, params, batch, cache_len: Optional[int] = None):
        """Encode the frames, run the decoder over the prompt -> (last
        logits, cache with the self-attention K/V padded to cache_len
        and the cross-attention K/V)."""
        cfg = self.cfg
        dt = tfm._dtype(cfg.dtype)
        enc = self.encode(params, batch["frames"])
        x = L.embed_lookup(params["embed"], batch["tokens"])
        S = x.shape[1]
        pos = torch.arange(S, device=x.device)
        ks, vs, cks, cvs = [], [], [], []
        for lp in pm.unstack(params["dec_layers"], cfg.num_layers):
            x, (k, v), (ck, cv) = self._dec_layer(lp, x, enc, pos)
            ks.append(k.to(dt))
            vs.append(v.to(dt))
            cks.append(ck.to(dt))
            cvs.append(cv.to(dt))
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(x[:, -1:], params["embed"], tied=True)
        cache = {
            "k": tfm.pad_cache(torch.stack(ks), cache_len),
            "v": tfm.pad_cache(torch.stack(vs), cache_len),
            "cross_k": torch.stack(cks), "cross_v": torch.stack(cvs),
            "pos": torch.full((), S - 1, dtype=torch.int32,
                              device=x.device),
        }
        return logits, cache

    def decode_step(self, params, cache, batch):
        """One token for the whole batch. batch: {"tokens": (B,1)}.
        Writes the new self-attention K/V into ``cache["k"]``/``["v"]``
        in place and returns (logits, cache with the advanced ``pos``)."""
        cfg = self.cfg
        x = L.embed_lookup(params["embed"], batch["tokens"])
        pos = cache["pos"] + 1
        ks, vs = cache["k"], cache["v"]
        cks, cvs = cache["cross_k"], cache["cross_v"]
        # every cross-cache row is live: the reference's Python int
        # ``ck.shape[1]``, here filled on the device (no host copy)
        cross_pos = torch.full((), cks.shape[2], dtype=torch.int32,
                               device=x.device)
        for i, lp in enumerate(pm.unstack(params["dec_layers"],
                                          cfg.num_layers)):
            h = L.rmsnorm(x, lp["ln1"], cfg.norm_eps)
            h, _, _ = self._lm._decode_attention(lp["self_attn"], h, pos,
                                                 ks[i], vs[i])
            x = x + h
            h = L.rmsnorm(x, lp["ln_x"], cfg.norm_eps)
            q = L._heads(h, lp["cross_attn"]["wq"])[:, 0]
            o, l, m = L.decode_attention_local(q, cks[i], cvs[i], cross_pos)
            o = L.combine_partials(o, l, m).to(q.dtype)
            h = L.matmul(o.flatten(-2),
                         lp["cross_attn"]["wo"].flatten(0, 1))[:, None]
            x = x + h
            x = x + L.mlp_apply(lp["mlp"],
                                L.rmsnorm(x, lp["ln2"], cfg.norm_eps))
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        logits = L.unembed(x, params["embed"], tied=True)
        return logits, dict(cache, k=ks, v=vs, pos=pos)

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

    def init_cache(self, shape: ShapeConfig,
                   device: DeviceLike = None) -> Dict[str, torch.Tensor]:
        """A zero cache of ``cache_specs(shape)`` on ``device`` (default:
        the CUDA card)."""
        return pm.zeros_from(self.cache_specs(shape), resolve_device(device))
