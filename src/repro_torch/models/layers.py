"""Shared transformer building blocks, in PyTorch: the counterpart of
``repro.models.layers``.

Attention modes
---------------
prefill:        :func:`flash_attention` keeps the reference's
                ``flash_attention_jnp`` interface, ``(B, S, H, D)`` in and
                out, and runs ``kernels.ops.flash_attention``: the CUDA
                flash-attention kernel on the card, its plain version on
                the CPU.  GQA is native in the kernel (q head h reads kv
                head h // G), so K/V are never repeated per q head.
train:          :func:`flash_attention_blocked` is the reference's own
                ``flash_attention_jnp`` (blocked online softmax, one
                checkpoint per q block), differentiable on every device:
                the CUDA kernel has no backward, and the reference never
                differentiates its Pallas kernel either.  The models'
                ``loss`` selects it explicitly.
decode:         :func:`decode_attention_local` computes one cache slice's
                partials (o, l, m) with ``kernels.ops.flash_decode_partial``
                and :func:`combine_partials` normalises them; with no mesh
                there is one slice, the whole cache.

The partials differ from the reference's jnp path in precision: the
reference rounds p to the working dtype before the PV product and keeps
o in it, the kernels keep p, o, l and m in fp32 (as the Pallas kernels
do); :func:`decode_attention_unsharded` casts the normalised output to
the working dtype.  In bf16 the two differ at the bf16 level.

The mesh half (``distributed.sharding`` conventions: each rank computes
on local blocks and combines them with explicit collectives):

context parallel: :func:`context_parallel_attention` runs the blocked
                attention on a rank's S/n query rows at their
                ``q_offset`` against the whole KV and gathers the rows, as
                the reference's ``shard_map`` does with its jnp attention
                (the kernel has no ``q_offset``);
seq-sharded KV: :func:`sharded_decode_attention` writes the new token's
                K/V on the rank that owns ``pos`` and runs the decode
                kernel on each rank's T/n slice at ``kv_offset``; only the
                (o, l, m) partials cross the network
                (:func:`combine_partials` over the axis: the Fsum);
weights:        :func:`mesh_heads`, :func:`mesh_out`, :func:`linear`
                and :func:`mesh_mlp` contract on the weights' local
                blocks (a sharded contracting dim: a local slice of x
                and a psum; a sharded output dim: local heads or
                columns), :func:`mesh_embed` is the vocab-parallel
                lookup, :func:`unstack` cuts stacked DTensor leaves per
                layer; with no mesh each is its one-device counterpart,
                so a model calls them on either path;
sharded dims:   :func:`rmsnorm_sharded` normalises over a dim sharded
                across ranks (a psum of the blocks' sums of squares),
                :func:`reblock` moves a dim's block from one entry's
                cut to another's (zamba2's heads that straddle the
                ``ffn`` blocks).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import sharding as shd
from repro_torch.kernels import ops
from repro_torch.models import params as pm
from repro_torch.models.params import Spec

# ---------------------------------------------------------------- norms


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + scale.float())).to(dt)


def norm_table(d: int) -> Spec:
    return Spec((d,), ("embed",), "zeros")   # scale stored as (1 + s)


# ---------------------------------------------------------------- rope


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D) or (..., H, D) with pos broadcastable to S."""
    d = x.shape[-1]
    half = d // 2
    freqs = torch.arange(0, half, dtype=torch.float32, device=x.device)
    inv = theta ** (-freqs / half)
    ang = pos[..., None].float() * inv                      # (..., S, half)
    ang = ang[..., None, :]                                 # broadcast heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- mlp


def mlp_table(d: int, f: int) -> dict:
    return {
        "wi_gate": Spec((d, f), ("embed", "ffn")),
        "wi_up": Spec((d, f), ("embed", "ffn")),
        "wo": Spec((f, d), ("ffn", "embed")),
    }


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the two operands' promoted dtype, as JAX's einsum
    promotes them (whisper's fp32 frames meet bf16 weights); torch's
    matmul refuses mixed dtypes."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    return x @ w


def mlp_hidden(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU's hidden activations, the silu in fp32 cast back to x's
    dtype."""
    gate = matmul(x, p["wi_gate"])
    up = matmul(x, p["wi_up"])
    return F.silu(gate.float()).to(x.dtype) * up


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU."""
    return matmul(mlp_hidden(p, x), p["wo"])


# ---------------------------------------------------------------- blocks


def pick_block(S: int, target: int) -> int:
    """Largest divisor of S that is <= target (block-size helper).  The
    recurrent models cut their chunks with it as the reference does: the
    SSD result depends on the chunk size through its summation order."""
    b = min(S, target)
    while S % b:
        b -= 1
    return b


# ---------------------------------------------------------------- attention


def attn_table(cfg) -> dict:
    hd = cfg.resolved_head_dim
    Hp = cfg.padded_heads
    t = {
        "wq": Spec((cfg.d_model, Hp, hd),
                   ("attn_din", "heads", "head_dim")),
        "wk": Spec((cfg.d_model, cfg.num_kv_heads, hd),
                   ("attn_din", "kv_heads", "head_dim")),
        "wv": Spec((cfg.d_model, cfg.num_kv_heads, hd),
                   ("attn_din", "kv_heads", "head_dim")),
        "wo": Spec((Hp, hd, cfg.d_model),
                   ("heads", "head_dim", "attn_dout")),
    }
    if cfg.attn_bias:
        t["bq"] = Spec((Hp, hd), ("heads", "head_dim"), "zeros")
        t["bk"] = Spec((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), "zeros")
        t["bv"] = Spec((cfg.num_kv_heads, hd), ("kv_heads", "head_dim"), "zeros")
    if cfg.qk_norm:
        t["q_norm"] = Spec((hd,), ("head_dim",), "zeros")
        t["k_norm"] = Spec((hd,), ("head_dim",), "zeros")
    return t


def head_mask(cfg, dtype: torch.dtype,
              device: torch.device) -> Optional[torch.Tensor]:
    """(Hp,) mask zeroing padded heads' output path. Padding is laid out
    WITHIN each kv group — group g holds H/kv real heads then pad slots —
    so the GQA q->kv mapping of the real heads is unchanged."""
    Hp, H, kv = cfg.padded_heads, cfg.num_heads, cfg.num_kv_heads
    if Hp == H:
        return None
    gp, g = Hp // kv, H // kv
    return ((torch.arange(Hp, device=device) % gp) < g).to(dtype)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, h, k) -> (..., h, k)."""
    d, h, k = w.shape
    return matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(p: dict, x: torch.Tensor, cfg, pos: Optional[torch.Tensor]):
    q, k, v = _heads(x, p["wq"]), _heads(x, p["wk"]), _heads(x, p["wv"])
    return _finish_qkv(p, q, k, v, cfg, pos)


def _finish_qkv(p: dict, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                cfg, pos: Optional[torch.Tensor]):
    """Bias, q/k norm and rope on the projected heads."""
    if cfg.attn_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if pos is not None:  # rope (None for whisper encoder/cross paths)
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool) -> torch.Tensor:
    """Blocked online-softmax attention. q: (B,S,H,D), k/v: (B,T,Hkv,D)
    -> (B,S,H,D), through ``kernels.ops.flash_attention``.  The operands
    go in as (B,H,S,D) views of the (B,S,H,D) tensors; the kernel reads
    and writes them in place, so no copy is made on the card.  The
    kernel picks its own tiles, so the reference's ``q_block`` and
    ``kv_block`` have no counterpart here (:func:`pick_block`, which
    sized them, stays for the recurrent models' chunks)."""
    o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal)
    return o.transpose(1, 2)


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool, q_offset=0,
                            q_block: int = 512, kv_block: int = 1024,
                            kv_len: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Blocked online-softmax attention, the reference's
    ``flash_attention_jnp``. q: (B,S,H,D), k/v: (B,T,Hkv,D) -> (B,S,H,D)
    in q's dtype.

    GQA by head grouping; blocks of ``pick_block(S, q_block)`` queries
    and ``pick_block(T, kv_block)`` keys; an optional running length
    (``kv_len``) masks the keys at or past it.  As in the reference: the
    scores are fp32 (the operands are widened, which gives the products
    of ``preferred_element_type=float32``), the block positions come
    from the loop counters, ``m_new`` is clamped at -1e30 so that a fully
    masked block gives p = 0 and no nan, and p is rounded to V's dtype
    before P V.  Each q block runs under ``torch.utils.checkpoint``
    (``jax.checkpoint(q_step)``): the backward recomputes its scores
    instead of keeping every (q, kv) block's.

    Two differences, neither of which changes the output: the running
    max takes no gradient (the output does not depend on it, so its
    exact gradient is zero; the reference's AD computes it and gets
    rounding noise), and with a static ``q_offset`` a causal kv block
    that lies wholly after the q block is skipped.  Such a block is never
    the first (key 0 precedes every query), so m is finite when it would
    come, and the reference's pass over it gives p = 0 and corr = 1,
    which leave m, l and acc bitwise as they were.
    """
    B, S, H, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qb = pick_block(S, q_block)
    kb = pick_block(T, kv_block)
    nq, nk = S // qb, T // kb

    qg = q.reshape(B, nq, qb, Hkv, G, D).permute(1, 0, 3, 4, 2, 5)
    kg = k.reshape(B, nk, kb, Hkv, D).permute(1, 0, 3, 2, 4)
    vg = v.reshape(B, nk, kb, Hkv, D).permute(1, 0, 3, 2, 4)
    ar_q = torch.arange(qb, device=q.device)
    ar_k = torch.arange(kb, device=q.device)

    def q_step(qblk: torch.Tensor, iq: int) -> torch.Tensor:
        # qblk: (B,Hkv,G,qb,D)
        q_pos = q_offset + iq * qb + ar_q
        qf = qblk.float()
        m = torch.full((B, Hkv, G, qb), float("-inf"), device=q.device)
        l = torch.zeros((B, Hkv, G, qb), device=q.device)
        acc = torch.zeros((B, Hkv, G, qb, D), device=q.device)
        for jk in range(nk):
            if (causal and jk and isinstance(q_offset, int)
                    and jk * kb > q_offset + (iq + 1) * qb - 1):
                break                                    # all masked
            kblk, vblk = kg[jk], vg[jk]                  # (B,Hkv,kb,D)
            kpos = jk * kb + ar_k
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kblk.float()) * scale
            penalty = torch.zeros((qb, kb), device=q.device)
            if causal:
                penalty = penalty + torch.where(
                    q_pos[:, None] >= kpos[None, :], 0.0, -1e30)
            if kv_len is not None:
                penalty = penalty + torch.where(
                    kpos[None, :] < kv_len, 0.0, -1e30)
            s = s + penalty
            m_new = torch.maximum(m, s.detach().amax(-1)).clamp(min=-1e30)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p.to(vblk.dtype), vblk)
            m = m_new
        out = acc / l.clamp(min=1e-37)[..., None]
        return out.to(q.dtype)

    outs = [checkpoint(q_step, qg[iq], iq, use_reentrant=False)
            for iq in range(nq)]
    # (nq, B, Hkv, G, qb, D) -> (B, S, H, D)
    return torch.stack(outs).permute(1, 0, 4, 2, 3, 5).reshape(B, S, H, D)


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               axis: str = "model", q_block: int = 512,
                               kv_block: int = 1024) -> torch.Tensor:
    """Context-parallel attention for head counts that cannot shard over
    the model axis (smollm 9H, whisper 20H): each rank runs the blocked
    attention over its S/n query rows, at their ``q_offset``, against the
    whole KV, instead of every rank repeating the whole attention; the
    rows are gathered over ``axis``.

    q: (B,S,H,D) and k/v: (B,T,Hkv,D), this rank's batch block ->
    (B,S,H,D)."""
    i, n = shd.entry_index(axis)
    s_loc = q.shape[1] // n
    off = i * s_loc
    o = flash_attention_blocked(
        q[:, off:off + s_loc], k, v, causal=causal, q_offset=off,
        q_block=min(q_block, s_loc), kv_block=min(kv_block, k.shape[1]))
    return shd.all_gather(o, axis, 1)


def use_context_parallel(mesh, seq_len: int, axis: str = "model") -> bool:
    """CP applies when heads are NOT sharded (FSDP mode), the mesh has a
    model axis, and the sequence divides it (train/prefill only)."""
    n = shd.mesh_shape(mesh).get(axis, 1)
    if n <= 1:
        return False
    if shd.resolve(("heads",)) != shd.resolve((None,)):
        return False
    return seq_len > 1 and seq_len % n == 0


def batch_pspec_entry(batch: int, mesh) -> shd.Entry:
    """The entry for the batch dim under the active 'batch' rule,
    dropping axes the batch size cannot divide (e.g. global_batch=1)."""
    return shd.resolve_for_shape(("batch",), (batch,))[0]


def psum_matmul(x: torch.Tensor, w: torch.Tensor,
                entry: shd.Entry) -> torch.Tensor:
    """``x @ w`` whose contracting dim is sharded over ``entry``: this
    rank's partial product in fp32 at least (bf16 operands are exact
    there), summed over the axes and rounded once to the operands'
    dtype, as one device's GEMM rounds its fp32 accumulator once.  With
    ``entry`` None (the dim whole) it is :func:`matmul`."""
    if entry is None:
        return matmul(x, w)
    dt = torch.promote_types(x.dtype, w.dtype)
    wide = torch.promote_types(dt, torch.float32)
    return shd.psum(matmul(x.to(wide), w.to(wide)), entry).to(dt)


def _contract(x: torch.Tensor, wl: torch.Tensor,
              din: shd.Entry) -> torch.Tensor:
    """x (..., d) whole @ a rank's block ``wl`` of a 2-D weight whose
    contracting dim is sharded over ``din``: this rank's slice of x,
    then a psum (:func:`psum_matmul`)."""
    i, n = shd.entry_index(din)
    step = x.shape[-1] // n
    return psum_matmul(x.narrow(-1, i * step, step), wl, din)


def mesh_heads(x: torch.Tensor, w, names) -> torch.Tensor:
    """x (..., d) whole @ w (d, h, k) under ``names`` -> (..., h', k):
    the heads of this rank's block of ``w``.  A contracting dim sharded
    over an axis contracts this rank's slice of x, then a psum
    (:func:`psum_matmul`).  With no mesh it is :func:`_heads`."""
    if shd.device_mesh() is None:
        return _heads(x, w)
    wl = shd.local(w, *names)
    d, h, k = wl.shape
    return _contract(x, wl.reshape(d, h * k),
                     shd.spec(w, *names)[0]).unflatten(-1, (h, k))


def mesh_out(o: torch.Tensor, w, names) -> torch.Tensor:
    """o (..., h', k) @ w (h, k, d) under ``names`` -> (..., d) whole.
    ``o`` holds the heads of this rank's block of ``w`` (all of them
    when the heads dim is whole): a sharded heads dim is a psum, a
    sharded output dim a gather.  With no mesh it is :func:`matmul`."""
    if shd.device_mesh() is None:
        return matmul(o.flatten(-2), w.flatten(0, 1))
    hspec, _, dspec = shd.spec(w, *names)
    wl = shd.local(w, *names)
    out = psum_matmul(o.flatten(-2), wl.flatten(0, 1), hspec)
    return shd.all_gather(out, dspec, -1)


def mesh_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU on this rank's ``ffn`` columns of ``wi_*`` and rows of
    ``wo``, then a psum over the ``ffn`` axes (Megatron TP); with no
    mesh :func:`mlp_apply`."""
    if shd.device_mesh() is None:
        return mlp_apply(p, x)
    fspec = shd.spec(p["wi_gate"], "embed", "ffn")[1]
    lp = {"wi_gate": shd.local(p["wi_gate"], "embed", "ffn"),
          "wi_up": shd.local(p["wi_up"], "embed", "ffn")}
    return psum_matmul(mlp_hidden(lp, x), shd.local(p["wo"], "ffn", "embed"),
                       fspec)


def linear(x: torch.Tensor, w, names) -> torch.Tensor:
    """x (..., d) whole @ w (d, e) under ``names``: :func:`matmul` with
    no mesh; on a mesh the product with this rank's block of ``w`` (a
    sharded contracting dim contracts this rank's slice of x, then a
    psum, as :func:`mesh_heads` does; a sharded output dim gives this
    rank's columns)."""
    if shd.device_mesh() is None:
        return matmul(x, w)
    return _contract(x, shd.local(w, *names), shd.spec(w, *names)[0])


def rmsnorm_sharded(x: torch.Tensor, scale: torch.Tensor, entry: shd.Entry,
                    d: int, eps: float = 1e-6) -> torch.Tensor:
    """:func:`rmsnorm` over a last dim of ``d`` sharded over ``entry``:
    ``x`` and ``scale`` are this rank's blocks, and the mean of squares
    is the psum of the blocks' sums over the whole ``d`` (not the
    block's own mean).  With ``entry`` None it is :func:`rmsnorm`."""
    if entry is None:
        return rmsnorm(x, scale, eps)
    dt = x.dtype
    x = x.float()
    ms = shd.psum((x * x).sum(-1, keepdim=True), entry) / d
    x = x * torch.rsqrt(ms + eps)
    return (x * (1.0 + scale.float())).to(dt)


def reblock(x: torch.Tensor, src: shd.Entry, dst: shd.Entry,
            dim: int = -1) -> torch.Tensor:
    """This rank's block of ``dim`` sharded over ``dst``, from its block
    sharded over ``src``: the whole gathered over ``src``, then cut."""
    if src == dst:
        return x
    x = shd.all_gather(x, src, dim)
    i, n = shd.entry_index(dst)
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step)


def unstack(tree: dict, n: int) -> list:
    """The ``n`` per-layer trees of a tree stacked on a leading layer
    axis: ``params.unstack`` with no mesh; on a mesh each DTensor leaf's
    slices as DTensors (``sharding.unbind0``)."""
    if shd.device_mesh() is None:
        return pm.unstack(tree, n)
    parts = pm.tree_map(shd.unbind0, tree)
    return [pm.tree_map(lambda t: t[i], parts) for i in range(n)]


def mesh_embed(table, tokens: torch.Tensor) -> torch.Tensor:
    """Vocab-parallel lookup of ``tokens`` (the global (B, S) batch, a
    DTensor or whole) for this rank's batch block: each rank looks up
    the tokens of its vocab rows (zero rows for the others), then a
    psum; exactly one rank adds each token's row.  With no mesh it is
    :func:`embed_lookup`."""
    if shd.device_mesh() is None:
        return embed_lookup(table, tokens)
    tokens = shd.local(tokens, "batch", None)
    vspec = shd.spec(table, "vocab", "embed")[0]
    tl = shd.local(table, "vocab", "embed")
    i, _ = shd.entry_index(vspec)
    t = tokens.long() - i * tl.shape[0]
    hit = ((t >= 0) & (t < tl.shape[0]))[..., None]
    e = torch.where(hit, F.embedding(t.clamp(0, tl.shape[0] - 1), tl), 0.0)
    return shd.psum(e.to(tl.dtype), vspec)


# ------------------------------------------------------------- decode


def decode_attention_local(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor,
                           kv_offset: int = 0):
    """Partial attention over a local cache slice.

    q: (B,H,D); caches: (B,T_loc,Hkv,D); pos: scalar current position
    (global, an int32 device tensor); kv_offset: global position of this
    slice's first row.  Returns fp32 partials (o, l, m) for
    :func:`combine_partials` — the Fsum pattern: only (B,H,D)+(B,H)+(B,H)
    leave the slice.  A slice wholly after ``pos`` gives m = -1e30, as
    the Pallas kernel does (the reference's jnp path gives -inf).
    """
    return ops.flash_decode_partial(q.contiguous(), k_cache, v_cache, pos,
                                    kv_offset=kv_offset)


def combine_partials(o: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                     axis_name: shd.Entry = None) -> torch.Tensor:
    """Combine flash-decode partials across a mesh axis (or normalise the
    one slice's): an all-reduce MAX of m, then SUM of l * corr and
    o * corr, corr = exp(m - m_max).  A slice wholly after ``pos`` has
    m = -1e30, so its corr is 0."""
    if axis_name is None:
        return (o / l.clamp(min=1e-37)[..., None]).to(o.dtype)
    m_glob = shd.pmax(m, axis_name)
    corr = torch.exp(m - m_glob)
    # one psum carries both sums: (..., D) of o * corr and (..., 1) of l
    lo = shd.psum(torch.cat([o * corr[..., None].to(o.dtype),
                             (l * corr)[..., None].to(o.dtype)], -1),
                  axis_name)
    o_glob, l_glob = lo[..., :-1], lo[..., -1]
    return o_glob / l_glob.clamp(min=1e-37)[..., None].to(o.dtype)


def sharded_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, pos: torch.Tensor,
                             axis: shd.Entry = "model"):
    """Decode attention over a sequence-sharded KV cache.

    q: (B,H,D), this rank's batch block; k_cache/v_cache: this rank's
    (B, T/n, Hkv, D) slice of the (B, T, Hkv, D) cache, the slice of
    block ``i`` of ``axis`` holding rows [i*T/n, (i+1)*T/n).  The new
    token's K/V is written IN PLACE only on the rank that owns ``pos``
    (a ``pos`` past the cache writes its last slot, as the unsharded
    path does): the owner is chosen on the device, every other rank
    writes its row back unchanged, so the step stays sync-free.  Each
    rank runs the decode kernel on its slice at ``kv_offset`` = i*T/n;
    only the (o, l, m) partials cross the network.  -> (o (B,H,D) in
    q's dtype, k_cache, v_cache)."""
    i, n = shd.entry_index(axis)
    t_loc = k_cache.shape[1]
    off = i * t_loc
    row = pos.reshape(1).to(torch.int64).clamp(max=t_loc * n - 1) - off
    own = ((row >= 0) & (row < t_loc)).view(1, 1, 1, 1)
    row = row.clamp(0, t_loc - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache.index_select(1, row)
        cache.index_copy_(1, row, torch.where(
            own, new.unsqueeze(1).to(cache.dtype), cur))
    o, l, m = decode_attention_local(q, k_cache, v_cache, pos, kv_offset=off)
    return combine_partials(o, l, m, axis).to(q.dtype), k_cache, v_cache


def decode_attention_unsharded(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, k_new: torch.Tensor,
                               v_new: torch.Tensor, pos: torch.Tensor):
    """Single-device path: write the new token's K/V at ``pos`` and attend
    over the whole cache -> (o (B,H,D) in q's dtype, k_cache, v_cache).

    The write is IN PLACE (``index_copy_`` at the device ``pos``, so no
    host sync), where the reference returns an updated copy; the returned
    caches are the arguments.  As the reference's dynamic update does, a
    ``pos`` past the cache writes its last slot."""
    idx = pos.reshape(1).to(torch.int64).clamp(max=k_cache.shape[1] - 1)
    k_cache.index_copy_(1, idx, k_new.unsqueeze(1).to(k_cache.dtype))
    v_cache.index_copy_(1, idx, v_new.unsqueeze(1).to(v_cache.dtype))
    o, l, m = decode_attention_local(q, k_cache, v_cache, pos)
    return combine_partials(o, l, m).to(q.dtype), k_cache, v_cache


# ---------------------------------------------------------------- embed


def embed_table(vocab: int, d: int) -> Spec:
    return Spec((vocab, d), ("vocab", "embed"), "normal:0.02")


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), table)


def unembed(x: torch.Tensor, table_or_head: torch.Tensor,
            tied: bool) -> torch.Tensor:
    if tied:
        return x @ table_or_head.T
    return x @ table_or_head


def head_table(vocab: int, d: int) -> Spec:
    return Spec((d, vocab), ("embed", "vocab"))
