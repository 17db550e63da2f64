"""Analytic counts: parameters for every family, and the DLRM's dense
FLOPs, sparse bytes and table bytes per sample, which the serving-unit
stage model prices.

The counterpart of ``repro.configs.counting``.  The parameter formulas
count the published widths: real heads and experts, where the models'
parameter trees hold padded ones (``pad_heads_to``, ``ep_pad_to``), so a
padded config's tree is larger than its count, as in the reference.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig


def _attn_params(cfg: ModelConfig, kv_heads: int | None = None) -> int:
    hd = cfg.resolved_head_dim
    kv = cfg.num_kv_heads if kv_heads is None else kv_heads
    n = cfg.d_model * cfg.num_heads * hd          # q
    n += 2 * cfg.d_model * kv * hd                # k, v
    n += cfg.num_heads * hd * cfg.d_model         # o
    if cfg.attn_bias:
        n += (cfg.num_heads + 2 * kv) * hd        # qkv bias (no o bias, qwen2)
    if cfg.qk_norm:
        n += 2 * hd                               # per-head-dim rmsnorm scales
    return n


def _mlp_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff                     # gate, up, down


def _moe_params(cfg: ModelConfig) -> int:
    m = cfg.moe
    n = cfg.d_model * m.num_experts               # router
    n += m.num_experts * _mlp_params(cfg.d_model, m.d_ff_expert)
    if m.num_shared_experts:
        n += _mlp_params(cfg.d_model, m.d_ff_shared)
        n += cfg.d_model                          # shared-expert gate
    return n


def _mamba2_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    n = cfg.d_model * (2 * d_inner + 2 * s.d_state + nheads)   # in_proj
    n += s.conv_width * (d_inner + 2 * s.d_state)              # conv1d
    n += 3 * nheads                                            # A_log, D, dt_bias
    n += d_inner                                               # gated norm scale
    n += d_inner * cfg.d_model                                 # out_proj
    n += cfg.d_model                                           # pre-norm
    return n


def _rwkv6_params(cfg: ModelConfig) -> int:
    d, dff = cfg.d_model, cfg.d_ff
    hd = cfg.resolved_head_dim
    lora = 32
    n = 0
    # time-mix block
    n += 6 * d                       # x_maa base + (w,k,v,r,g) lerps
    n += d * (5 * lora) + 5 * lora * d   # maa lora (w1, w2)
    n += d * lora + lora * d + d     # decay lora + decay base
    n += d                           # u ("time_faaaa" bonus)
    n += 4 * d * d                   # r, k, v, g projections
    n += d * d                       # output projection
    n += 2 * d                       # per-head group-norm scale+bias
    # channel-mix block
    n += 2 * d                       # x_maa lerp (k, r)
    n += d * dff + dff * d + d * d   # k, v, receptance
    n += 2 * d                       # two pre-norms
    return n


def _dense_layer_params(cfg: ModelConfig) -> int:
    return _attn_params(cfg) + _mlp_params(cfg.d_model, cfg.d_ff) + 2 * cfg.d_model


def param_count(cfg: ModelConfig) -> int:
    if cfg.family == "dlrm":
        return dlrm_param_count(cfg)

    V, d = cfg.vocab_size, cfg.d_model
    n = V * d                                     # embedding
    if not cfg.tie_embeddings:
        n += V * d                                # lm head
    n += d                                        # final norm

    if cfg.family in ("dense", "vlm"):
        n += cfg.num_layers * _dense_layer_params(cfg)
        if cfg.family == "vlm":
            n += 2 * d * d + 2 * d                # mm projector (2-layer MLP)
    elif cfg.family == "moe":
        per = _attn_params(cfg) + _moe_params(cfg) + 2 * d
        n += cfg.num_layers * per
    elif cfg.family == "hybrid":
        n += cfg.num_layers * _mamba2_params(cfg)
        if cfg.ssm.attn_every:
            # one shared attention+MLP block reused at every attn_every layers
            n += _attn_params(cfg) + _mlp_params(d, cfg.d_ff) + 2 * d
    elif cfg.family == "ssm":
        n += cfg.num_layers * _rwkv6_params(cfg)
    elif cfg.family == "audio":
        enc_layer = _attn_params(cfg) + _mlp_params(d, cfg.d_ff) + 2 * d
        dec_layer = 2 * _attn_params(cfg) + _mlp_params(d, cfg.d_ff) + 3 * d
        n += cfg.encdec.num_encoder_layers * enc_layer
        n += cfg.num_layers * dec_layer
        n += d                                    # encoder final norm
    else:
        raise ValueError(cfg.family)
    return n


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top_k + shared experts only)."""
    if cfg.family != "moe":
        return param_count(cfg)
    m = cfg.moe
    V, d = cfg.vocab_size, cfg.d_model
    n = V * d + (0 if cfg.tie_embeddings else V * d) + d
    per = _attn_params(cfg) + 2 * d
    per += cfg.d_model * m.num_experts            # router always runs
    per += m.top_k * _mlp_params(d, m.d_ff_expert)
    if m.num_shared_experts:
        per += _mlp_params(d, m.d_ff_shared) + d
    n += cfg.num_layers * per
    return n


def dlrm_dense_flops(cfg: ModelConfig) -> int:
    """DenseNet FLOPs per sample (bottom MLP + proj + interaction + top)."""
    r = cfg.dlrm
    f = 0
    dims = (r.num_dense_features,) + r.bottom_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        f += 2 * a * b
    f += 2 * r.num_tables * r.interaction_proj * r.embed_dim
    nf = r.interaction_proj + 1
    f += 2 * nf * nf * r.embed_dim
    inter = nf * (nf - 1) // 2
    dims = (r.bottom_mlp[-1] + inter,) + r.top_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        f += 2 * a * b
    return f


def dlrm_sparse_bytes(cfg: ModelConfig) -> float:
    """SparseNet bytes touched per sample (sum over tables of pooling x row)."""
    r = cfg.dlrm
    return r.num_tables * r.avg_pooling * r.embed_dim * 4


def dlrm_size_bytes(cfg: ModelConfig) -> int:
    r = cfg.dlrm
    return r.num_tables * r.rows_per_table * r.embed_dim * 4


def dlrm_param_count(cfg: ModelConfig) -> int:
    r = cfg.dlrm
    n = r.num_tables * r.rows_per_table * r.embed_dim
    n += r.num_tables * r.interaction_proj        # interaction projection
    dims = (r.num_dense_features,) + r.bottom_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        n += a * b + b
    f = r.interaction_proj + 1
    inter = f * (f - 1) // 2
    dims = (r.bottom_mlp[-1] + inter,) + r.top_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        n += a * b + b
    return n
