"""zamba2-7b [hybrid] — Mamba2 stack + shared attention blocks.
[arXiv:2411.15242; unverified]

81 layers of Mamba2; a single shared attention+MLP block is interleaved
every 6 layers (weights shared across uses, as in the paper's "shared
attention" design). ssm_state=64.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=112,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_width=4,
                  chunk=256, attn_every=6, shared_attn_params=True),
)

REDUCED = CONFIG.replace(
    name="zamba2-7b-reduced", num_layers=7, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=32, conv_width=4,
                  chunk=32, attn_every=3, shared_attn_params=True),
)
