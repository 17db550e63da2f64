"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6400,                 # per-expert FFN width
    vocab_size=32064,
    head_dim=128,
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
)

REDUCED = CONFIG.replace(
    name="phi3.5-moe-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=96, vocab_size=256, head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96),
)
