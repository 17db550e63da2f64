"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

60 experts do not divide the 16-way model axis: experts are padded to 64
for expert-parallelism (6.7% padded-expert waste, recorded in the roofline
notes; padding experts are masked out of routing).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,                 # per-expert FFN width
    vocab_size=151936,
    head_dim=128,
    rope_theta=1_000_000.0,
    moe=MoEConfig(
        num_experts=60, top_k=4, d_ff_expert=1408,
        num_shared_experts=4, d_ff_shared=5632,   # 4 x 1408 fused shared expert
        ep_pad_to=64,
    ),
)

REDUCED = CONFIG.replace(
    name="qwen2-moe-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=64, vocab_size=256, head_dim=16,
    moe=MoEConfig(num_experts=6, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, d_ff_shared=128, ep_pad_to=8),
)
