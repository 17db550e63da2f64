"""qwen2.5-14b [dense] — GQA, QKV bias. [hf:Qwen/Qwen2.5-0.5B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    head_dim=128,
    attn_bias=True,
    rope_theta=1_000_000.0,
    # 40 heads don't divide the 16-way model axis: pad to 48 (masked,
    # zero-contribution heads) to get Megatron head-TP; ~20% extra attn
    # compute, recorded in the roofline notes
    pad_heads_to=48,
)

REDUCED = CONFIG.replace(
    name="qwen2.5-14b-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    pad_heads_to=6,   # exercise masked head padding in the smoke tests
)
