"""llava-next-mistral-7b [vlm] — mistral backbone, anyres tiling stub.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings (batch, num_patches, d_model); a learned
2-layer MM projector maps them into the LM embedding space.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    vlm=VLMConfig(num_patches=576),
)

REDUCED = CONFIG.replace(
    name="llava-next-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=2, d_ff=128, vocab_size=256, head_dim=16,
    vlm=VLMConfig(num_patches=16),
)
