"""smollm-135m [dense] — llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    head_dim=64,
    tie_embeddings=True,
)

REDUCED = CONFIG.replace(
    name="smollm-135m-reduced", num_layers=2, d_model=48, num_heads=3,
    num_kv_heads=3, d_ff=96, vocab_size=256, head_dim=16,
)
