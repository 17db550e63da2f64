"""whisper-large-v3 [audio] — enc-dec backbone; conv frontend STUB.
[arXiv:2212.04356; unverified]

``input_specs()`` provides precomputed frame embeddings
(batch, 1500, d_model). Decoder uses RoPE in this backbone (the original's
learned 448-position table cannot cover the assignment's 32k decode shape;
noted in DESIGN.md as a changed assumption).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="audio",
    num_layers=32,             # decoder layers
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51866,
    head_dim=64,
    tie_embeddings=True,
    encdec=EncDecConfig(num_encoder_layers=32, encoder_seq=1500),
)

REDUCED = CONFIG.replace(
    name="whisper-reduced", num_layers=2, d_model=64, num_heads=4,
    num_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
    encdec=EncDecConfig(num_encoder_layers=2, encoder_seq=24),
)
