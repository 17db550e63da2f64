"""RM1 — the paper's memory-intensive recommendation model (Fig. 1).

SparseNet is the growth driver: model size 1.4 TB (V0) -> 7.8 TB (V5)
over six generations / three years. Dense compute grows mildly.
Sizes are synthetic-projection endpoints from the paper; intermediate
generations interpolate geometrically (x~1.41/gen).
"""
from repro_torch.configs.base import DLRMConfig, ModelConfig

_EMBED_DIM = 128
_BYTES = 4  # fp32 tables, as served in the paper's production stack

# (num_tables, mean_rows, avg_pooling) per generation V0..V5;
# chosen so tables*rows*dim*4B hits the Fig.1(b) curve 1.4 -> 7.8 TB.
_GENS = [
    (800,  3_417_969, 80),    # V0: 1.40 TB
    (900,  4_305_004, 90),    # V1: ~1.98 TB
    (1000, 5_464_438, 100),   # V2: ~2.80 TB
    (1200, 6_442_020, 110),   # V3: ~3.96 TB
    (1400, 7_812_500, 125),   # V4: ~5.60 TB
    (1600, 9_536_743, 140),   # V5: 7.81 TB
]

_BOTTOM = (512, 256, 128)
_TOP = (1024, 1024, 512, 256, 1)


def generation(v: int) -> ModelConfig:
    tables, rows, pooling = _GENS[v]
    return ModelConfig(
        name=f"rm1.v{v}",
        family="dlrm",
        num_layers=0, num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=0,
        d_model=_EMBED_DIM,
        dlrm=DLRMConfig(
            num_tables=tables, rows_per_table=rows, embed_dim=_EMBED_DIM,
            avg_pooling=pooling, num_dense_features=256,
            bottom_mlp=_BOTTOM, top_mlp=_TOP,
        ),
    )


def size_bytes(v: int) -> int:
    tables, rows, _ = _GENS[v]
    return tables * rows * _EMBED_DIM * _BYTES


CONFIG = generation(0)
GENERATIONS = [generation(v) for v in range(6)]

REDUCED = CONFIG.replace(
    name="rm1-reduced",
    dlrm=DLRMConfig(num_tables=8, rows_per_table=1000, embed_dim=16,
                    avg_pooling=10, num_dense_features=16,
                    bottom_mlp=(32, 16), top_mlp=(64, 32, 1)),
)
