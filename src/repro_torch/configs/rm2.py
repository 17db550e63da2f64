"""RM2 — the paper's compute-intensive recommendation model (Fig. 1).

DenseNet is the growth driver: FC depth/width scale until FLOPs reach
18.9x V0 at V5 (Fig. 1(c)). SparseNet grows mildly (0.8 -> 1.8 TB).
"""
from repro_torch.configs.base import DLRMConfig, ModelConfig

_EMBED_DIM = 128
_BYTES = 4

# (num_tables, mean_rows, avg_pooling, width_mult) per V0..V5. DenseNet
# is GFLOP-class (the paper's compute-intensive regime); widths scale so
# dense FLOPs/sample hit ~18.9x V0 at V5 (Fig. 1c).
_BASE_BOTTOM = (2048, 2048, 128)
_BASE_TOP = (16384, 16384, 8192, 4096, 1)
_W = [1.0, 1.34, 1.82, 2.45, 3.27, 4.35]   # sqrt of target flops ratios
_GENS = [
    (400, 3_906_250, 40),
    (440, 4_261_363, 44),
    (480, 4_882_812, 48),
    (560, 5_580_357, 52),
    (640, 6_103_515, 56),
    (720, 6_781_684, 60),
]


def _scale(dims, w, last_fixed):
    out = []
    for i, d in enumerate(dims):
        if d == 1 or (last_fixed and i == len(dims) - 1):
            out.append(d)
        else:
            out.append(max(128, int(round(d * w / 128)) * 128))
    return tuple(out)


def generation(v: int) -> ModelConfig:
    tables, rows, pooling = _GENS[v]
    bottom = _scale(_BASE_BOTTOM, _W[v], last_fixed=True)
    top = _scale(_BASE_TOP, _W[v], last_fixed=False)
    return ModelConfig(
        name=f"rm2.v{v}",
        family="dlrm",
        num_layers=0, num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=0,
        d_model=_EMBED_DIM,
        dlrm=DLRMConfig(
            num_tables=tables, rows_per_table=rows, embed_dim=_EMBED_DIM,
            avg_pooling=pooling, num_dense_features=256,
            bottom_mlp=bottom, top_mlp=top,
        ),
    )


def size_bytes(v: int) -> int:
    tables, rows = _GENS[v][0], _GENS[v][1]
    return tables * rows * _EMBED_DIM * _BYTES


def dense_flops(v: int) -> int:
    """FLOPs per sample through bottom MLP + interaction + top MLP."""
    cfg = generation(v).dlrm
    f = 0
    dims = (cfg.num_dense_features,) + cfg.bottom_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        f += 2 * a * b
    nf = cfg.num_tables + 1
    f += 2 * nf * nf * cfg.embed_dim          # pairwise interaction
    inter = nf * (nf - 1) // 2
    dims = (cfg.bottom_mlp[-1] + inter,) + cfg.top_mlp
    for a, b in zip(dims[:-1], dims[1:]):
        f += 2 * a * b
    return f


CONFIG = generation(0)
GENERATIONS = [generation(v) for v in range(6)]

REDUCED = CONFIG.replace(
    name="rm2-reduced",
    dlrm=DLRMConfig(num_tables=8, rows_per_table=1000, embed_dim=16,
                    avg_pooling=10, num_dense_features=16,
                    bottom_mlp=(32, 16), top_mlp=(64, 32, 1)),
)
