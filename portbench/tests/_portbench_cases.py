"""Small cells for the harness's CPU tests: the benchmark's own files,
with the configuration cut to ``configs/rm2.py``'s REDUCED sizes (the
port's plain PyTorch path runs on the CPU) and short chunks."""
import copy

from portbench import bench

REDUCED = {"num_tables": 8, "rows_per_table": 1000, "embed_dim": 16,
           "avg_pooling": 10, "num_dense_features": 16,
           "bottom_mlp": [32, 16], "top_mlp": [64, 32, 1],
           "interaction_proj": 64}


def tiny_spec(workload="rm2v5_mixed_b128", use_kernel=True, **cell):
    spec = copy.deepcopy(bench.spec_of(workload))
    spec["config"].update(REDUCED)
    spec["cell"].update(batch_size=16, batches_per_chunk=3, warmup_batches=2,
                        check_requests=16, use_kernel=use_kernel, **cell)
    spec["mix"]["pool_samples"] = 256
    return spec
