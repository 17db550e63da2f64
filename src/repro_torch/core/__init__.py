"""DisaggRec core: the paper's contributions as composable modules.

C1 near-memory reduction ........ core.sharding (+ kernels/embedding_bag)
C2 embedding management ......... core.embedding_manager
C3 sequential query processing .. core.scheduler
C4 failure-aware allocation ..... core.allocator, core.failure
C5/C6 TCO + heterogeneity ....... core.tco, core.hardware

``core.serving_unit`` is the analytic serving-unit model C4-C6 share.
Nothing is imported eagerly."""
