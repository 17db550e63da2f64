"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions,
and the wrappers that dispatch between them (``ops``).

embedding_bag : the CN-side fused bag and the on-MN (NMP) bag, which
                replace the reference's two Pallas embedding-bag kernels
                on the cluster serving path.
"""
