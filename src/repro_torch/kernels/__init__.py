"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions,
and the wrappers that dispatch between them (``ops``).

embedding_bag   : the CN-side fused bag and the on-MN (NMP) bag, which
                  replace the reference's two Pallas embedding-bag kernels
                  on the cluster serving path.
flash_attention : the prefill attention of the LM path.
flash_decode    : one decode step's attention partials over the KV cache.
common          : dtype codes, operand checks and library binding that the
                  three share.
"""
