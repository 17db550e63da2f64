"""PyTorch/CUDA port of ``repro`` (DisaggRec), slice by slice.

Each module keeps the name and place of its counterpart in ``repro``
(``repro_torch/serving/cluster.py`` <-> ``repro/serving/cluster.py``).
The port imports torch and numpy, never JAX and never ``repro``: what it
needs from the reference it keeps as its own copy.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``
(``repro_torch.device``).  The embedding-bag kernels are hand-written
CUDA for Hopper (``kernels/csrc``).
"""
