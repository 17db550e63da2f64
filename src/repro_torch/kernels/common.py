"""What the kernel wrappers share: the dtype codes of the C interfaces,
the attention kernels' masking constant, head dims and operand checks,
and the binding of a built library's entry points."""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from repro_torch.kernels import build

#: torch dtype -> the ``dtype`` code every ``csrc/*.cu`` entry takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the score of a masked key, as in the Pallas kernels
NEG_INF = -1e30
#: head dims the attention kernels are compiled for (112: zamba2-7b's
#: shared attention block, d 3584 = 32 x 112)
HEAD_DIMS = (16, 32, 64, 112, 128)


def bind(source: str, entries: Dict[str, Sequence],
         error_string: str) -> ctypes.CDLL:
    """The library of ``csrc/<source>.cu`` (built on first use) with each
    entry's argument types set; every entry returns an int error code
    that ``error_string`` turns into text."""
    lib = build.load(source)
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    fn = getattr(lib, error_string)
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_char_p
    return lib


def raise_on_error(lib: ctypes.CDLL, error_string: str, entry: str,
                   err: int) -> None:
    if err != 0:
        text = getattr(lib, error_string)(err).decode()
        raise RuntimeError(f"{entry} launch failed: {text}")


def check_attention_operands(kind: str, q: torch.Tensor,
                             **others: torch.Tensor) -> None:
    """q and the other operands of an attention kernel: CUDA tensors on
    one device, of one dtype the kernels take."""
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA {kind} kernel takes CUDA tensors, got "
                         f"q on {q.device}")
    for name, t in others.items():
        if t.device != q.device:
            raise ValueError(f"{name} lies on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"dtype {q.dtype} is not one of "
                         f"{sorted(map(str, DTYPE_CODES))}")


def check_head_dim(D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one of {HEAD_DIMS}")
