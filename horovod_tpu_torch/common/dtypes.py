"""Torch dtypes and the engine's ``DataType`` codes (``engine/cc/wire.h``).

Counterpart of ``horovod_tpu/common/dtypes.py``, which maps numpy
dtypes; the port hands the engine torch tensors' memory directly.
"""

from __future__ import annotations

import torch

UINT8 = 0
INT8 = 1
INT32 = 2
INT64 = 3
FLOAT16 = 4
FLOAT32 = 5
FLOAT64 = 6
BFLOAT16 = 7
BOOL = 8

_TORCH_TO_CODE = {
    torch.uint8: UINT8,
    torch.int8: INT8,
    torch.int32: INT32,
    torch.int64: INT64,
    torch.float16: FLOAT16,
    torch.float32: FLOAT32,
    torch.float64: FLOAT64,
    torch.bfloat16: BFLOAT16,
    torch.bool: BOOL,
}


def torch_to_code(dtype: torch.dtype) -> int:
    code = _TORCH_TO_CODE.get(dtype)
    if code is None:
        raise ValueError(f"unsupported dtype for collective: {dtype}")
    return code

