"""Dtype handling for stencil programs.

Maps the JSON dialect's dtype names onto numpy/JAX dtypes (the reference maps
them onto DaCe types instead: /root/reference/stencilflow/helper.py:47-59).
We additionally support bfloat16.
"""
from __future__ import annotations

import numpy as np

try:  # ml_dtypes ships with jax
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = None

_STR_TO_DTYPE = {
    "float16": np.dtype(np.float16),
    "float32": np.dtype(np.float32),
    "float64": np.dtype(np.float64),
    "int8": np.dtype(np.int8),
    "int16": np.dtype(np.int16),
    "int32": np.dtype(np.int32),
    "int64": np.dtype(np.int64),
    "bool": np.dtype(np.bool_),
}
if _BFLOAT16 is not None:
    _STR_TO_DTYPE["bfloat16"] = _BFLOAT16

_DTYPE_TO_STR = {v: k for k, v in _STR_TO_DTYPE.items()}


def str_to_dtype(name) -> np.dtype:
    """Resolve a dtype name from the program JSON to a numpy dtype."""
    if isinstance(name, np.dtype):
        return name
    if not isinstance(name, str):
        raise TypeError(f"expected dtype string, got {type(name)}")
    try:
        return _STR_TO_DTYPE[name]
    except KeyError:
        raise ValueError(f"unsupported dtype: {name!r}") from None


def dtype_to_str(dtype: np.dtype) -> str:
    return _DTYPE_TO_STR[np.dtype(dtype)]


def is_floating(dtype: np.dtype) -> bool:
    dtype = np.dtype(dtype)
    return dtype.kind == "f" or (_BFLOAT16 is not None and dtype == _BFLOAT16)
