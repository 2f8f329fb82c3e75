"""Misc utilities (reference utilities.hpp:3-12: bitmask_bitwise_or,
spark-numeric type traits)."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columns.dtypes import DType, Kind


def bitmask_bitwise_or(masks: Sequence[torch.Tensor]) -> torch.Tensor:
    """OR N equal-length packed bitmask buffers (utilities.hpp
    bitmask_bitwise_or), on their device: used to combine validity
    across columns."""
    if not masks:
        raise ValueError("need at least one mask")
    out = masks[0]
    for m in masks[1:]:
        if m.shape != out.shape:
            raise ValueError("mask length mismatch")
        out = out | m
    return out


def is_spark_numeric(dt: DType) -> bool:
    """spark-numeric type trait (utilities.hpp): integrals, floats and
    decimals."""
    return dt.kind in (Kind.INT8, Kind.INT16, Kind.INT32, Kind.INT64,
                       Kind.FLOAT32, Kind.FLOAT64, Kind.DECIMAL32,
                       Kind.DECIMAL64, Kind.DECIMAL128)
