"""Flat handle-based API mirroring the reference JNI export surface
(src/main/cpp/src/*Jni.cpp pattern: unwrap jlong handles -> column views
-> call the op -> release_as_jlong).  This is the layer a JNI or C-FFI
binding calls; every function takes and returns int64 handles and plain
scalars, mirroring the Java native method signatures (Hash.java:44
murmurHash32, RowConversion.java:35 convertToRows, ...).

The ops run on the device of the columns the handles name; columns made
from host values go to `device`, "cuda" unless the caller asks for the
CPU.
"""

from __future__ import annotations

from typing import List, Sequence

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.dtypes import DType
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import hash as _hash
from spark_rapids_tpu_torch.ops import joins as _joins
from spark_rapids_tpu_torch.ops import row_conversion as _rc
from spark_rapids_tpu_torch.shim.handles import REGISTRY


def _cols(handles: Sequence[int]) -> List[Column]:
    return [REGISTRY.get(h) for h in handles]


def make_column_from_host(values, dtype, device="cuda") -> int:
    return REGISTRY.register(Column.from_pylist(values, dtype, device))


def release_column(handle: int) -> None:
    REGISTRY.release(handle)


def column_to_host(handle: int):
    return REGISTRY.get(handle).to_pylist()


# --------------------------------------------------------------- ops
# ROADMAP A16 and A14: the JAX package opens each export with a
# fault-injection check (maybe_inject) and an NVTX-like op_range


def murmur_hash3_32(seed: int, column_handles: Sequence[int]) -> int:
    return REGISTRY.register(_hash.murmur3_32(_cols(column_handles), seed))


def xx_hash_64(seed: int, column_handles: Sequence[int]) -> int:
    return REGISTRY.register(_hash.xxhash64(_cols(column_handles), seed))


def convert_to_rows(table_handles: Sequence[int]) -> int:
    return REGISTRY.register(
        _rc.convert_to_rows(Table(_cols(table_handles))))


def convert_from_rows(rows_handle: int, type_ids: Sequence[str],
                      scales: Sequence[int]) -> List[int]:
    schema = [DType(k, s) for k, s in zip(type_ids, scales)]
    out = _rc.convert_from_rows(REGISTRY.get(rows_handle), schema)
    return [REGISTRY.register(c) for c in out.columns]


def sort_merge_inner_join(left_handles: Sequence[int],
                          right_handles: Sequence[int],
                          compare_nulls_equal: bool) -> List[int]:
    """The inner join's gather maps as two INT32 column handles (left
    indices, right indices)."""
    li, ri = _joins.sort_merge_inner_join(
        Table(_cols(left_handles)), Table(_cols(right_handles)),
        _joins.NULL_EQUAL if compare_nulls_equal else _joins.NULL_UNEQUAL)
    return [REGISTRY.register(Column(dtypes.INT32, int(li.shape[0]),
                                     data=li)),
            REGISTRY.register(Column(dtypes.INT32, int(ri.shape[0]),
                                     data=ri))]
