"""spark_rapids_tpu_torch: the columnar Spark acceleration library on
PyTorch and CUDA for NVIDIA Hopper.

The same Arrow-layout Column/Table values and Spark-exact ops as the JAX
package `spark_rapids_tpu`, which stays the reference the port is held
against byte for byte.  This package imports neither JAX nor anything of
the JAX package.  Plain tensor code is PyTorch; each TPU (Pallas) kernel
becomes a hand-written Hopper kernel under `csrc/`, built with nvcc at
first use (utils/cuda_build.py).

  columns.*   dtypes, Column, Table, host interop
  ops.*       Spark row hashes, JCUDF row conversion and its CUDA
              kernels, the fixed-capacity device join probe, the inner
              join router with its host and device engines and the
              outer/semi/anti transforms, GROUP BY, ORDER BY, 64-bit
              sum helpers, gather/slice/concat and the key and rank
              helpers under them; timezone conversion, calendar
              rebase and truncate, and the ORC zone rectification
  shim.*      the JNI door: handle registry and jni_api entry points
  models.*    the named query catalog; the flagship columnar step; the
              TPC-DS hand pipelines, seeded generators and oracles, and
              their file-backed runners; the star join
  plan.*      the stage IR, its compiler (fused and op-by-op engines)
              and the catalog's stage pipelines (q3, q5, q9, q67, CUBE,
              q72, q89)
  perf.*      row buckets and digests that key compiled stages, and the
              measured path pick with its verdict cache
  parallel.*  the capacity-doubling overflow retry under a RetryPolicy
  shuffle.*   the kudo wire format: writer, reader, merger, and the
              device split and assemble
  memory.*    the RmmSpark OOM state machine (reservation accounting),
              HostTable, and the tiered device/host/disk spill store
  robustness.* the task-level retry drivers (with_retry,
              split_and_retry) over the state machine
  io.*        ingest: the parquet footer, page decoders and reader
              into device columns, and the zero-copy Arrow door

Entry points run on the device of the tensors they are given; the
constructors default to "cuda" and take `device="cpu"` explicitly.
"""

from spark_rapids_tpu_torch.columns.dtypes import (  # noqa: F401
    BOOL8,
    FLOAT32,
    FLOAT64,
    INT8,
    INT16,
    INT32,
    INT64,
    LIST,
    STRING,
    STRUCT,
    TIMESTAMP_DAYS,
    TIMESTAMP_MICROS,
    UINT8,
    UINT16,
    UINT32,
    UINT64,
    DType,
    Kind,
    decimal32,
    decimal64,
    decimal128,
)
from spark_rapids_tpu_torch.columns.column import Column  # noqa: F401
from spark_rapids_tpu_torch.columns.table import Table  # noqa: F401
