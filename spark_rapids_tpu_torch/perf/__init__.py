"""Compile keying, the process compile cache, measured path picks and
the semantic result cache.

  jit_cache.py     bucket_rows, schema_digest; JitCache / CACHE (an LRU
                   of compiled programs keyed by kernel name, schema
                   digest and row bucket) and pad_axis0
  calibrate.py     operands_digest; pick_path and its verdict cache (the
                   join router's and the stage compiler's engine
                   choice), keyed by torch device
  result_cache.py  content-keyed query results and stage outputs,
                   ingest epochs, incremental folds

Env knobs (read dynamically):
  SPARK_RAPIDS_TPU_JIT_CACHE=0          disable the compile cache
  SPARK_RAPIDS_TPU_JIT_CACHE_ENTRIES=N  LRU entry budget (default 256)
  SPARK_RAPIDS_TPU_JIT_CACHE_BYTES=N    LRU byte budget (default 8 GiB
                                        of estimated operand footprint)
  SPARK_RAPIDS_TPU_RESULT_CACHE=1       arm the result cache
"""

from spark_rapids_tpu_torch.perf.jit_cache import (  # noqa: F401
    CACHE, JitCache, bucket_rows, pad_axis0, schema_digest)
