"""Compile keying and measured path picks.

  jit_cache.py  bucket_rows, schema_digest
  calibrate.py  operands_digest; pick_path and its verdict cache (the
                join router's engine choice), keyed by torch device

The process compile cache (JitCache, pad_axis0) comes with ROADMAP A14.
"""
