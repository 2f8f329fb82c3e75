"""Compile keying: power-of-two row buckets and operand digests.

  jit_cache.py  bucket_rows
  calibrate.py  operands_digest

The process compile cache (JitCache, pad_axis0) and the measured
engine calibration come with ROADMAP A14.
"""
