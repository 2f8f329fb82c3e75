"""Row bucketing for compiled programs.

Row counts are rounded up to the next power of two before keying, so
batches of nearby sizes share one compiled program
(`plan/compiler.CompiledStage` pads its bucketed inputs to the bucket).
The process compile cache that keys on it in the JAX package (an LRU of
executables, operand donation) comes with ROADMAP A14.
"""

_MIN_BUCKET = 8


def bucket_rows(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    """Power-of-two row bucket: smallest 2^k >= n (floor min_bucket)."""
    if n <= min_bucket:
        return min_bucket
    return 1 << (int(n) - 1).bit_length()
