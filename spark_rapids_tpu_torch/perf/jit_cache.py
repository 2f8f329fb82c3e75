"""Row bucketing and schema digests for compiled programs and verdicts.

Row counts are rounded up to the next power of two before keying, so
batches of nearby sizes share one compiled program
(`plan/compiler.CompiledStage` pads its bucketed inputs to the bucket).
`schema_digest` names a schema layout (kinds, scales, nullability); the
join router keys its calibrated verdicts on it.  The process compile
cache that keys on both in the JAX package (an LRU of executables,
operand donation) comes with ROADMAP A14.
"""

import hashlib
from typing import Sequence

_MIN_BUCKET = 8


def bucket_rows(n: int, min_bucket: int = _MIN_BUCKET) -> int:
    """Power-of-two row bucket: smallest 2^k >= n (floor min_bucket)."""
    if n <= min_bucket:
        return min_bucket
    return 1 << (int(n) - 1).bit_length()


def schema_digest(schema: Sequence, nullable: Sequence[bool] = (),
                  extra: str = "") -> str:
    """Stable digest of a schema layout: one (kind, scale) pair per
    column plus the nullability pattern plus a free-form discriminator.
    The JAX package's digest, character for character."""
    parts = ";".join(f"{dt.kind}:{dt.scale}" for dt in schema)
    nulls = "".join("1" if b else "0" for b in nullable)
    s = f"{parts}|{nulls}|{extra}"
    return hashlib.sha1(s.encode()).hexdigest()[:16]
