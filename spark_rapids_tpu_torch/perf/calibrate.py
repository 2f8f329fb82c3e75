"""Operand digests for multi-input stages.

The measured fused-vs-op-by-op calibration that keys on this digest in
the JAX package comes with ROADMAP A14; the digest is here already
because the fused engine keys its compiled programs on it.
"""

import hashlib

from spark_rapids_tpu_torch.perf.jit_cache import bucket_rows


def operands_digest(parts, extra: str = "") -> str:
    """Stable digest folding EVERY operand of a multi-input op/stage:
    each part is ``(layout, rows)`` — a layout string (schema digest,
    dtype join, anything stable) plus a row count that folds as its
    power-of-two bucket class (``rows <= 0`` means the layout string
    already encodes the exact shape).  Folding all operands keeps a key
    for one operand's size class from being reused when another
    operand changed class."""
    items = []
    for layout, rows in parts:
        bucket = bucket_rows(int(rows)) if rows and rows > 0 else 0
        items.append(f"{layout}@{bucket}")
    s = "|".join(items) + f"|{extra}"
    return hashlib.sha1(s.encode()).hexdigest()[:16]
