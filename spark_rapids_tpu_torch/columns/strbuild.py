"""The shared flat-span STRING column construction, and the host copy
of a few rows' bytes.

Every device string engine ends the same way: per-row (start, len) spans
into some flat uint8 source, materialized as one byte gather on the
source's device.  Values a host fallback produced for rare rows are
written into the byte buffer directly; only those rows' bytes cross from
the host, never the whole column.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column


def _segments(lens: torch.Tensor, total: int):
    """(segment of each of `total` flat positions, position within its
    segment) for int64 segment lengths that add up to `total`."""
    seg = torch.repeat_interleave(
        torch.arange(lens.shape[0], device=lens.device), lens,
        output_size=total)
    starts = torch.cumsum(lens, 0) - lens
    return seg, torch.arange(total, device=lens.device) - starts[seg]


def host_row_bytes(col: Column, rows: torch.Tensor) -> List[bytes]:
    """The bytes of the STRING rows `rows` (int64 indices on the column's
    device), copied to the host: one gather, one copy of just those
    rows' bytes."""
    rows = rows.to(device=col.offsets.device, dtype=torch.int64)
    starts = col.offsets[:-1].to(torch.int64)[rows]
    lens = col.offsets[1:].to(torch.int64)[rows] - starts
    total = int(lens.sum()) if rows.shape[0] else 0
    seg, within = _segments(lens, total)
    flat = col.data[starts[seg] + within].cpu().numpy().tobytes()
    ends = np.cumsum(lens.cpu().numpy())
    return [flat[e - n:e] for e, n in zip(ends.tolist(),
                                          lens.cpu().numpy().tolist())]


def build_string_column(src: torch.Tensor, starts: torch.Tensor,
                        lens: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        host_patch: Optional[Dict[int, Optional[str]]]
                        = None,
                        fill_rows: Optional[torch.Tensor] = None,
                        fill_text: Optional[str] = None) -> Column:
    """STRING column from per-element spans into a flat uint8 tensor, on
    that tensor's device.

    src:    flat uint8 source (flatten a padded matrix with
            starts = row * row_width + col for matrix sources).
    starts/lens: per-element spans; elements with valid=False (or a
            host_patch value of None) become null rows.
    host_patch: {index: str|None} -- values produced by a host fallback
            path, written directly into the output bytes (per-row
            Python; for RARE fallback rows).
    fill_rows/fill_text: bool mask of rows that take the CONSTANT
            fill_text (for schema defaults that may cover most of the
            column).
    """
    device = src.device
    n = int(starts.shape[0])
    lens = lens.to(device=device, dtype=torch.int64)
    starts = starts.to(device=device, dtype=torch.int64)
    validity = (torch.ones(n, dtype=torch.bool, device=device)
                if valid is None else valid.to(device=device,
                                               dtype=torch.bool).clone())

    byte_lens = torch.where(validity, lens.clamp(min=0), 0)
    fill_b = None
    if fill_rows is not None and fill_text is not None:
        fill_rows = fill_rows.to(device=device, dtype=torch.bool)
        fill_b = torch.tensor(list(fill_text.encode("utf-8")),
                              dtype=torch.uint8, device=device)
        validity = validity | fill_rows
        byte_lens = torch.where(fill_rows, fill_b.shape[0], byte_lens)
    patch_idx = patch_bytes = patch_lens = None
    if host_patch:
        idx = sorted(host_patch)
        enc = [None if host_patch[i] is None
               else host_patch[i].encode("utf-8") for i in idx]
        patch_idx = torch.tensor(idx, dtype=torch.int64, device=device)
        patch_lens = torch.tensor([0 if b is None else len(b) for b in enc],
                                  dtype=torch.int64, device=device)
        validity[patch_idx] = torch.tensor(
            [b is not None for b in enc], dtype=torch.bool, device=device)
        byte_lens[patch_idx] = patch_lens
        patch_bytes = torch.from_numpy(np.frombuffer(
            b"".join(b for b in enc if b is not None), np.uint8).copy()
        ).to(device)

    offs = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(byte_lens, 0, out=offs[1:])
    total = int(offs[-1])
    buf = torch.zeros(total, dtype=torch.uint8, device=device)
    if total:
        dev_mask = byte_lens > 0
        if fill_b is not None:
            dev_mask &= ~fill_rows
        if patch_idx is not None:
            dev_mask[patch_idx] = False
        didx = torch.nonzero(dev_mask).squeeze(1)
        if didx.shape[0]:
            seg_len = byte_lens[didx]
            seg, within = _segments(seg_len, int(seg_len.sum()))
            buf[offs[didx][seg] + within] = src[
                torch.clamp(starts[didx][seg] + within,
                            max=max(src.shape[0] - 1, 0))]
        if fill_b is not None and fill_b.shape[0]:
            fidx = torch.nonzero(fill_rows).squeeze(1)
            if fidx.shape[0]:
                k = fill_b.shape[0]
                pos = (offs[fidx].repeat_interleave(k)
                       + torch.arange(k, device=device).repeat(
                           fidx.shape[0]))
                buf[pos] = fill_b.repeat(fidx.shape[0])
        if patch_idx is not None:
            seg, within = _segments(patch_lens, int(patch_lens.sum()))
            buf[offs[patch_idx][seg] + within] = patch_bytes

    v = None if bool(validity.all()) else validity.to(torch.uint8)
    return Column(dtypes.STRING, n, data=buf, validity=v,
                  offsets=offs.to(torch.int32))
