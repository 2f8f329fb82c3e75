"""JCUDF row assembly and disassembly: hand-written CUDA kernels for
Hopper, and their plain PyTorch versions.

`assemble_rows` (to-rows) and `disassemble_rows` (from-rows) are the
wrappers that ops/row_conversion.py calls.  For tensors on the card each
launches its kernel from csrc/row_assembly.cu (built by
utils/cuda_build.py at first use) on the current stream, or raises; for
tensors on the CPU each runs its plain version.  There is no other
switch and no fallback from the card to the plain version.

  * to-rows replaces the TPU tile kernel `assemble_rows_pallas`
    (spark_rapids_tpu/ops/row_assembly_pallas.py:47); its plain version
    `assemble_rows_plain` is row_conversion._assemble_fixed_words (the
    word-stack path).  The kernel follows a per-schema plan
    (`to_rows_plan`, `to_rows_tile`); `assemble_rows_by_plan` applies
    the plan in plain PyTorch, for the CPU tests.
  * from-rows replaces `disassemble_rows_pallas` (:136) together with the
    table rebuild of `convert_from_rows_pallas` (:201): the kernel writes
    each column in its native width plus a (ncols, rows) uint8 validity
    matrix; the plain version `disassemble_rows_plain` extracts (word,
    shift, nbits) fields from the (rows, W) word matrix
    (`build_extract_plan`) and rebuilds them.
  * variable-width to-rows (`assemble_var_rows`, rows with strings)
    replaces `paste_strings_pallas` (:281) together with the padded
    (rows, max_row) matrix and the compaction around it: the kernel
    builds each tile of rows in shared memory and writes it as one
    contiguous range, or, for a tile that outgrows its buffer
    (`var_tile`, `var_direct_tiles`), writes its rows straight to their
    offsets.  Its plain version
    `assemble_var_rows_plain` is the JAX package's path: the fixed
    section into a zeroed (rows, max_row) matrix, each string column
    pasted by `paste_strings_plain` (exactly B3's function), then
    compacted to the row offsets.

The kernels are bound by device-memory bytes (see the source for the
bounds at the main-path shapes).  `LAUNCHES` counts kernel launches only
(under a lock: the query server's pool threads launch concurrently).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.analysis.lockdep import make_lock
from spark_rapids_tpu_torch.columns.dtypes import DType, Kind
from spark_rapids_tpu_torch.ops.row_conversion import (
    JCUDF_ROW_ALIGNMENT, _col_byte_size, _round_up, field_word_slots)
# the plain to-rows version: row_conversion's word-stack assembly
from spark_rapids_tpu_torch.ops.row_conversion import \
    _assemble_fixed_words as assemble_rows_plain
from spark_rapids_tpu_torch.utils import cuda_build

LAUNCHES: Dict[str, int] = {"to_rows": 0, "from_rows": 0, "to_rows_var": 0}
_LAUNCHES_LOCK = make_lock("row_assembly.launches")


def _launched(name: str) -> None:
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1

_SIGNATURES = {
    # (cols, plan, rows, ncols, nruns, nnarrow, npieces, ndyn, ncst,
    #  nchunks, stage_bytes, row_size, log2_tile, stages, flags, out, stream)
    "srt_to_rows": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        *[ctypes.c_int] * 12, ctypes.c_void_p, ctypes.c_void_p]),
    # (cols, ncols, str_idx, nstr, rows, fixed_size, validity_offset,
    #  row_offsets, log2_tile, buf_bytes, out, stream)
    "srt_to_rows_var": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]),
    # (rows_buf, rows, row_size, validity_offset, cols, ncols, valid_out,
    #  log2_tile, stream)
    "srt_from_rows": (ctypes.c_int, [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]),
}

_TILE_BYTES = 48 * 1024          # shared memory a tile aims for
_MAX_TILE_BYTES = 227 * 1024     # shared memory one block can have
_MAX_TILE_ROWS = 256
# the variable-width kernel: row bytes a tile aims for (32 rows of the
# JNI-door table's 1132-byte rows, the fastest of 16 to 128 on the H100,
# PERF.md), and the least room its row buffer leaves above the tile's mean
# rows
_VAR_TILE_BYTES = 48 * 1024
_VAR_SLACK = 1 / 16
_SM_SHARED_BYTES = 228 * 1024    # shared memory of one SM
_BLOCK_RESERVED = 1024           # of it, kept by the card for each block
_MAX_BLOCKS_PER_SM = 8           # of 256 threads (2048 threads an SM)
# the fixed-width to-rows kernel: row bytes and rows a tile aims for,
# the most buffers in its ring (the fastest on the H100 at the bench and
# flagship shapes, PERF.md), and its flags (csrc/row_assembly.cu:
# kPlanInShared, kDescInShared, kNarrowStaged, kMaxStages)
_TO_ROWS_TILE_BYTES = 48 * 1024
_TO_ROWS_MAX_ROWS = 512
_TO_ROWS_MAX_STAGES = 4
PLAN_IN_SHARED = 1
DESC_IN_SHARED = 2
NARROW_STAGED = 4


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def tile_log2(row_size: int) -> int:
    """log2 of the rows per block: the most (a power of two, at most 256)
    whose tile of row_size-byte rows fits in 48 KB, at least one row."""
    if row_size > _MAX_TILE_BYTES:
        raise ValueError(
            f"JCUDF rows of {row_size} bytes exceed one block's shared "
            f"memory ({_MAX_TILE_BYTES} bytes)")
    lg = 0
    while (2 << lg) <= _MAX_TILE_ROWS and (2 << lg) * row_size <= _TILE_BYTES:
        lg += 1
    return lg


def var_smem_bytes(buf_bytes: int, ncols: int, nstr: int,
                   tile_rows: int) -> int:
    """Shared memory of one variable-width block: the row buffer, the
    (ncols, 5) int64 descriptors and the int32 arrays of the tile
    (csrc/row_assembly.cu, var_smem_layout)."""
    return (buf_bytes + 40 * ncols
            + 4 * ((nstr + 1) * (2 * tile_rows + 1) + 2 * nstr + 1))


def var_tile(fixed_size: int, rows: int, total: int, ncols: int, nstr: int,
             log2_tile=None) -> Tuple[int, int]:
    """(log2 of the rows per block, bytes of the row buffer) of the
    variable-width kernel for `rows` rows of `total` bytes in all.  The
    tile holds the most rows (a power of two, at most 256) whose mean size
    fits in _VAR_TILE_BYTES, at least one, unless `log2_tile` is given.
    The buffer holds at least that many mean rows plus 1/16 and 16 bytes,
    and the tile's fixed sections; it then grows to the share of an SM's
    shared memory that leaves as many blocks on an SM, within one block's
    limit.  A tile whose rows exceed it takes the kernel's direct path."""
    fixed_row = _round_up(fixed_size, JCUDF_ROW_ALIGNMENT)
    mean = max(total / max(rows, 1), fixed_row)
    if log2_tile is None:
        log2_tile = 0
        while ((2 << log2_tile) <= _MAX_TILE_ROWS
               and (2 << log2_tile) * mean <= _VAR_TILE_BYTES):
            log2_tile += 1
    tile_rows = 1 << log2_tile
    extra = var_smem_bytes(0, ncols, nstr, tile_rows)
    least = _round_up(tile_rows * fixed_row, 16)
    room = (_MAX_TILE_BYTES - extra) // 16 * 16
    if least > room:
        raise ValueError(
            f"{tile_rows} JCUDF fixed sections of {fixed_row} bytes and "
            f"{ncols} column descriptors exceed one block's shared memory "
            f"({_MAX_TILE_BYTES} bytes)")
    want = max(_round_up(int(tile_rows * mean * (1 + _VAR_SLACK)) + 16, 16),
               least)
    blocks = max(1, min(_MAX_BLOCKS_PER_SM, _SM_SHARED_BYTES
                        // (want + extra + _BLOCK_RESERVED)))
    share = (_SM_SHARED_BYTES // blocks - _BLOCK_RESERVED - extra) // 16 * 16
    return log2_tile, min(max(want, share), room)


def var_direct_tiles(offsets: torch.Tensor, log2_tile: int,
                     buf_bytes: int) -> int:
    """How many tiles the variable-width kernel writes by its direct path:
    those whose rows span more than buf_bytes - 8 bytes (the kernel's own
    test on the (rows+1,) row offsets)."""
    o = offsets.to(torch.int64)
    rows = o.shape[0] - 1
    t = 1 << log2_tile
    first = torch.arange(0, rows, t, device=o.device)
    span = o[torch.clamp(first + t, max=rows)] - o[first]
    return int((span + 8 > buf_bytes).sum())


def _lib() -> ctypes.CDLL:
    return cuda_build.load("row_assembly", _SIGNATURES)


def _check_cuda(t: torch.Tensor, what: str, dtype: torch.dtype,
                shape: Tuple[int, ...], device: torch.device,
                align: int) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {dtype} {shape}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % align:
        raise ValueError(f"{what} must be contiguous and {align}-byte "
                         f"aligned")


def _launch_error(kernel: str, err: int) -> RuntimeError:
    return RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


# ------------------------------------------------------------- to-rows


class ToRowsPlan(NamedTuple):
    """The fixed-width to-rows kernel's plan for one schema and tile
    (layout in csrc/row_assembly.cu, above ToRowsShape): `ints` are the
    int32s the kernel reads, the rest its counts."""
    ints: Tuple[int, ...]
    ncols: int
    nruns: int
    nnarrow: int
    npieces: int
    ndyn: int
    ncst: int
    nchunks: int
    stage_bytes: int
    log2_tile: int


@functools.lru_cache(maxsize=64)
def to_rows_plan(widths: Tuple[int, ...], starts: Tuple[int, ...],
                 nullable: Tuple[bool, ...], validity_offset: int,
                 log2_tile: int) -> ToRowsPlan:
    """The plan of a schema (each column's field width and start, whether
    it has validity, the row's validity offset) for tiles of 2^log2_tile
    rows (at most 2048: a run's chunk index has 8 bits)."""
    tile = 1 << log2_tile
    if tile > 2048:
        raise ValueError(f"to-rows tiles of {tile} rows exceed 2048")
    ncols = len(widths)
    narrow = [c for c in range(ncols) if widths[c] < 4]
    vcols = [c for c in range(ncols) if nullable[c]]
    runs, vq, chunks = [], [-1] * ncols, []
    at = 0
    for c, w in [(c, widths[c]) for c in narrow] + [(c, 0) for c in vcols]:
        if not w:
            vq[c] = at
        runs += [c, at, w, starts[c] if w else 0]
        chunks += [(len(runs) // 4 - 1) << 8 | k
                   for k in range(-(-tile * max(w, 1) // 16))]
        at += _round_up(tile * max(w, 1), 16)
    pieces = []
    for c, (w, st) in enumerate(zip(widths, starts)):
        if w >= 4:
            code = (w.bit_length() - 1) << 2 | (w >= 8)
            pieces += [c, st << 8 | code]
            if w == 16:
                pieces += [c, (st + 8) << 8 | 32 | code]
    dyn, cst = [], []
    for j in range((ncols + 7) // 8):
        const = mask = 0
        for k, c in enumerate(range(8 * j, min(8 * j + 8, ncols))):
            if nullable[c]:
                mask |= 1 << k
            else:
                const |= 1 << k
        (dyn if mask else cst).extend(
            [validity_offset + j, const | mask << 8 | j << 16])
    ints = runs + pieces + dyn + cst + chunks + vq
    return ToRowsPlan(tuple(ints), ncols, len(runs) // 4, len(narrow),
                      len(pieces) // 2, len(dyn) // 2, len(cst) // 2,
                      len(chunks), at, log2_tile)


def schema_key(cols, starts: Sequence[int], validity_offset: int):
    """The to-rows plan's key of fixed-width columns: their widths,
    starts, whether each has validity, and the validity offset."""
    return (tuple(_col_byte_size(c.dtype) for c in cols), tuple(starts),
            tuple(c.validity is not None for c in cols), validity_offset)


@functools.lru_cache(maxsize=64)
def _plan_tensor(plan: ToRowsPlan, device: torch.device) -> torch.Tensor:
    return torch.tensor(plan.ints, dtype=torch.int32).to(device)


def to_rows_smem_bytes(plan: ToRowsPlan, row_size: int, stages: int,
                       flags: int) -> int:
    """Shared memory of one to-rows block (csrc/row_assembly.cu,
    to_rows_smem_layout): a ring of `stages` buffers, each a tile of rows
    and, when narrow runs are staged, their staging area; then the plan
    and the (ncols, 5) int64 descriptors as `flags` say."""
    buf = _round_up(row_size << plan.log2_tile, 16)
    if flags & NARROW_STAGED:
        buf += plan.stage_bytes
    size = stages * buf
    if flags & PLAN_IN_SHARED:
        size += _round_up(4 * len(plan.ints), 16)
    if flags & DESC_IN_SHARED:
        size += 40 * plan.ncols
    return size


def _blocks_per_sm(smem: int) -> int:
    return min(_MAX_BLOCKS_PER_SM,
               _SM_SHARED_BYTES // (smem + _BLOCK_RESERVED))


@functools.lru_cache(maxsize=64)
def to_rows_tile(key, row_size: int, log2_tile=None,
                 stages=None) -> Tuple[ToRowsPlan, int, int]:
    """(plan, ring buffers, flags) of the to-rows kernel for the schema
    `key` (widths, starts, nullable, validity offset).  The tile holds
    the most rows (a power of two, at most _TO_ROWS_MAX_ROWS) within
    _TO_ROWS_TILE_BYTES, at least one.  Of the rings of 1 to
    _TO_ROWS_MAX_STAGES buffers that fit one block, the one that keeps
    the most tiles in flight on an SM (buffers x blocks an SM by shared
    memory), the fewest buffers on a tie; narrow runs staged where that
    fits (tiles of 16 rows or more), else read from device memory; else
    half the rows.  The plan, then the descriptors, go to shared memory
    where they fit.  `log2_tile` and `stages` set the tile and the most
    buffers, taken when they fit (for timing)."""
    if row_size > _MAX_TILE_BYTES:
        raise ValueError(
            f"JCUDF rows of {row_size} bytes exceed one block's shared "
            f"memory ({_MAX_TILE_BYTES} bytes)")
    lg = log2_tile
    if lg is None:
        lg = 0
        while ((2 << lg) <= _TO_ROWS_MAX_ROWS
               and (2 << lg) * row_size <= _TO_ROWS_TILE_BYTES):
            lg += 1
    counts = (range(1, _TO_ROWS_MAX_STAGES + 1) if stages is None
              else range(stages, 0, -1))
    while True:
        plan = to_rows_plan(*key, lg)
        best = None
        for st in counts:
            # staged runs are whole 16-byte chunks from 16 rows on
            for flags in (NARROW_STAGED, 0) if lg >= 4 else (0,):
                if to_rows_smem_bytes(plan, row_size, st,
                                      flags) > _MAX_TILE_BYTES:
                    continue
                for f in (PLAN_IN_SHARED, DESC_IN_SHARED):
                    if to_rows_smem_bytes(plan, row_size, st,
                                          flags | f) <= _MAX_TILE_BYTES:
                        flags |= f
                in_flight = st * _blocks_per_sm(
                    to_rows_smem_bytes(plan, row_size, st, flags))
                score = (bool(flags & NARROW_STAGED), in_flight)
                if best is None or score > best[0]:
                    best = (score, st, flags)
                break
            if best is not None and stages is not None:
                break
        if best is not None:
            return plan, best[1], best[2]
        lg -= 1   # one row always fits: row_size <= _MAX_TILE_BYTES


def assemble_rows(cols, starts: Sequence[int], validity_offset: int,
                  row_size: int) -> torch.Tensor:
    """Flat (rows * row_size,) uint8 JCUDF rows of fixed-width columns."""
    device = cols[0].data.device
    if device.type == "cpu":
        return assemble_rows_plain(cols, starts, validity_offset, row_size)
    desc_t, _str_idx = to_rows_descriptors(cols, starts)
    rows = cols[0].length
    out = torch.empty((rows * row_size,), dtype=torch.uint8, device=device)
    if rows:
        launch_to_rows(desc_t, schema_key(cols, starts, validity_offset),
                       rows, row_size, out)
    return out


def to_rows_descriptors(cols, starts: Sequence[int]):
    """Check the columns against what the to-rows kernels take and return
    their descriptors on the columns' device, uploaded together: the
    (ncols, 5) int64 rows (data or chars ptr, validity ptr or 0, width,
    start, string offsets ptr or 0) and the (nstr,) int64 indices of the
    string columns."""
    device = cols[0].data.device
    if device.type != "cuda":
        raise ValueError(f"no to-rows kernel for {device.type} tensors")
    rows = cols[0].length
    descs = []
    str_idx = []
    for ci, (c, st) in enumerate(zip(cols, starts)):
        width = _col_byte_size(c.dtype)
        optr = 0
        if c.dtype.is_string:
            _check_cuda(c.data, f"column {ci} chars", torch.uint8,
                        (c.data.shape[0],), device, 1)
            _check_cuda(c.offsets, f"column {ci} offsets", torch.int32,
                        (rows + 1,), device, 4)
            optr = c.offsets.data_ptr()
            str_idx.append(ci)
        else:
            shape = ((rows, 4) if c.dtype.kind == Kind.DECIMAL128
                     else (rows,))
            _check_cuda(c.data, f"column {ci} data", c.dtype.torch_dtype,
                        shape, device, min(width, 8))
        vptr = 0
        if c.validity is not None:
            _check_cuda(c.validity, f"column {ci} validity", torch.uint8,
                        (rows,), device, 1)
            vptr = c.validity.data_ptr()
        descs.extend((c.data.data_ptr(), vptr, width, st, optr))
    packed = torch.tensor(descs + str_idx, dtype=torch.int64).to(device)
    return packed[:len(descs)].view(-1, 5), packed[len(descs):]


def launch_to_rows(desc_t: torch.Tensor, key, rows: int, row_size: int,
                   out: torch.Tensor, log2_tile=None, stages=None) -> None:
    """The to-rows kernel launch alone, on `to_rows_descriptors`' output,
    the columns' schema key (`schema_key`) and a (rows * row_size,) uint8
    buffer on the same device.  The tile is `to_rows_tile`'s."""
    lib = _lib()
    plan, stages, flags = to_rows_tile(key, row_size, log2_tile, stages)
    with torch.cuda.device(out.device):
        err = lib.srt_to_rows(
            desc_t.data_ptr(), _plan_tensor(plan, out.device).data_ptr(),
            rows, plan.ncols, plan.nruns, plan.nnarrow, plan.npieces,
            plan.ndyn, plan.ncst, plan.nchunks, plan.stage_bytes, row_size,
            plan.log2_tile, stages, flags, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise _launch_error("to-rows", err)
    _launched("to_rows")


def assemble_rows_by_plan(cols, starts: Sequence[int], validity_offset: int,
                          row_size: int, log2_tile: int,
                          staged: bool) -> torch.Tensor:
    """The to-rows kernel's steps in plain PyTorch on CPU tensors, a
    mirror of its plan: per tile, a zeroed row-major tile with the
    constant validity bytes, each wider field's pieces copied to their
    place, the narrow and validity runs staged at the plan's offsets
    (`staged`) or read from the columns, the narrow fields and the
    nullable validity bytes filled in.  Gives assemble_rows_plain's
    bytes."""
    plan = to_rows_plan(*schema_key(cols, starts, validity_offset),
                        log2_tile)
    ints = list(plan.ints)
    at = 0

    def take(n, k):
        nonlocal at
        part = ints[at:at + n * k]
        at += n * k
        return [part[i:i + k] for i in range(0, len(part), k)]

    runs = take(plan.nruns, 4)
    pieces = take(plan.npieces, 2)
    dyn = take(plan.ndyn, 2)
    cst = take(plan.ncst, 2)
    chunks = [x[0] for x in take(plan.nchunks, 1)]
    vq = [x[0] for x in take(plan.ncols, 1)]
    rows = cols[0].length
    data = [c.data.contiguous().view(torch.uint8).reshape(rows, -1)
            for c in cols]
    out = torch.empty((rows, row_size), dtype=torch.uint8)
    tile = 1 << log2_tile
    for row0 in range(0, rows, tile):
        n = min(tile, rows - row0)
        buf = torch.zeros((tile, row_size), dtype=torch.uint8)
        for pos, y in cst:
            buf[:, pos] = y & 0xFF
        for c, y in pieces:
            size, lo = 8 if y & 1 else 4, 8 if y & 32 else 0
            buf[:n, y >> 8:(y >> 8) + size] = data[c][row0:row0 + n,
                                                      lo:lo + size]
        st = torch.zeros((plan.stage_bytes,), dtype=torch.uint8)
        for ck in chunks if staged else ():
            c, q, w, _start = runs[ck >> 8]
            src = (data[c][row0:row0 + n] if w
                   else cols[c].validity[row0:row0 + n]).reshape(-1)
            off = (ck & 255) * 16
            piece = src[off:off + 16]
            st[q + off:q + off + piece.numel()] = piece
        for c, q, w, start in runs[:plan.nnarrow]:
            src = (st[q:q + n * w].view(n, w) if staged
                   else data[c][row0:row0 + n])
            buf[:n, start:start + w] = src
        for pos, y in dyn:
            bits = torch.full((n,), y & 0xFF, dtype=torch.uint8)
            for k in range(8):
                if (y >> (8 + k)) & 1:
                    c = (y >> 16) * 8 + k
                    v = (st[vq[c]:vq[c] + n] if staged
                         else cols[c].validity[row0:row0 + n])
                    bits |= (v != 0).to(torch.uint8) << k
            buf[:n, pos] = bits
        out[row0:row0 + n] = buf[:n]
    return out.reshape(-1)


# ------------------------------------------------ variable-width to-rows


def paste_strings_plain(mat: torch.Tensor, chars: torch.Tensor,
                        vstart: torch.Tensor,
                        lens: torch.Tensor) -> torch.Tensor:
    """B3's function (`paste_strings_pallas`): each byte p of row r of the
    (rows, max_row) uint8 matrix becomes chars[r, p - vstart[r]] where
    0 <= p - vstart[r] < min(lens[r], pad), and keeps mat[r, p]
    elsewhere.  chars is (rows, pad) uint8; vstart and lens (rows,)."""
    pad = chars.shape[1]
    p = torch.arange(mat.shape[1], dtype=torch.int32, device=mat.device)
    src = p[None, :] - vstart.to(torch.int32)[:, None]
    in_span = (src >= 0) & (src < lens.to(torch.int32)[:, None]) & (src < pad)
    gathered = chars.gather(1, src.clamp_(0, pad - 1).to(torch.int64))
    return torch.where(in_span, gathered, mat)


def _compact(mat: torch.Tensor, row_sizes: torch.Tensor) -> torch.Tensor:
    """(rows, max_row) padded matrix -> flat uint8 of each row's first
    row_sizes[r] bytes, rows in order."""
    p = torch.arange(mat.shape[1], device=mat.device)
    return mat[p[None, :] < row_sizes[:, None]]


def assemble_var_rows_plain(cols, starts: Sequence[int],
                            validity_offset: int, fixed_size: int,
                            offsets: torch.Tensor) -> torch.Tensor:
    """Plain variable-width to-rows: the fixed section (string fields as
    (start in row, length) pairs) into a zeroed (rows, max_row) matrix,
    each string column pasted with paste_strings_plain, then compacted to
    the (rows+1,) int32 row offsets.  Returns the flat uint8 rows."""
    rows = cols[0].length
    device = cols[0].device
    if not rows:
        return torch.zeros((0,), dtype=torch.uint8, device=device)
    str_cols = [c for c in cols if c.dtype.is_string]
    pairs = []
    vstart = torch.full((rows,), fixed_size, dtype=torch.int32, device=device)
    for c in str_cols:
        lens = c.string_lengths()
        pairs.append((vstart, lens))
        vstart = vstart + lens
    fixed_row = _round_up(fixed_size, JCUDF_ROW_ALIGNMENT)
    fixed = assemble_rows_plain(cols, starts, validity_offset, fixed_row,
                                pairs).view(rows, fixed_row)
    row_sizes = offsets[1:] - offsets[:-1]
    mat = torch.nn.functional.pad(fixed,
                                  (0, int(row_sizes.max()) - fixed_row))
    for c, (vs, lens) in zip(str_cols, pairs):
        chars, _ = c.to_padded_chars(max(1, c.max_string_length()))
        mat = paste_strings_plain(mat, chars, vs, lens)
    return _compact(mat, row_sizes)


def assemble_var_rows(cols, starts: Sequence[int], validity_offset: int,
                      fixed_size: int, offsets: torch.Tensor,
                      total: int) -> torch.Tensor:
    """Flat (total,) uint8 JCUDF rows of a table with strings, at the
    (rows+1,) int32 row offsets that row_conversion.var_row_offsets
    gives (total = offsets[-1])."""
    device = cols[0].data.device
    if device.type == "cpu":
        return assemble_var_rows_plain(cols, starts, validity_offset,
                                       fixed_size, offsets)
    desc_t, str_idx = to_rows_descriptors(cols, starts)
    rows = cols[0].length
    _check_cuda(offsets, "row offsets", torch.int32, (rows + 1,), device, 4)
    out = torch.empty((total,), dtype=torch.uint8, device=device)
    if rows:
        launch_to_rows_var(desc_t, str_idx, rows, fixed_size,
                           validity_offset, offsets, out)
    return out


def launch_to_rows_var(desc_t: torch.Tensor, str_idx: torch.Tensor,
                       rows: int, fixed_size: int, validity_offset: int,
                       offsets: torch.Tensor, out: torch.Tensor,
                       log2_tile=None) -> None:
    """The variable-width to-rows kernel launch alone, on
    `to_rows_descriptors`' output, checked row offsets and a uint8
    buffer of offsets[-1] bytes on the same device.  The tile is
    `var_tile`'s (`log2_tile` sets its rows)."""
    lib = _lib()
    log2_tile, buf_bytes = var_tile(fixed_size, rows, out.shape[0],
                                    desc_t.shape[0], str_idx.shape[0],
                                    log2_tile)
    with torch.cuda.device(out.device):
        err = lib.srt_to_rows_var(
            desc_t.data_ptr(), desc_t.shape[0], str_idx.data_ptr(),
            str_idx.shape[0], rows, fixed_size, validity_offset,
            offsets.data_ptr(), log2_tile, buf_bytes, out.data_ptr(),
            torch.cuda.current_stream(out.device).cuda_stream)
    if err:
        raise _launch_error("variable-width to-rows", err)
    _launched("to_rows_var")


# ----------------------------------------------------------- from-rows


def build_extract_plan(schema, starts, validity_offset, n_words):
    """Per-logical-field (word, shift, nbits) extraction entries for a
    fixed-width JCUDF schema + per-column validity entries.  Field
    coordinates come from row_conversion.field_word_slots, the same
    layout source the assembly direction consumes."""
    plan: List[Tuple[int, int, int]] = []
    col_entries: List[List[int]] = []
    for dt, st in zip(schema, starts):
        entries = []
        for slot in field_word_slots(dt, st):
            entries.append(len(plan))
            plan.append(slot)
        col_entries.append(entries)
    valid_entries: List[int] = []
    for ci in range(len(schema)):
        off = validity_offset + ci // 8
        valid_entries.append(len(plan))
        plan.append((off // 4, (off % 4) * 8 + (ci % 8), 1))
    if any(w >= n_words for w, _sh, _nb in plan):
        raise ValueError(f"layout needs more than {n_words} words per row")
    return plan, col_entries, valid_entries


def _rebuild(dt: DType, es: List[torch.Tensor]) -> torch.Tensor:
    """A column's data from its extracted int32 fields."""
    if dt.kind == Kind.DECIMAL128:
        return torch.stack(es, dim=1)
    size = _col_byte_size(dt)
    if size == 8:
        u = (es[0].to(torch.int64) & 0xFFFFFFFF) | (es[1].to(torch.int64)
                                                    << 32)
        return u.view(dt.torch_dtype)
    if size == 4:
        # a column of the word matrix: copy it into storage of its own.
        # `.contiguous()` is not enough: a one-row column counts as
        # contiguous whatever its stride, and would alias the rows.
        dense = torch.empty(es[0].shape, dtype=torch.int32,
                            device=es[0].device)
        return dense.copy_(es[0]).view(dt.torch_dtype)
    narrow = torch.int16 if size == 2 else torch.uint8
    return es[0].to(narrow).view(dt.torch_dtype)


def disassemble_rows_plain(row_bytes: torch.Tensor, schema: Sequence[DType],
                           starts: Sequence[int], validity_offset: int,
                           row_size: int):
    """Plain from-rows: ([per-column data], (ncols, rows) uint8 validity)."""
    n_words = row_size // 4
    rows = row_bytes.shape[0] // row_size
    words = row_bytes.view(torch.int32).view(rows, n_words)
    plan, col_entries, valid_entries = build_extract_plan(
        schema, starts, validity_offset, n_words)
    pieces = []
    for w, sh, nbits in plan:
        v = words[:, w]
        if sh:
            v = v >> sh
        if nbits < 32:
            v = v & ((1 << nbits) - 1)
        pieces.append(v)
    datas = [_rebuild(dt, [pieces[e] for e in col_entries[ci]])
             for ci, dt in enumerate(schema)]
    valid = torch.stack([pieces[e] for e in valid_entries]).to(torch.uint8)
    return datas, valid


def disassemble_rows(row_bytes: torch.Tensor, schema: Sequence[DType],
                     starts: Sequence[int], validity_offset: int,
                     row_size: int):
    """([per-column data], (ncols, rows) uint8 validity) from a flat
    uint8 buffer of uniform JCUDF rows."""
    device = row_bytes.device
    if device.type == "cpu":
        return disassemble_rows_plain(row_bytes, schema, starts,
                                      validity_offset, row_size)
    if device.type != "cuda":
        raise ValueError(f"no from-rows kernel for {device.type} tensors")
    if row_bytes.dim() != 1 or row_bytes.shape[0] % row_size:
        raise ValueError(f"row buffer of shape {tuple(row_bytes.shape)} is "
                         f"not whole rows of {row_size} bytes")
    rows = row_bytes.shape[0] // row_size
    _check_cuda(row_bytes, "row buffer", torch.uint8, (rows * row_size,),
                device, 8)
    datas, valid, desc_t = from_rows_outputs(schema, starts, rows, device)
    if rows:
        launch_from_rows(row_bytes, rows, row_size, validity_offset, desc_t,
                         valid)
    return datas, valid


def from_rows_outputs(schema: Sequence[DType], starts: Sequence[int],
                      rows: int, device: torch.device):
    """The from-rows kernel's outputs, allocated: ([per-column data],
    (ncols, rows) uint8 validity, (ncols, 4) int64 descriptors (output
    ptr, width, start, 0) on `device`)."""
    datas = [torch.empty((rows, 4) if dt.kind == Kind.DECIMAL128
                         else (rows,), dtype=dt.torch_dtype, device=device)
             for dt in schema]
    valid = torch.empty((len(schema), rows), dtype=torch.uint8,
                        device=device)
    descs = [(d.data_ptr(), _col_byte_size(dt), st, 0)
             for d, dt, st in zip(datas, schema, starts)]
    return datas, valid, torch.tensor(descs, dtype=torch.int64).to(device)


def launch_from_rows(row_bytes: torch.Tensor, rows: int, row_size: int,
                     validity_offset: int, desc_t: torch.Tensor,
                     valid: torch.Tensor) -> None:
    """The from-rows kernel launch alone, on a checked row buffer and the
    outputs and descriptors of `from_rows_outputs`."""
    lib = _lib()
    with torch.cuda.device(row_bytes.device):
        err = lib.srt_from_rows(
            row_bytes.data_ptr(), rows, row_size, validity_offset,
            desc_t.data_ptr(), desc_t.shape[0], valid.data_ptr(),
            tile_log2(row_size),
            torch.cuda.current_stream(row_bytes.device).cuda_stream)
    if err:
        raise _launch_error("from-rows", err)
    _launched("from_rows")
