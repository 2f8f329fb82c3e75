#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

1. Prints the device and `nvidia-smi`'s name and power limit.
2. Builds the CUDA kernels from csrc/ with nvcc (-Xptxas -v report shown).
3. Holds each kernel byte for byte against its plain PyTorch version on
   the card.  Fixed-width to-rows and from-rows at (7 rows, 3 columns),
   (1000, 20 with DECIMAL128 and nulls), (2^16, 212 with every third
   column nullable), (2^16 + 7, 212: a ragged last tile), (64, 3000:
   rows too wide to stage), (1, 212), (4099, 212 with every column a
   view one element into its buffer: bases off 16-byte alignment) and
   the main paths' own inputs (the flagship table and the bench table
   below); variable-width to-rows at (7, 3 with one
   string), (1000, 20 with DECIMAL128, nulls, null strings that keep
   their bytes and string offsets that start past 0), (2^16, 155),
   (40, 150 with strings of up to 70000 bytes: every tile too long for
   the kernel's shared row buffer), (3000, 20) and (2000, 10) with strings
   of up to 2000 and 20000 bytes (some tiles too long), (4099, 31) (a row
   count that no timed tile size divides), (300, 17) whose strings are
   all empty, and the JNI-door table below.  Both of the kernel's paths
   (tiles staged in shared memory, and tiles written straight to device
   memory) must have been taken.
4. Runs each main path once, with the launch counts set to 0 just before
   it and read just after it:
   - the flagship step (hashes, to-rows, bucketed sums) on 2^22 rows,
     checked against the same step on the CPU;
   - the bench shape (212 cycled fixed-width columns x 2^19 rows, as in
     bench_impl.py): to-rows -> from-rows must give the input back, and
     the to-rows bytes must equal the plain version's;
   - the JNI-door round trip on a table with strings (155 columns cycling
     INT8, INT32, INT16, INT64, INT32, BOOL8, STRING, UINT16, UINT8,
     UINT64 x 2^20 rows; strings of 0-32 random bytes; every third column
     nullable, about 10% nulls), built on the card with
     interop.table_from_host and registered as handles: the shim's
     murmur_hash3_32 and xx_hash_64 over columns 1, 3 and 6 must equal the
     same calls on the CPU, convert_to_rows must equal the plain version
     byte for byte, convert_from_rows must give every column back, and
     every handle is released.
   Each path must have launched every kernel it runs.
5. Times each kernel with CUDA events after warm-up at its main path's
   shape, beside its plain version and its device-memory bound, and each
   main path's step (median wall time, synchronized).  The fixed-width
   to-rows kernel at three shapes (bench, flagship, and bench with every
   third column nullable), each beside a device-to-device copy of as
   many bytes (`copy_ms`), and at the TO_ROWS_TIMED tiles and ring
   buffers (each checked byte-equal first; printed on a
   `to_rows_variant_ms` line).  The variable-width kernel also at 16,
   32, 64 and 128 rows a tile, and on the 70000-byte strings case, where
   every tile takes its direct path.

6. Drives the TPC-DS stage path (plan/catalog.run_q5 and run_q72 through
   the stage IR, its compiler and the device join probe) at TPC-DS
   SF100's widths (BASELINE.json's north star): q5 over 2^25
   store_sales and 2^22 store_returns rows (about one executor's share
   of 8), 402 stores, a 14-day window of 60 days, join capacity 2^23;
   q72 over 2^22 catalog_sales and 2^21 inventory rows, 204,000 items,
   35 days, 16 weeks, join capacity 2^26.  q72's rows are cut below one
   share of 8 (about 18.0M catalog_sales and 49.9M inventory rows):
   there every catalog_sales row meets about 245 inventory rows of its
   item, about 4.4 billion join pairs, more slots than the card's 80 GB
   holds.  Each query runs in the fused engine (one
   torch.compile'd program per stage) and op by op: the two must give
   the same bytes, both must equal a vectorised numpy oracle over the
   same seeded arrays, and each stage must compile once.  Prints the
   pair totals, the capacity used, each stage's compile seconds, both
   engines' median of 5 synchronized calls and their peak device memory.
   A small q72 whose join capacity is far too small must double through
   the capacity retry on the card.  Then the catalog's other stage
   queries, each over 2^25 fact rows (about one executor's share of 8
   of SF100's 287,997,024 store_sales rows) at SF100's widths, in both
   engines against vectorised oracles (models/tpcds.*_arrays): q3
   (204,000 items, 1,825 days, 1,000 brands approximating i_brand_id's
   distinct count; years=5, manufacturer 3 of the generator's 8, month
   11, LIMIT 100), q9, q67 and CUBE (i_category_id's 10 by i_class_id's
   16) and q89 (402 stores x 204,000 items: 82.0M dense groups, the
   largest sort of the stage path).  The stage path launches none of
   the hand-written kernels.
7. The named query catalog: run_catalog_query for each of its eight
   names at the default parameters on the card, equal to the same call
   with device="cpu"; op by op on both (the fused engine on the card is
   step 6's).  Each name with a cancelled QueryContext must raise
   QueryCancelled and allocate no device memory.  A check of function
   only, untimed: the defaults' few thousand rows are not a query size.
8. GROUP BY and ORDER BY over one GPU batch of store_sales columns:
   2^25 rows of ss_store_sk INT32 (402 values), ss_item_sk INT32
   (204,000), ss_quantity INT32 (1-100), ss_sales_price INT64 cents and
   ss_net_paid FLOAT64 (never negative), the last three about 4% null:
   0.94 GB, near spark-rapids' default target batch size
   (spark.rapids.sql.batchSizeBytes, 1 GiB).  groupby_aggregate on
   (store, item), about 27M groups: sum(quantity), count(net_paid),
   min and max(price), sum and mean(net_paid); its device group ids
   against the host branch's on the same card data; sort_table by
   (store ASC, price DESC nulls last).  A STRING-keyed group-by and
   order_by at 2^22 rows (1,000 distinct keys of 8-50 bytes; the
   group-by takes the device branch, order_by sorts the strings' device
   key words) and the same group-by and order_by over 2^18 rows of
   257-400-byte keys (the group-by's host rank branch; order_by sorts
   the device words at any length).  Each equals the same call on a CPU copy, byte
   for byte except the float sums and means, which the card adds with
   atomics in a varying order: those are held to |card - cpu| <=
   4 * count * 2^-53 * sum|x| per group (plus 2 ulps for a mean).
   Prints the median of 5 synchronized calls (3 for the sorts), the
   peak device memory and the branch each group-by took.
9. The join layer (ops/joins.py, ops/hash_join.py, perf/calibrate.py)
   at one executor's share of 8 of TPC-DS SF100, each cell drawn on the
   card from a seed: J1 store_sales (2^25 rows, ss_customer_sk INT32
   about 4% null, NULL_UNEQUAL) x customer (SF100's 2,000,000 unique
   keys); J2 store_sales x 2^22 store_returns drawn from the sales rows
   on (ss_item_sk INT32, ss_ticket_number INT64); J3 q72's cut
   catalog_sales (2^22) x inventory (2^21) on 204,000 items, about
   43.1M pairs; J4 2^22 brand-like STRING keys of 8-50 bytes x a
   1,000-row brand dim, and 2^18 keys of 257-400 bytes x 200.  Every
   engine (host_rank, host_hash, device_sort, device_hash) runs by
   name on every cell and must equal a numpy oracle byte for byte
   (int32 pairs on the card); the device engines are timed as the
   median of 5 synchronized calls, the host engines once, each with
   the peak device memory its first call added to what was already
   held (`peak_added_mb`); device_hash's first call must double its
   pair capacity on J3 and its second start from the learned one.
   Then the router unpinned, with its verdict file fresh under build/:
   its engine, its verdict and calibration seconds, and its pairs
   against the oracle (keys over 256 bytes must route host_rank).  The
   JNI door's sort_merge_inner_join on J1 through handles, every
   handle released; and models.query.simple_star_join_agg over 2^25
   store_sales rows x 204,000 items grouped by i_brand_id (1,000), SUM
   of INT64 cents and COUNT exact against numpy.  Ends with the
   seconds each phase took.

Prints a `{"kernels": [...]}` line and, last, `{"ok": true, "device":
{...}}`.  Any failed check raises, so the exit code is not 0 and no
result line is printed; so does a machine without a CUDA device.
"""

import contextlib
import itertools
import json
import os
import subprocess
import sys
import threading
import time

# compiled stages cache their programs inside the checkout
_BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR",
                      os.path.join(_BUILD, "inductor"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(_BUILD, "triton"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from spark_rapids_tpu_torch.columns import dtypes, interop  # noqa: E402
from spark_rapids_tpu_torch.columns.column import Column  # noqa: E402
from spark_rapids_tpu_torch.columns.table import Table  # noqa: E402
from spark_rapids_tpu_torch import models as TM  # noqa: E402
from spark_rapids_tpu_torch.models import flagship as F  # noqa: E402
from spark_rapids_tpu_torch.models import query as Q  # noqa: E402
from spark_rapids_tpu_torch.models import tpcds as TT  # noqa: E402
from spark_rapids_tpu_torch.ops import copying as CP  # noqa: E402
from spark_rapids_tpu_torch.ops import groupby as G  # noqa: E402
from spark_rapids_tpu_torch.ops import hash_join as HJ  # noqa: E402
from spark_rapids_tpu_torch.ops import joins as J  # noqa: E402
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA  # noqa: E402
from spark_rapids_tpu_torch.ops import row_conversion as RC  # noqa: E402
from spark_rapids_tpu_torch.ops import sorting as S  # noqa: E402
from spark_rapids_tpu_torch.plan import catalog as TC  # noqa: E402
from spark_rapids_tpu_torch.perf import calibrate as CAL  # noqa: E402
from spark_rapids_tpu_torch.plan.compiler import compile_stage  # noqa: E402
from spark_rapids_tpu_torch.shim import jni_api  # noqa: E402
from spark_rapids_tpu_torch.shim.handles import REGISTRY  # noqa: E402
from spark_rapids_tpu_torch.utils import cuda_build  # noqa: E402

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
BENCH_ROWS = 1 << 19
BENCH_COLS = 212
FLAGSHIP_ROWS = 1 << 22
TIMED_ITERS = 20
PLAIN_ITERS = 3
STEP_ITERS = 5
# (rows, columns, every n-th column nullable, every n-th column DECIMAL128,
# columns as views one element into their buffers): the fixed-width
# kernels' edges too, a ragged last tile, rows too wide to stage, one row,
# and column bases that are width-aligned but not 16-byte aligned
KERNEL_CASES = [(7, 3, 0, 0, 0), (1000, 20, 3, 11, 0),
                (1 << 16, 212, 3, 0, 0), ((1 << 16) + 7, 212, 3, 0, 0),
                (64, 3000, 0, 0, 0), (1, 212, 3, 11, 0),
                (4099, 212, 3, 11, 1)]
# (rows per tile (log2), ring buffers) at which the fixed-width to-rows
# kernel is timed beside the wrapper's choice, at the bench and flagship
# shapes
TO_ROWS_TIMED = {"bench": ((4, 2), (5, 1), (5, 2), (6, 1)),
                 "flagship": ((8, 2), (9, 1), (9, 2), (10, 2))}
# the string main path: the column cycle, after the upstream
# benchmarks/row_conversion.cpp variable_or_fixed_width case with strings
STRING_CYCLE = ["int8", "int32", "int16", "int64", "int32", "bool8",
                "string", "uint16", "uint8", "uint64"]
STRING_ROWS = 1 << 20
STRING_COLS = 155
STRING_MAX_LEN = 32
HASH_KEYS = (1, 3, 6)   # INT32, INT64, STRING
# (rows, columns, first cycle entry, every n-th column nullable, every
# n-th column DECIMAL128, string offsets' start, longest string)
LONG_STRINGS_CASE = (40, 150, 6, 3, 0, 0, 70000)
VAR_KERNEL_CASES = [(7, 3, 5, 0, 0, 0, 32), (1000, 20, 0, 3, 11, 5, 32),
                    (1 << 16, 155, 0, 3, 0, 0, 32), LONG_STRINGS_CASE,
                    (3000, 20, 0, 3, 0, 0, 2000),
                    (2000, 10, 6, 3, 0, 3, 20000),
                    (4099, 31, 3, 3, 0, 7, 32), (300, 17, 0, 3, 0, 0, 0)]
# rows per tile at which the variable-width kernel is timed (log2)
VAR_TIMED_TILES = (4, 5, 6, 7)
# the TPC-DS stage path at SF100's widths: 402 stores and 204,000 items
# are SF100's; days=60 (q5) and the inventory at half the catalog_sales
# rows over 35 days (q72) are the JAX package's registry entries
# (spark_rapids_tpu/models/__init__.py).  q5's rows are about one
# executor's share of 8 (SF100: 287,997,024 store_sales rows); q72's
# are cut to about a quarter of catalog_sales' share (143,997,065 / 8)
# and a 24th of inventory's (399,330,000 / 8), since a full share would
# join into about 4.4 billion pair slots, beyond the card's memory
Q5_DATA = dict(rows=1 << 25, stores=402, days=60, seed=5)
Q5_CAPACITY = 1 << 23      # about 7.83M sales pairs: no doubling
Q72_DATA = dict(cs_rows=1 << 22, inv_rows=1 << 21, items=204_000, days=35,
                seed=72)
Q72_CAPACITY = 1 << 26     # about 43.1M pairs: no doubling
Q72_MAX_WEEK = 16
Q72_WEEK0 = 11_000 // 7
Q72_LIMIT = 100
# far too small a join capacity: the retry must double it
Q72_SMALL_DATA = dict(cs_rows=1200, inv_rows=1200, items=4, days=35)
Q72_SMALL_CAPACITY = 1 << 12
# the catalog's other stage queries, each over 2^25 fact rows (about
# one executor's share of 8 of SF100's store_sales) at SF100's widths:
# 204,000 items and 402 stores are SF100's; 1,825 days are the five
# years of store_sales' date range; brands = 1,000 approximates
# i_brand_id's distinct count at SF100; q67's 10 categories and 16
# classes are i_category_id's 1-10 and i_class_id's 1-16.  The spreads
# are the JAX package's generators' (q3: 8 manufacturers, prices
# 100-49,999 cents; q9: quantities 1-100; q67: sales 100-49,999; q89:
# sales 100-29,999)
Q3_DATA = dict(rows=1 << 25, items=204_000, days=1_825, brands=1_000,
               seed=3)
Q3_BASE = 10_957
Q3_PARAMS = dict(years=5, manufact=3, month=11, limit=100)
Q9_DATA = dict(rows=1 << 25, seed=9)
Q67_DATA = dict(rows=1 << 25, ncat=10, ncls=16, seed=67)
Q89_DATA = dict(rows=1 << 25, stores=402, items=204_000, seed=89)
# the named queries, at the JAX package's default parameters
CATALOG_NAMES = ("tpcds_q3", "tpcds_q5", "tpcds_q7", "tpcds_q9",
                 "tpcds_q72", "tpcds_q3_fused", "tpcds_q5_fused",
                 "tpcds_q72_fused")
# one GPU batch of store_sales columns for the operators: 2^25 rows,
# 28 bytes a row (0.94 GB, near spark-rapids' default target batch of
# 1 GiB, spark.rapids.sql.batchSizeBytes), about 4% nulls in each value
# column
OPS_ROWS = 1 << 25
OPS_NULL_SHARE = 0.04
STR_OPS_ROWS = 1 << 22      # brand-like STRING keys, 8-50 bytes
STR_DISTINCT = 1_000
LONG_STR_ROWS = 1 << 18     # keys of 257-400 bytes: the host rank branch
LONG_STR_DISTINCT = 200
U53 = 2.0 ** -53
# the join layer at one executor's share of 8 of TPC-DS SF100: J1
# store_sales x customer (SF100's 2,000,000 rows, unique keys) on
# ss_customer_sk, about 4% null (dsdgen's nullable foreign key); J2
# store_sales x store_returns drawn from the sales rows on (item,
# ticket); J3 q72's catalog_sales x inventory on the item (q72's cut
# sizes above); J4 brand-like STRING keys against a brand dim, and keys
# over DEVICE_STR_KEY_MAX_LEN (the host_rank route); the star join
# store_sales x item grouped by i_brand_id
J1_ROWS = 1 << 25
J1_CUSTOMERS = 2_000_000
J1_NULL_SHARE = 0.04
J2_RETURNS = 1 << 22
J2_ITEMS_PER_TICKET = 10
J3_DATA = dict(cs_rows=1 << 22, inv_rows=1 << 21, items=204_000)
J4_DATA = dict(rows=STR_OPS_ROWS, distinct=STR_DISTINCT, lo=8, hi=50)
J4_LONG_DATA = dict(rows=LONG_STR_ROWS, distinct=LONG_STR_DISTINCT, lo=257,
                    hi=400)
STAR_ITEMS = 204_000
STAR_BRANDS = 1_000
JOIN_ENGINES = ("host_rank", "host_hash", "device_sort", "device_hash")
# the kernels each main path must launch
PATH_KERNELS = {"flagship_step": ("to_rows",),
                "bench_round_trip": ("to_rows", "from_rows"),
                "jni_door_round_trip": ("to_rows_var",),
                "tpcds_stage_path": (),
                "tpcds_catalog_entry": (),
                "operators_batch": (),
                "joins_batch": ()}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def make_table(rows, ncols, device, seed, nullable_every=0, dec128_every=0,
               view_offset=0):
    """Seeded table of the 8-dtype cycle bench_impl.py uses, drawn on the
    device; optional DECIMAL128 columns and nullable columns.  With
    `view_offset`, each column's data and validity are views that many
    elements into a longer buffer."""
    cycle = [dtypes.INT64, dtypes.INT32, dtypes.FLOAT64, dtypes.FLOAT32,
             dtypes.INT16, dtypes.INT8, dtypes.BOOL8,
             dtypes.TIMESTAMP_MICROS]
    g = torch.Generator(device=device).manual_seed(seed)

    def ints(lo, hi, dtype, shape=(rows,)):
        return torch.randint(lo, hi, shape, generator=g, dtype=dtype,
                             device=device)

    def at_offset(t):
        if not view_offset:
            return t
        buf = torch.zeros((t.shape[0] + view_offset,) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=device)
        buf[view_offset:] = t
        return buf[view_offset:]

    cols = []
    for i in range(ncols):
        dt = cycle[i % len(cycle)]
        if dec128_every and i % dec128_every == dec128_every - 1:
            dt = dtypes.decimal128(-2)
            data = ints(-2**31, 2**31, torch.int32, (rows, 4))
        elif dt.kind in ("float32", "float64"):
            data = torch.randn(rows, generator=g, dtype=dt.torch_dtype,
                               device=device)
        elif dt.kind == "bool8":
            data = ints(0, 2, torch.uint8)
        else:
            bits = 8 * dt.size_bytes
            data = ints(-2**(bits - 2), 2**(bits - 2), dt.torch_dtype)
        valid = None
        if nullable_every and i % nullable_every == 0:
            valid = ints(0, 2, torch.uint8)
        cols.append(Column(dt, rows, data=at_offset(data),
                           validity=None if valid is None
                           else at_offset(valid)))
    return Table(cols)


def string_host_specs(rows, ncols, seed, first=0, nullable_every=3,
                      dec128_every=0, skew=0, max_len=STRING_MAX_LEN):
    """Seeded host columns of STRING_CYCLE (from entry `first` on), drawn
    with numpy: integers over their whole range, strings of 0 to max_len
    random bytes whose offsets start at `skew`, and about 10% nulls in
    every n-th column.  A null string keeps its bytes and length."""
    rng = np.random.default_rng(seed)
    specs = []
    for i in range(ncols):
        kind = STRING_CYCLE[(first + i) % len(STRING_CYCLE)]
        if dec128_every and i % dec128_every == dec128_every - 1:
            kind = "decimal128"
        valid = None
        if nullable_every and i % nullable_every == 0:
            valid = (rng.random(rows) >= 0.1).astype(np.uint8)
        if kind == "string":
            offs = np.zeros(rows + 1, np.int64)
            np.cumsum(rng.integers(0, max_len + 1, rows),
                      out=offs[1:])
            offs += skew
            chars = rng.integers(0, 256, int(offs[-1]), dtype=np.uint8)
            specs.append((kind, chars, valid, offs.astype(np.int32)))
            continue
        if kind == "decimal128":
            data = rng.integers(-2**31, 2**31, (rows, 4)).astype(np.int32)
        elif kind == "bool8":
            data = rng.integers(0, 2, rows, dtype=np.uint8)
        else:
            dt = dtypes.DType(kind).np_dtype
            info = np.iinfo(dt)
            data = rng.integers(info.min, info.max, rows, dtype=dt,
                                endpoint=True)
        specs.append((kind, data, valid))
    return specs


def layout_of(table):
    """(field starts, validity offset, row size) of the table's rows."""
    schema = [c.dtype for c in table.columns]
    starts, voff, _fixed = RC.compute_layout(schema)
    return starts, voff, RC.row_size_of(schema)


def raw_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes in row-major order, as int16.  Copied into fresh
    storage first: torch counts a tensor whose only element has any
    stride as contiguous, and such a tensor cannot be viewed as bytes."""
    dense = torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)
    return dense.view(torch.uint8).reshape(-1).to(torch.int16)


def byte_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest absolute difference between two buffers' bytes."""
    a8 = raw_bytes(a)
    b8 = raw_bytes(b)
    check(a8.shape == b8.shape, f"byte lengths {a8.shape} vs {b8.shape}")
    return int((a8 - b8).abs().max()) if a8.numel() else 0


def compare_kernels(table):
    """Kernel vs plain version on the card for both directions; returns
    the largest byte error of each."""
    cols = table.columns
    starts, voff, row_size = layout_of(table)
    kern = RA.assemble_rows(cols, starts, voff, row_size)
    plain = RA.assemble_rows_plain(cols, starts, voff, row_size)
    err_to = byte_err(kern, plain)
    schema = [c.dtype for c in cols]
    kd, kv = RA.disassemble_rows(kern, schema, starts, voff, row_size)
    pd, pv = RA.disassemble_rows_plain(kern, schema, starts, voff, row_size)
    err_from = max([byte_err(a, b) for a, b in zip(kd, pd)]
                   + [byte_err(kv, pv)])
    torch.cuda.synchronize()
    for ci, c in enumerate(cols):   # and the round trip gives the input
        check(byte_err(kd[ci], c.data) == 0, f"round trip column {ci}")
        want = (torch.ones_like(kv[ci]) if c.validity is None
                else (c.validity != 0).to(torch.uint8))
        check(torch.equal(kv[ci], want), f"round trip validity {ci}")
    return err_to, err_from


def var_case_table(case, device):
    """The table of one VAR_KERNEL_CASES entry."""
    rows, ncols, first, nullable, dec, skew, max_len = case
    return interop.table_from_host(string_host_specs(
        rows, ncols, seed=rows + ncols, first=first,
        nullable_every=nullable, dec128_every=dec, skew=skew,
        max_len=max_len), device)


def compare_var_kernel(table):
    """Variable-width to-rows kernel vs its plain version on the card;
    returns the largest byte error."""
    cols = table.columns
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    kern = RA.assemble_var_rows(cols, starts, voff, fixed, offsets, total)
    plain = RA.assemble_var_rows_plain(cols, starts, voff, fixed, offsets)
    torch.cuda.synchronize()
    return byte_err(kern, plain)


def var_tiles(table):
    """(tiles, tiles the variable-width kernel writes by its direct path,
    rows per tile) for the table at the wrapper's tile."""
    cols = table.columns
    _starts, _voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    nstr = sum(c.dtype.is_string for c in cols)
    log2_tile, buf = RA.var_tile(fixed, table.num_rows, total, len(cols),
                                 nstr)
    tiles = -(-table.num_rows >> log2_tile)
    return tiles, RA.var_direct_tiles(offsets, log2_tile, buf), 1 << log2_tile


def read_launches(path):
    """The launch counts since the last reset: this path's own call."""
    launches = dict(RA.LAUNCHES)
    print(f"main path {path}: launches {launches}", flush=True)
    for name in PATH_KERNELS[path]:
        check(launches[name] > 0, f"{path} launched the {name} kernel")
    return launches


def run_flagship():
    inputs = F.example_inputs(FLAGSHIP_ROWS, device="cuda")
    RA.reset_launches()
    t0 = time.perf_counter()
    out = F.flagship_step(*inputs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("flagship_step")
    ref = F.flagship_step(*F.example_inputs(FLAGSHIP_ROWS, device="cpu"))
    names = ("murmur3_32", "xxhash64", "rows", "bucket sums")
    for name, got, want in zip(names, out, ref):
        check(got.shape == want.shape and torch.equal(got.cpu(), want),
              f"flagship {name} on the card == on the CPU")
    check(int(out[3].sum()) == int(inputs[1].to(torch.int64).sum()),
          "bucket sums add up to the column sum")
    steady_ms = host_ms(lambda: F.flagship_step(*inputs), STEP_ITERS)
    return launches, ms, steady_ms


def run_bench_round_trip(table):
    schema = [c.dtype for c in table.columns]
    RA.reset_launches()
    t0 = time.perf_counter()
    rows_col = RC.convert_to_rows(table)
    back = RC.convert_from_rows(rows_col, schema)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("bench_round_trip")
    for ci, (a, b) in enumerate(zip(table.columns, back.columns)):
        check(byte_err(a.data, b.data) == 0, f"bench round trip column {ci}")
        check(bool((b.validity == 1).all()), f"bench validity column {ci}")
    starts, voff, row_size = layout_of(table)
    plain = RA.assemble_rows_plain(table.columns, starts, voff, row_size)
    check(torch.equal(rows_col.children[0].data, plain),
          "bench to-rows bytes == plain version")
    steady_ms = host_ms(lambda: RC.convert_from_rows(
        RC.convert_to_rows(table), schema), STEP_ITERS)
    return launches, ms, steady_ms, rows_col


def jni_door_step(handles, type_ids, scales):
    """The JNI-door calls a Spark executor makes on a batch: hash-partition
    keys, then columnar -> rows -> columnar.  Returns the new handles."""
    keys = [handles[k] for k in HASH_KEYS]
    mm = jni_api.murmur_hash3_32(42, keys)
    xx = jni_api.xx_hash_64(42, keys)
    rows = jni_api.convert_to_rows(handles)
    back = jni_api.convert_from_rows(rows, type_ids, scales)
    return mm, xx, rows, back


def release_all(*handles):
    for h in handles:
        for one in (h if isinstance(h, list) else [h]):
            jni_api.release_column(one)


def run_jni_door(table, cpu_keys):
    """The JNI-door main path on `table` (on the card); `cpu_keys` are the
    hash key columns on the CPU.  Returns (launches, first-call ms,
    steady ms, max byte error of the rows against the plain version)."""
    start = REGISTRY.live_count()
    handles = [REGISTRY.register(c) for c in table.columns]
    type_ids = [c.dtype.kind for c in table.columns]
    scales = [c.dtype.scale for c in table.columns]
    RA.reset_launches()
    t0 = time.perf_counter()
    mm, xx, rows, back = jni_door_step(handles, type_ids, scales)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches("jni_door_round_trip")

    cpu = [REGISTRY.register(c) for c in cpu_keys]
    cmm = jni_api.murmur_hash3_32(42, cpu)
    cxx = jni_api.xx_hash_64(42, cpu)
    for name, got, want in (("murmur_hash3_32", mm, cmm),
                            ("xx_hash_64", xx, cxx)):
        g, w = REGISTRY.get(got).data, REGISTRY.get(want).data
        check(g.shape == w.shape and torch.equal(g.cpu(), w),
              f"JNI door {name} on the card == on the CPU")

    cols = table.columns
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    rows_col = REGISTRY.get(rows)
    plain = RA.assemble_var_rows_plain(cols, starts, voff, fixed,
                                       rows_col.offsets)
    err = byte_err(rows_col.children[0].data, plain)
    check(err == 0, "JNI door rows == plain version")
    del plain
    for ci, (a, h) in enumerate(zip(cols, back)):
        b = REGISTRY.get(h)
        want = (torch.ones_like(b.validity) if a.validity is None
                else (a.validity != 0).to(torch.uint8))
        check(torch.equal(b.validity, want), f"JNI door validity {ci}")
        check(byte_err(a.data, b.data) == 0, f"JNI door column {ci} data")
        if a.dtype.is_string:
            check(torch.equal(a.offsets, b.offsets),
                  f"JNI door column {ci} offsets")
    release_all(mm, xx, rows, back, cpu, cmm, cxx)
    steady_ms = host_ms(lambda: release_all(*jni_door_step(
        handles, type_ids, scales)), STEP_ITERS)
    release_all(handles)
    check(REGISTRY.live_count() == start, "every JNI door handle released")
    return launches, ms, steady_ms, err


def event_ms(fn, iters):
    """Mean milliseconds per call on the card, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters):
    """Median wall milliseconds of `fn` followed by a synchronize: a step
    time as its caller sees it, host work included."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def nbytes(t):
    return t.numel() * t.element_size()


def to_rows_bytes(table):
    """Bytes the to-rows function must move: each column and validity
    read once, the rows written once."""
    cols = table.columns
    return (sum(nbytes(c.data) for c in cols)
            + sum(nbytes(c.validity) for c in cols if c.validity is not None)
            + table.num_rows * layout_of(table)[2])


def time_to_rows(table, variants=()):
    """The to-rows kernel on `table` at the wrapper's tile, and at each
    (log2 rows per tile, ring buffers) of `variants`, each checked
    byte-equal to the plain version first; beside them the wrapper, the
    plain version, and a device-to-device copy of as many bytes as the
    function must move (half read, half written)."""
    cols = table.columns
    starts, voff, row_size = layout_of(table)
    rows = table.num_rows
    desc, _ = RA.to_rows_descriptors(cols, starts)
    key = RA.schema_key(cols, starts, voff)
    out = torch.empty((rows * row_size,), dtype=torch.uint8, device="cuda")
    plain = RA.assemble_rows_plain(cols, starts, voff, row_size)
    variant_ms = {}
    for lg, stages in variants:
        out.zero_()
        RA.launch_to_rows(desc, key, rows, row_size, out, lg, stages)
        torch.cuda.synchronize()
        check(torch.equal(out, plain),
              f"to-rows at {1 << lg} rows x {stages} buffers == plain")
        variant_ms[f"{1 << lg}x{stages}"] = event_ms(
            lambda: RA.launch_to_rows(desc, key, rows, row_size, out, lg,
                                      stages), TIMED_ITERS)
    del plain
    plan, stages, flags = RA.to_rows_tile(key, row_size)
    ms = event_ms(lambda: RA.launch_to_rows(desc, key, rows, row_size, out),
                  TIMED_ITERS)
    call = event_ms(lambda: RA.assemble_rows(cols, starts, voff, row_size),
                    TIMED_ITERS)
    plain_ms = event_ms(
        lambda: RA.assemble_rows_plain(cols, starts, voff, row_size),
        PLAIN_ITERS)
    moved = to_rows_bytes(table)
    src = torch.empty((moved // 2,), dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    copy_ms = event_ms(lambda: dst.copy_(src), TIMED_ITERS)
    return dict(ms=ms, call_ms=call, plain_ms=plain_ms, bytes=moved,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3, copy_ms=copy_ms,
                tile_rows=1 << plan.log2_tile, stages=stages,
                smem_bytes=RA.to_rows_smem_bytes(plan, row_size, stages,
                                                 flags),
                variant_ms=variant_ms)


def time_from_rows(table, rows_col):
    cols = table.columns
    schema = [c.dtype for c in cols]
    starts, voff, row_size = layout_of(table)
    rows = table.num_rows
    row_bytes = rows_col.children[0].data
    datas, valid, desc_from = RA.from_rows_outputs(schema, starts, rows,
                                                   row_bytes.device)
    from_ms = event_ms(lambda: RA.launch_from_rows(
        row_bytes, rows, row_size, voff, desc_from, valid), TIMED_ITERS)
    from_call = event_ms(lambda: RA.disassemble_rows(
        row_bytes, schema, starts, voff, row_size), TIMED_ITERS)
    from_plain = event_ms(lambda: RA.disassemble_rows_plain(
        row_bytes, schema, starts, voff, row_size), PLAIN_ITERS)
    from_bytes = (nbytes(row_bytes) + sum(nbytes(d) for d in datas)
                  + nbytes(valid))
    return dict(ms=from_ms, call_ms=from_call, plain_ms=from_plain,
                bytes=from_bytes)


def time_var_kernel(table, log2_tiles=()):
    """The variable-width to-rows kernel on `table`, at the wrapper's tile
    and at each of `log2_tiles`.  Its bytes are what this table's rows
    need: the fixed-width columns, validity, string offsets and the chars
    they span read once, the row offsets read once, the rows written
    once."""
    cols = table.columns
    rows = table.num_rows
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    desc, str_idx = RA.to_rows_descriptors(cols, starts)
    out = torch.empty((total,), dtype=torch.uint8, device=offsets.device)

    def launch(log2_tile=None):
        RA.launch_to_rows_var(desc, str_idx, rows, fixed, voff, offsets,
                              out, log2_tile)

    ms = event_ms(launch, TIMED_ITERS)
    tile_ms = {str(1 << lg): event_ms(lambda: launch(lg), TIMED_ITERS)
               for lg in log2_tiles}
    call = event_ms(lambda: RA.assemble_var_rows(
        cols, starts, voff, fixed, offsets, total), TIMED_ITERS)
    plain = event_ms(lambda: RA.assemble_var_rows_plain(
        cols, starts, voff, fixed, offsets), PLAIN_ITERS)
    read = nbytes(offsets)
    for c in cols:
        if c.validity is not None:
            read += nbytes(c.validity)
        if c.dtype.is_string:
            read += nbytes(c.offsets) + int(c.offsets[-1] - c.offsets[0])
        else:
            read += nbytes(c.data)
    return dict(ms=ms, call_ms=call, plain_ms=plain, bytes=read + total,
                tile_ms=tile_ms)


@contextlib.contextmanager
def fusion(mode):
    """Run the stage path's engine `mode` ("1" fused, "0" op by op)."""
    old = os.environ.get("SPARK_RAPIDS_TPU_STAGE_FUSION")
    os.environ["SPARK_RAPIDS_TPU_STAGE_FUSION"] = mode
    try:
        yield
    finally:
        if old is None:
            del os.environ["SPARK_RAPIDS_TPU_STAGE_FUSION"]
        else:
            os.environ["SPARK_RAPIDS_TPU_STAGE_FUSION"] = old


def same_bytes(got, want, what):
    """Every output equal to `want` in dtype, shape and bytes."""
    check(len(got) == len(want), f"{what}: output count")
    for i, (g, w) in enumerate(zip(got, want)):
        g = g.cpu().numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.cpu().numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        check(g.dtype == w.dtype and g.shape == w.shape
              and g.tobytes() == w.tobytes(), f"{what}: output {i}")


def q5_oracle(h, stores):
    """q5 in vectorised numpy over host copies of the same arrays (int64
    adds, so the sums are exact).  Returns (outputs, pair totals)."""
    sales, rets, profit, seen = (np.zeros(stores, np.int64)
                                 for _ in range(4))
    ms = np.isin(h.s_date, h.d_date)
    st = h.s_store[ms]
    np.add.at(sales, st, h.s_price[ms])
    np.add.at(profit, st, h.s_profit[ms])
    np.add.at(seen, st, 1)
    mr = np.isin(h.r_date, h.d_date)
    rt = h.r_store[mr]
    np.add.at(rets, rt, h.r_amt[mr])
    np.add.at(profit, rt, -h.r_loss[mr])
    np.add.at(seen, rt, 1)
    key = np.where(seen > 0, h.st_id, 2**31 - 1).astype(np.int32)
    order = np.argsort(key, kind="stable")
    return ((key[order], sales[order], rets[order], profit[order],
             np.bool_(False)), [int(ms.sum()), int(mr.sum())])


def q72_oracle(h, items, max_week, week0, limit):
    """q72 in vectorised numpy: every (catalog_sales, inventory) pair on
    item, expanded from searchsorted runs, filtered, counted per (item,
    week) in int64, then ORDER BY count DESC, group ASC LIMIT.  Returns
    (outputs, [pair total])."""
    order = np.argsort(h.inv_item, kind="stable")
    lo = np.searchsorted(h.inv_item[order], h.cs_item, "left")
    cnt = np.searchsorted(h.inv_item[order], h.cs_item, "right") - lo
    total = int(cnt.sum())
    li = np.repeat(np.arange(len(h.cs_item)), cnt)
    ri = order[np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
               + np.arange(total)]
    ow = h.cs_date[li] // 7
    wk = ow - week0
    keep = ((h.inv_date[ri] // 7 == ow + 1)
            & (h.inv_qty[ri] < h.cs_qty[li]) & (wk >= 0) & (wk < max_week))
    gid = (h.item_id[h.cs_item[li[keep]]].astype(np.int64) * max_week
           + wk[keep])
    n_groups = items * max_week
    counts = np.bincount(gid, minlength=n_groups).astype(np.int64)
    skey = np.where(counts > 0, -counts, 2**62)
    top = np.lexsort((np.arange(n_groups), skey))[:limit]
    return ((top // max_week, top % max_week + week0, counts[top],
             np.bool_(False)), [total])


def capacity_used(initial, totals):
    """The capacity the retry settles on: doubled until no join's true
    pair total exceeds it."""
    cap = initial
    while max(totals) > cap:
        cap *= 2
    return cap


def drive_query(name, run, want, plans):
    """One stage-path query in both engines; checks them against each
    other and against the oracle's outputs `want`, and that each stage of
    `plans` compiled once.  Returns its measurements."""
    res = {}
    outs = {}
    for engine, mode in (("fused", "1"), ("op_by_op", "0")):
        with fusion(mode):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outs[engine] = run()
            torch.cuda.synchronize()
            res[f"{engine}_first_call_s"] = time.perf_counter() - t0
            # the first call's peak against the card, before the timed
            # calls (q89 sorts 82.0M groups)
            total = torch.cuda.get_device_properties(0).total_memory
            check(torch.cuda.max_memory_allocated() < 0.9 * total,
                  f"{name} {engine}: first call's peak under 90% of the "
                  f"card's memory")
            res[f"{engine}_ms"] = host_ms(run, STEP_ITERS)
            res[f"{engine}_peak_mb"] = torch.cuda.max_memory_allocated() / 2**20
        print(f"stage path {name} {engine}: first call "
              f"{res[engine + '_first_call_s']:.2f} s, "
              f"{res[engine + '_ms']:.3f} ms, peak "
              f"{res[engine + '_peak_mb']:.0f} MiB", flush=True)
    same_bytes(outs["fused"], outs["op_by_op"],
               f"{name}: fused == op by op on the card")
    same_bytes(outs["fused"], want, f"{name}: == numpy oracle")
    res["compile_s"] = {}
    for plan in plans:
        st = compile_stage(plan)
        check(st.compiles == 1 and len(st.compile_seconds) == 1,
              f"{name}: stage {plan.name} compiled once "
              f"({st.compiles} compiles)")
        res["compile_s"][plan.name] = next(iter(st.compile_seconds.values()))
    return res


def run_stage_path():
    """The TPC-DS stage path at full size (see the module docstring)."""
    RA.reset_launches()
    stores = Q5_DATA["stores"]
    d5 = TT.gen_q5(device="cuda", **Q5_DATA)
    want5, totals5 = q5_oracle(TT.Q5Data(*(x.cpu().numpy() for x in d5)),
                               stores)
    cap5 = capacity_used(Q5_CAPACITY, totals5)
    q5 = drive_query("q5", lambda: TC.run_q5(d5, stores, Q5_CAPACITY),
                     want5, [TC.q5_partials_plan(stores, cap5),
                             TC.q5_finish_plan(stores)])
    q5.update(pair_totals=totals5, capacity=cap5,
              rows=[Q5_DATA["rows"], Q5_DATA["rows"] // 8])
    del d5, want5
    torch.cuda.empty_cache()

    items = Q72_DATA["items"]
    d72 = TT.gen_q72(device="cuda", **Q72_DATA)
    want72, totals72 = q72_oracle(
        TT.Q72Data(*(x.cpu().numpy() for x in d72)), items, Q72_MAX_WEEK,
        Q72_WEEK0, Q72_LIMIT)
    cap72 = capacity_used(Q72_CAPACITY, totals72)
    q72 = drive_query(
        "q72", lambda: TC.run_q72(d72, items, Q72_MAX_WEEK, Q72_CAPACITY,
                                  Q72_LIMIT, Q72_WEEK0),
        want72, [TC.q72_partials_plan(items, Q72_MAX_WEEK, cap72,
                                      Q72_WEEK0),
                 TC.q72_finish_plan(items, Q72_MAX_WEEK, Q72_LIMIT,
                                    Q72_WEEK0)])
    q72.update(pair_totals=totals72, capacity=cap72,
               rows=[Q72_DATA["cs_rows"], Q72_DATA["inv_rows"]],
               groups=items * Q72_MAX_WEEK)
    del d72, want72
    torch.cuda.empty_cache()

    # the capacity retry on the card: op by op, so the doublings compile
    # nothing
    small = TT.gen_q72(device="cuda", **Q72_SMALL_DATA)
    with fusion("0"):
        (_counts, of), cap = TC.run_q72_partials(
            small, 4, Q72_MAX_WEEK, Q72_SMALL_CAPACITY, Q72_WEEK0)
        outs = TC.run_q72(small, 4, Q72_MAX_WEEK, Q72_SMALL_CAPACITY,
                          week0=Q72_WEEK0)
    check(cap > Q72_SMALL_CAPACITY and not bool(of) and not bool(outs[-1]),
          f"small q72 doubled its join capacity ({cap})")
    rows = [(int(i), int(w), int(c))
            for i, w, c in zip(*(o.cpu().tolist() for o in outs[:3]))
            if c > 0]
    check(rows == TT.oracle_q72(small, 4, Q72_MAX_WEEK, week0=Q72_WEEK0),
          "small q72 after the retry == oracle")
    others = run_catalog_stages()
    launches = read_launches("tpcds_stage_path")
    from torch._inductor.async_compile import shutdown_compile_workers
    shutdown_compile_workers()
    return launches, {"q5": q5, "q72": q72,
                      "retry": {"initial_capacity": Q72_SMALL_CAPACITY,
                                "capacity": cap}, **others}


def q3_want(d):
    """q3's stage outputs from the oracle: the first LIMIT groups (all
    live at this size) and the kept-row count."""
    years, brands, sums, kept = TT.q3_arrays(
        d, Q3_BASE, Q3_PARAMS["manufact"], Q3_PARAMS["month"])
    limit = Q3_PARAMS["limit"]
    check(len(years) >= limit, f"q3 has {limit} live groups")
    return years[:limit], brands[:limit], sums[:limit], np.int64(kept)


def q9_want(data):
    rows = TT.oracle_q9(*data)
    return (np.array([r[0] for r in rows], np.int64),
            np.array([r[1] for r in rows], np.float64),
            np.array([r[2] for r in rows], np.float64))


def q67_want(d, ncat, ncls):
    """q67's stage outputs from the oracle (every group live here)."""
    cat, cls, s, rank, cnt, sum1, total = TT.q67_arrays(d, ncat, ncls)
    check(len(cat) == ncat * ncls, "every q67 group is live")
    return cat, cls, s, rank, cnt, sum1, np.int64(total)


def q89_want(d, stores, items):
    """q89's stage outputs from the oracle: live groups by (store,
    item), then the empty ones in group order."""
    sales, cnt, tot = TT.q89_arrays(d, stores, items)
    g = np.concatenate([np.nonzero(cnt)[0], np.nonzero(cnt == 0)[0]])
    return g // items, g % items, sales[g], tot[g // items], cnt[g]


def run_catalog_stages():
    """q3, q9, q67, CUBE and q89 through the stage path at full size,
    each in both engines against its oracle."""
    out = {}
    d = TT.gen_q3(device="cuda", **Q3_DATA)
    want = q3_want(d)
    out["q3"] = drive_query(
        "q3", lambda: TC.run_q3(d, Q3_BASE, brands=Q3_DATA["brands"],
                                **Q3_PARAMS), want,
        [TC.q3_plan(Q3_BASE, Q3_PARAMS["years"], Q3_DATA["brands"],
                    Q3_PARAMS["manufact"], Q3_PARAMS["month"],
                    Q3_PARAMS["limit"])])
    out["q3"].update(rows=Q3_DATA["rows"], kept_rows=int(want[3]))
    del d, want
    data = TT.gen_q9(device="cuda", **Q9_DATA)
    out["q9"] = drive_query("q9", lambda: TC.run_q9(*data), q9_want(data),
                            [TC.q9_plan()])
    out["q9"].update(rows=Q9_DATA["rows"])
    del data
    ncat, ncls = Q67_DATA["ncat"], Q67_DATA["ncls"]
    d = TT.gen_q67(device="cuda", **Q67_DATA)
    out["q67"] = drive_query("q67", lambda: TC.run_q67(d, ncat, ncls),
                             q67_want(d, ncat, ncls),
                             [TC.q67_plan(ncat, ncls)])
    out["cube"] = drive_query("cube", lambda: TC.run_cube(d, ncat, ncls),
                              TT.oracle_cube(d, ncat, ncls),
                              [TC.cube_plan(ncat, ncls)])
    for q in ("q67", "cube"):
        out[q].update(rows=Q67_DATA["rows"], groups=ncat * ncls)
    del d
    stores, items = Q89_DATA["stores"], Q89_DATA["items"]
    d = TT.gen_q89(device="cuda", **Q89_DATA)
    want = q89_want(d, stores, items)
    out["q89"] = drive_query("q89", lambda: TC.run_q89(d, stores, items),
                             want, [TC.q89_plan(stores, items)])
    out["q89"].update(rows=Q89_DATA["rows"], groups=stores * items,
                      live_groups=int((want[4] > 0).sum()))
    del d, want
    torch.cuda.empty_cache()
    return out


def run_catalog_entry():
    """The eight named queries through run_catalog_query at their
    default parameters, on the card and on the CPU, op by op; then
    each with a cancelled context, which must raise before any work
    (no device memory allocated)."""
    RA.reset_launches()
    res = {}
    with fusion("0"):
        for name in CATALOG_NAMES:
            got = TM.run_catalog_query(name, {"device": "cuda"})
            want = TM.run_catalog_query(name, {"device": "cpu"})
            check(got == want, f"catalog {name} on the card == on the CPU")
            res[name] = {"rows": len(got)}
        cancelled = threading.Event()
        cancelled.set()
        for name in CATALOG_NAMES:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            try:
                TM.run_catalog_query(name, {"device": "cuda"},
                                     TM.QueryContext(cancel_event=cancelled))
                check(False, f"catalog {name} ran after a cancel")
            except TM.QueryCancelled:
                pass
            check(torch.cuda.max_memory_allocated() == base,
                  f"catalog {name} did no work after a cancel")
    print(f"catalog entry: {json.dumps(res)}", flush=True)
    return read_launches("tpcds_catalog_entry"), res


def store_sales_batch(rows, seed):
    """A store_sales batch on the card: ss_store_sk INT32 (402 stores),
    ss_item_sk INT32 (204,000 items), ss_quantity INT32 (1-100),
    ss_sales_price INT64 cents (100-19,999) and ss_net_paid FLOAT64
    (quantity x price, less up to 20%, in dollars; never negative), the
    last three about 4% null."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(lo, hi, dtype):
        return torch.randint(lo, hi, (rows,), generator=g, dtype=dtype,
                             device="cuda")

    def valid():
        return (torch.rand(rows, generator=g, device="cuda")
                >= OPS_NULL_SHARE).to(torch.uint8)

    qty = ints(1, 101, torch.int32)
    price = ints(100, 20_000, torch.int64)
    net = ((qty * price).to(torch.float64) / 100 * (
        1 - 0.2 * torch.rand(rows, generator=g, dtype=torch.float64,
                             device="cuda")))
    return Table([Column(dtypes.INT32, rows, data=ints(0, 402, torch.int32)),
                  Column(dtypes.INT32, rows,
                         data=ints(0, 204_000, torch.int32)),
                  Column(dtypes.INT32, rows, data=qty, validity=valid()),
                  Column(dtypes.INT64, rows, data=price, validity=valid()),
                  Column(dtypes.FLOAT64, rows, data=net, validity=valid())],
                 ["ss_store_sk", "ss_item_sk", "ss_quantity",
                  "ss_sales_price", "ss_net_paid"])


def string_keys(rows, distinct, lo, hi, seed):
    """(pool, idx): `distinct` brand-like STRING values (lowercase
    letters, digits, spaces and '#') of lo to hi bytes on the card, and
    `rows` int64 indices into the pool on the card."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz0123456789 #",
                             np.uint8)
    pool = [bytes(alphabet[rng.integers(0, len(alphabet), n)])
            for n in rng.integers(lo, hi + 1, distinct)]
    idx = torch.from_numpy(rng.integers(0, distinct, rows)).to("cuda")
    return Column.from_strings(pool, "cuda"), idx


def string_key_column(rows, distinct, lo, hi, seed):
    """A STRING column of `rows` drawn from string_keys' pool, gathered
    on the card."""
    pool, idx = string_keys(rows, distinct, lo, hi, seed)
    return CP.gather(pool, idx)


def on_cpu(col):
    return Column(col.dtype, col.length,
                  data=None if col.data is None else col.data.cpu(),
                  validity=None if col.validity is None
                  else col.validity.cpu(),
                  offsets=None if col.offsets is None else col.offsets.cpu())


def same_column(a, b, what):
    """Card column == CPU column: data bytes, validity, offsets."""
    check(a.dtype == b.dtype and a.length == b.length, f"{what}: type")
    check(byte_err(a.data, b.data.to(a.data.device)) == 0,
          f"{what}: data")
    for x, y, part in ((a.validity, b.validity, "validity"),
                       (a.offsets, b.offsets, "offsets")):
        check((x is None) == (y is None)
              and (x is None or torch.equal(x.cpu(), y)), f"{what}: {part}")


def close_float_sums(a, b, counts, mean, what):
    """A float SUM (or MEAN) on the card against the CPU's: the card adds
    with atomics, whose order varies, so each group is held to
    |card - cpu| <= 4 * count * 2^-53 * sum|x| (twice the worst error
    of two summation orders; sum|x| = the CPU's sum, as x >= 0), and a
    mean to that over count plus 2 ulps of the mean.  `counts` are the
    groups' non-null counts.  Returns the largest difference in units
    of the bound."""
    check(torch.equal(a.validity.cpu(), b.validity), f"{what}: validity")
    ga, gb = a.data.cpu(), b.data
    tol = 4 * U53 * counts.to(torch.float64) * gb.abs()
    if mean:
        tol = tol + 2 * U53 * gb.abs()
    diff = (ga - gb).abs()
    check(bool((diff <= tol).all()), f"{what}: within the stated bound")
    return float((diff / tol.clamp(min=1e-300)).max())


@contextlib.contextmanager
def branch_log():
    """Record which group-id branch each groupby_aggregate takes."""
    taken = []
    real = {n: getattr(G, n) for n in ("_group_ids_device",
                                       "_group_ids_host")}
    for n, fn in real.items():
        setattr(G, n, lambda k, n=n, fn=fn: taken.append(n[11:]) or fn(k))
    try:
        yield taken
    finally:
        for n, fn in real.items():
            setattr(G, n, fn)


def timed(fn, iters):
    """(median synchronized ms, peak MiB over the calls)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = host_ms(fn, iters)
    return ms, torch.cuda.max_memory_allocated() / 2**20


def run_operators():
    """GROUP BY and ORDER BY over one store_sales batch on the card, each
    against the same call on a CPU copy (see the module docstring)."""
    RA.reset_launches()
    res = {}
    batch = store_sales_batch(OPS_ROWS, seed=29)
    cols = batch.columns
    keys = Table(cols[:2])
    # sum(quantity), count(net_paid), min and max(price), sum and
    # mean(net_paid)
    values = [cols[2], cols[4], cols[3], cols[3], cols[4], cols[4]]
    aggs = ["sum", "count", "min", "max", "sum", "mean"]
    with branch_log() as taken:
        out = G.groupby_aggregate(keys, values, aggs)
    torch.cuda.synchronize()
    # the device branch against the host branch on the same card data
    ids_d, first_d, n_d = G._group_ids_device(keys)
    ids_h, first_h, n_h = G._group_ids_host(keys)
    check(n_d == n_h and torch.equal(ids_d, ids_h)
          and torch.equal(first_d, first_h),
          "device group ids == host group ids on the card")
    del ids_d, first_d, ids_h, first_h
    cpu_cols = [on_cpu(c) for c in cols]
    want = G.groupby_aggregate(Table(cpu_cols[:2]),
                               [cpu_cols[i] for i in (2, 4, 3, 3, 4, 4)],
                               aggs)
    for i in (0, 1, 2, 3, 4, 5):
        same_column(out.columns[i], want.columns[i], f"groupby column {i}")
    counts = want.columns[3].data
    bound = max(close_float_sums(out.columns[6], want.columns[6], counts,
                                 False, "groupby sum(net_paid)"),
                close_float_sums(out.columns[7], want.columns[7], counts,
                                 True, "groupby mean(net_paid)"))
    ms, peak = timed(lambda: G.groupby_aggregate(keys, values, aggs),
                     STEP_ITERS)
    res["groupby"] = {"rows": OPS_ROWS, "groups": out.num_rows,
                      "branch": taken, "ms": ms, "peak_mb": peak,
                      "float_diff_of_bound": bound}
    del out, want
    order = S.sort_table(batch, [0, 3], [True, False])
    want = S.sort_table(Table(cpu_cols), [0, 3], [True, False])
    for i in range(len(cols)):
        same_column(order.columns[i], want.columns[i],
                    f"sort_table column {i}")
    del order, want, cpu_cols
    ms, peak = timed(lambda: S.sort_table(batch, [0, 3], [True, False]), 3)
    res["sort_table"] = {"rows": OPS_ROWS, "ms": ms, "peak_mb": peak}
    del batch, cols, keys, values
    torch.cuda.empty_cache()

    for name, rows, distinct, lo, hi in (
            ("string", STR_OPS_ROWS, STR_DISTINCT, 8, 50),
            ("long_string", LONG_STR_ROWS, LONG_STR_DISTINCT, 257, 400)):
        brand = string_key_column(rows, distinct, lo, hi, seed=rows + lo)
        vals = store_sales_batch(rows, seed=lo).columns[2:]
        keys = Table([brand])
        s_aggs = ["sum", "count", "max", "sum", "mean"]
        s_vals = [vals[0], vals[2], vals[1], vals[2], vals[2]]
        with branch_log() as taken:
            out = G.groupby_aggregate(keys, s_vals, s_aggs)
        cpu_vals = [on_cpu(c) for c in s_vals]
        want = G.groupby_aggregate(Table([on_cpu(brand)]), cpu_vals, s_aggs)
        for i in range(4):
            same_column(out.columns[i], want.columns[i],
                        f"{name} groupby column {i}")
        counts = want.columns[2].data
        bound = max(close_float_sums(out.columns[4], want.columns[4],
                                     counts, False, f"{name} sum"),
                    close_float_sums(out.columns[5], want.columns[5],
                                     counts, True, f"{name} mean"))
        ms, peak = timed(lambda: G.groupby_aggregate(keys, s_vals, s_aggs),
                         STEP_ITERS)
        res[f"{name}_groupby"] = {
            "rows": rows, "groups": out.num_rows, "key_bytes": [lo, hi],
            "branch": taken, "ms": ms, "peak_mb": peak,
            "float_diff_of_bound": bound}
        sort_keys = Table([brand, vals[0]])
        got = S.order_by(sort_keys, [True, False])
        check(torch.equal(got.cpu(), S.order_by(
            Table([on_cpu(brand), on_cpu(vals[0])]), [True, False])),
            f"{name} order_by on the card == on the CPU")
        ms, peak = timed(lambda: S.order_by(sort_keys, [True, False]), 3)
        res[f"{name}_order_by"] = {"rows": rows, "ms": ms, "peak_mb": peak}
        del brand, vals, keys, s_vals, out, want, sort_keys, got
    check(res["groupby"]["branch"] == ["device"]
          and res["string_groupby"]["branch"] == ["device"]
          and res["long_string_groupby"]["branch"] == ["host"],
          "each group-by took its branch")
    torch.cuda.empty_cache()
    print(f"operators: {json.dumps(res)}", flush=True)
    return read_launches("operators_batch"), res


def int_key_oracle(lk, rk, lvalid=None):
    """The inner join in numpy on int64 surrogate keys (equal values <=>
    equal join keys): left rows ascending, each one's right rows
    ascending."""
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, "left")
    counts = np.searchsorted(rs, lk, "right") - lo
    if lvalid is not None:
        counts = np.where(lvalid, counts, 0)
    li = np.repeat(np.arange(len(lk)), counts)
    starts = np.cumsum(counts) - counts
    ri = order[lo[li] + np.arange(len(li)) - starts[li]]
    return (torch.from_numpy(li.astype(np.int32)).to("cuda"),
            torch.from_numpy(ri.astype(np.int32)).to("cuda"))


def host_int64(t):
    return t.cpu().numpy().astype(np.int64)


def join_cells(oracle=True):
    """The join cells, one at a time, drawn on the card from a seed:
    (name, left keys, right keys, null semantics, oracle pairs or None
    without `oracle`)."""
    g = torch.Generator(device="cuda").manual_seed(81)

    def ints(lo, hi, n, dtype=torch.int32):
        return torch.randint(lo, hi, (n,), generator=g, dtype=dtype,
                             device="cuda")

    def int_oracle(*args):
        return int_key_oracle(*args) if oracle else None

    # J1: ss_customer_sk (4% null) x c_customer_sk (unique)
    lk = ints(1, J1_CUSTOMERS + 1, J1_ROWS)
    lv = (torch.rand(J1_ROWS, generator=g, device="cuda")
          >= J1_NULL_SHARE).to(torch.uint8)
    rk = (torch.randperm(J1_CUSTOMERS, generator=g, device="cuda")
          + 1).to(torch.int32)
    want = int_oracle(host_int64(lk), host_int64(rk),
                      lv.cpu().numpy().astype(bool))
    yield ("J1", Table([Column(dtypes.INT32, J1_ROWS, data=lk, validity=lv)]),
           Table([Column(dtypes.INT32, J1_CUSTOMERS, data=rk)]),
           J.NULL_UNEQUAL, want)
    del lk, lv, rk, want
    # J2: (ss_item_sk, ss_ticket_number) x store_returns drawn from sales
    item = ints(1, J3_DATA["items"] + 1, J1_ROWS)
    ticket = (torch.arange(J1_ROWS, dtype=torch.int64, device="cuda")
              // J2_ITEMS_PER_TICKET + 1)
    pick = torch.randperm(J1_ROWS, generator=g, device="cuda")[:J2_RETURNS]
    surrogate = host_int64(item) << 32 | host_int64(ticket)
    want = int_oracle(surrogate, surrogate[pick.cpu().numpy()])
    del surrogate
    yield ("J2", Table([Column(dtypes.INT32, J1_ROWS, data=item),
                        Column(dtypes.INT64, J1_ROWS, data=ticket)]),
           Table([Column(dtypes.INT32, J2_RETURNS, data=item[pick]),
                  Column(dtypes.INT64, J2_RETURNS, data=ticket[pick])]),
           J.NULL_EQUAL, want)
    del item, ticket, pick, want
    # J3: cs_item_sk x inv_item_sk, many to many
    lk = ints(0, J3_DATA["items"], J3_DATA["cs_rows"])
    rk = ints(0, J3_DATA["items"], J3_DATA["inv_rows"])
    want = int_oracle(host_int64(lk), host_int64(rk))
    yield ("J3", Table([Column(dtypes.INT32, lk.shape[0], data=lk)]),
           Table([Column(dtypes.INT32, rk.shape[0], data=rk)]),
           J.NULL_EQUAL, want)
    del lk, rk, want
    # J4: brand-like STRING keys x the brand dim, then keys of 257-400 B
    for name, data in (("J4", J4_DATA), ("J4_long", J4_LONG_DATA)):
        pool, idx = string_keys(seed=data["rows"] + data["lo"], **data)
        check(len(set(pool.to_pylist())) == data["distinct"],
              f"{name}: the dim's keys are distinct")
        want = int_oracle(host_int64(idx),
                          np.arange(data["distinct"], dtype=np.int64))
        yield (name, Table([CP.gather(pool, idx)]), Table([pool]),
               J.NULL_EQUAL, want)
        del pool, idx, want


@contextlib.contextmanager
def join_route_log():
    """Record the engine the router runs, and the verdict and seconds of
    its calibration when it calibrates."""
    log = {"engines": [], "verdict": None, "calibration_s": 0.0}
    real_engines, real_pick = J._join_engines, CAL.pick_path

    def engines():
        return {n: (lambda *a, n=n, f=f: log["engines"].append(n) or f(*a))
                for n, f in real_engines().items()}

    def pick_path(*a, **k):
        t0 = time.perf_counter()
        log["verdict"] = real_pick(*a, **k)
        log["calibration_s"] += time.perf_counter() - t0
        return log["verdict"]

    J._join_engines, CAL.pick_path = engines, pick_path
    try:
        yield log
    finally:
        J._join_engines, CAL.pick_path = real_engines, real_pick


def same_pairs(got, want, what):
    check(all(t.is_cuda and t.dtype == torch.int32 for t in got),
          f"{what}: int32 pairs on the card")
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          f"{what}: pairs == the oracle's")


def run_join_cell(name, left, right, nulls, want):
    """Every engine by name on one cell, each held to the oracle; the
    device engines timed (median of 5 synchronized calls), the host
    engines once; then the router unpinned."""
    res = {"left_rows": left.num_rows, "right_rows": right.num_rows,
           "nulls": nulls, "pairs": int(want[0].shape[0]), "engines": {}}
    engines = J._join_engines()
    for engine in JOIN_ENGINES:
        fn = engines[engine]
        if engine == "device_hash":
            HJ._LEARNED_CAPACITY.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        got = fn(left, right, nulls)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        # the engine's own working set: the peak over what the inputs
        # and earlier phases already held
        r = {"first_ms": first_ms, "peak_added_mb":
             (torch.cuda.max_memory_allocated() - before) / 2**20}
        same_pairs(got, want, f"{name} {engine}")
        del got
        if engine == "device_hash":
            r["doublings"] = [HJ.LAST_CAPACITY["doublings"]]
            same_pairs(fn(left, right, nulls), want, f"{name} {engine} again")
            r["doublings"].append(HJ.LAST_CAPACITY["doublings"])
            r["capacity"] = HJ.LAST_CAPACITY["used"]
        if engine.startswith("device"):
            r["ms"] = host_ms(lambda: fn(left, right, nulls), STEP_ITERS)
        res["engines"][engine] = r
    CAL.forget()
    with join_route_log() as log:
        t0 = time.perf_counter()
        got = J.sort_merge_inner_join(left, right, nulls)
        torch.cuda.synchronize()
        router_ms = (time.perf_counter() - t0) * 1e3
    same_pairs(got, want, f"{name} router")
    # the engines the calibration timed come first in the log; the
    # router's own run is its last entry
    res["router"] = {"engine": log["engines"][-1],
                     "verdict": log["verdict"],
                     "calibration_s": log["calibration_s"],
                     "first_ms": router_ms}
    print(f"join {name}: {json.dumps(res)}", flush=True)
    return res


def run_star_join():
    """simple_star_join_agg: store_sales (ss_item_sk, net paid cents)
    x item (i_item_sk unique, i_brand_id of 1,000), SUM and COUNT by
    brand, exact against numpy."""
    g = torch.Generator(device="cuda").manual_seed(83)
    item_sk = torch.randint(0, STAR_ITEMS, (J1_ROWS,), generator=g,
                            dtype=torch.int32, device="cuda")
    paid = torch.randint(100, 20_000, (J1_ROWS,), generator=g,
                         dtype=torch.int64, device="cuda")
    dim_sk = torch.randperm(STAR_ITEMS, generator=g, device="cuda").to(
        torch.int32)
    brand = torch.randint(1, STAR_BRANDS + 1, (STAR_ITEMS,), generator=g,
                          dtype=torch.int32, device="cuda")
    fact = Table([Column(dtypes.INT32, J1_ROWS, data=item_sk),
                  Column(dtypes.INT64, J1_ROWS, data=paid)])
    dim = Table([Column(dtypes.INT32, STAR_ITEMS, data=dim_sk),
                 Column(dtypes.INT32, STAR_ITEMS, data=brand)])
    with join_route_log() as log:
        t0 = time.perf_counter()
        out = Q.simple_star_join_agg(fact, dim)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    brand_of = np.empty(STAR_ITEMS, np.int64)
    brand_of[dim_sk.cpu().numpy()] = brand.cpu().numpy()
    b = brand_of[item_sk.cpu().numpy()]
    v = paid.cpu().numpy()
    check(int(v.sum()) < 2**53, "star join sums exact in float64")
    keys = np.unique(b)
    sums = np.bincount(b, weights=v.astype(np.float64)).astype(np.int64)
    counts = np.bincount(b)
    for col, want in zip(out.columns, (keys, sums[keys], counts[keys])):
        check(np.array_equal(col.data.cpu().numpy().astype(np.int64), want),
              "star join == numpy")
    ms, peak = timed(lambda: Q.simple_star_join_agg(fact, dim), STEP_ITERS)
    return {"fact_rows": J1_ROWS, "dim_rows": STAR_ITEMS,
            "groups": out.num_rows, "engine": log["engines"][-1],
            "verdict": log["verdict"], "calibration_s": log["calibration_s"],
            "first_ms": first_ms, "ms": ms, "peak_mb": peak}


def run_joins():
    """The join layer on the card (see the module docstring)."""
    RA.reset_launches()
    calib = os.path.join(_BUILD, "join_calib.json")
    if os.path.exists(calib):
        os.unlink(calib)
    saved = os.environ.get("SPARK_RAPIDS_TPU_CALIB_CACHE")
    os.environ["SPARK_RAPIDS_TPU_CALIB_CACHE"] = calib
    res = {}
    try:
        for name, left, right, nulls, want in join_cells():
            res[name] = run_join_cell(name, left, right, nulls, want)
            if name == "J1":
                start = REGISTRY.live_count()
                lh = REGISTRY.register(left.columns[0])
                rh = REGISTRY.register(right.columns[0])
                t0 = time.perf_counter()
                out = jni_api.sort_merge_inner_join([lh], [rh], False)
                torch.cuda.synchronize()
                res["jni_door_J1_ms"] = (time.perf_counter() - t0) * 1e3
                same_pairs([REGISTRY.get(h).data for h in out], want,
                           "JNI-door sort_merge_inner_join")
                release_all(lh, rh, out)
                check(REGISTRY.live_count() == start,
                      "every join handle released")
            del left, right, want
            torch.cuda.empty_cache()
        j3 = res["J3"]["engines"]["device_hash"]["doublings"]
        check(j3[0] > 0 and j3[1] == 0,
              f"J3 device_hash doubled, then started learned: {j3}")
        check(res["J4_long"]["router"]["engine"] == "host_rank"
              and res["J4_long"]["router"]["verdict"] is None,
              "keys over DEVICE_STR_KEY_MAX_LEN route host_rank")
        res["star_join"] = run_star_join()
        torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("SPARK_RAPIDS_TPU_CALIB_CACHE", None)
        else:
            os.environ["SPARK_RAPIDS_TPU_CALIB_CACHE"] = saved
    print(f"joins: {json.dumps(res)}", flush=True)
    return read_launches("joins_batch"), res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(f"device: {kind}  torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    phase_s = {}
    clock = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        phase_s[name] = now - clock[0]
        clock[0] = now

    t0 = time.perf_counter()
    cuda_build.build("row_assembly")
    build_s = time.perf_counter() - t0
    phase("build")
    print(f"build: row_assembly.cu in {build_s:.1f} s (0 = cached)")
    print(cuda_build.build_log("row_assembly"), flush=True)

    # kernel vs plain: the edge cases, then the main path's own inputs
    bench = make_table(BENCH_ROWS, BENCH_COLS, "cuda", seed=7)
    a, b, c = F.example_inputs(FLAGSHIP_ROWS, device="cuda")
    flagship_table = Table([Column(dtypes.INT64, FLAGSHIP_ROWS, data=a),
                            Column(dtypes.INT32, FLAGSHIP_ROWS, data=b),
                            Column(dtypes.FLOAT64, FLAGSHIP_ROWS, data=c)])
    errs = {"to_rows": 0, "from_rows": 0}
    cases = (make_table(rows, ncols, "cuda", seed=rows + ncols,
                        nullable_every=nullable, dec128_every=dec,
                        view_offset=off)
             for rows, ncols, nullable, dec, off in KERNEL_CASES)
    for table in itertools.chain(cases, [flagship_table, bench]):
        e_to, e_from = compare_kernels(table)
        print(f"kernel vs plain: rows={table.num_rows} "
              f"cols={table.num_columns} to_rows max_abs_err={e_to} "
              f"from_rows max_abs_err={e_from}", flush=True)
        check(e_to == 0 and e_from == 0, "kernels byte-equal to plain")
        errs["to_rows"] = max(errs["to_rows"], e_to)
        errs["from_rows"] = max(errs["from_rows"], e_from)

    string_specs = string_host_specs(STRING_ROWS, STRING_COLS, seed=11)
    string_table = interop.table_from_host(string_specs, device="cuda")
    cpu_keys = interop.table_from_host(
        [string_specs[k] for k in HASH_KEYS], device="cpu").columns
    del string_specs
    errs["to_rows_var"] = 0
    paths = {"staged": 0, "direct": 0}
    for case in VAR_KERNEL_CASES:
        table = var_case_table(case, "cuda")
        err = compare_var_kernel(table)
        tiles, direct, tile_rows = var_tiles(table)
        print(f"kernel vs plain: rows={case[0]} cols={case[1]} with strings "
              f"of up to {case[6]} bytes, {tiles} tiles of {tile_rows} "
              f"rows, {direct} direct: to_rows_var max_abs_err={err}",
              flush=True)
        check(err == 0, "variable-width kernel byte-equal to plain")
        errs["to_rows_var"] = max(errs["to_rows_var"], err)
        paths["staged"] += tiles - direct
        paths["direct"] += direct
        if case == LONG_STRINGS_CASE:
            check(direct == tiles, "every long-strings tile went direct")
            long_table = table
    check(min(paths.values()) > 0,
          f"both variable-width kernel paths taken: {paths}")
    phase("kernel_checks")

    by_path = {}
    by_path["flagship_step"], flagship_ms, flagship_steady = run_flagship()
    phase("flagship_step")
    (by_path["bench_round_trip"], bench_ms, bench_steady,
     rows_col) = run_bench_round_trip(bench)
    phase("bench_round_trip")
    (by_path["jni_door_round_trip"], jni_ms, jni_steady,
     err) = run_jni_door(string_table, cpu_keys)
    phase("jni_door_round_trip")
    by_path["tpcds_stage_path"], stage_path = run_stage_path()
    print(json.dumps({"stage_path": stage_path}), flush=True)
    phase("tpcds_stage_path")
    by_path["tpcds_catalog_entry"], catalog = run_catalog_entry()
    phase("tpcds_catalog_entry")
    by_path["operators_batch"], operators = run_operators()
    print(json.dumps({"catalog_entry": catalog, "operators": operators}),
          flush=True)
    phase("operators_batch")
    by_path["joins_batch"], joins = run_joins()
    print(json.dumps({"joins": joins}), flush=True)
    phase("joins_batch")
    print(f"kernel vs plain: rows={STRING_ROWS} cols={STRING_COLS} with "
          f"strings (JNI door) to_rows_var max_abs_err={err}", flush=True)
    errs["to_rows_var"] = max(errs["to_rows_var"], err)

    times = {"to_rows": time_to_rows(bench, TO_ROWS_TIMED["bench"]),
             "from_rows": time_from_rows(bench, rows_col)}
    del rows_col, bench
    to_rows_shapes = {"flagship": time_to_rows(flagship_table,
                                               TO_ROWS_TIMED["flagship"])}
    del flagship_table
    nullable = make_table(BENCH_ROWS, BENCH_COLS, "cuda", seed=8,
                          nullable_every=3)
    to_rows_shapes["bench_nullable"] = time_to_rows(nullable)
    del nullable
    shaped = [("bench", times["to_rows"])] + list(to_rows_shapes.items())
    print(json.dumps({"to_rows_variant_ms": {
        k: dict(t["variant_ms"], chosen={
            key: t[key] for key in ("tile_rows", "stages", "smem_bytes")})
        for k, t in shaped}}), flush=True)
    times["to_rows_var"] = time_var_kernel(string_table, VAR_TIMED_TILES)
    direct = time_var_kernel(long_table)
    direct_path = {"shape": "x".join(map(str, LONG_STRINGS_CASE[:2])),
                   "max_len": LONG_STRINGS_CASE[6], "ms": direct["ms"],
                   "bound_ms": direct["bytes"] / HBM_BYTES_PER_S * 1e3,
                   "plain_ms": direct["plain_ms"], "bytes": direct["bytes"]}
    del long_table
    replaces = {
        "to_rows": "spark_rapids_tpu/ops/row_assembly_pallas.py:47",
        "from_rows": "spark_rapids_tpu/ops/row_assembly_pallas.py:136",
        "to_rows_var": "spark_rapids_tpu/ops/row_assembly_pallas.py:281",
    }
    shapes = {"to_rows": f"{BENCH_ROWS}x{BENCH_COLS}",
              "from_rows": f"{BENCH_ROWS}x{BENCH_COLS}",
              "to_rows_var": f"{STRING_ROWS}x{STRING_COLS}"}
    kernels = []
    for name, t in times.items():
        bound_ms = t["bytes"] / HBM_BYTES_PER_S * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": "spark_rapids_tpu_torch/csrc/row_assembly.cu",
            "replaces": replaces[name],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": errs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
            "call_ms": t["call_ms"], "bytes": t["bytes"],
            "gb_per_s": t["bytes"] / t["ms"] / 1e6,
            "shape": shapes[name],
        })
        if name == "to_rows":
            kernels[-1].update(
                copy_ms=t["copy_ms"], tile_rows=t["tile_rows"],
                stages=t["stages"], smem_bytes=t["smem_bytes"],
                shapes={k: {key: v[key] for key in (
                    "ms", "bound_ms", "plain_ms", "call_ms", "copy_ms",
                    "bytes", "tile_rows", "stages")}
                        for k, v in to_rows_shapes.items()})
        if name == "to_rows_var":
            kernels[-1].update(tile_rows=var_tiles(string_table)[2],
                               tile_ms=t["tile_ms"], direct_path=direct_path)
    print(json.dumps({"main_path": {
        "flagship_rows": FLAGSHIP_ROWS,
        "flagship_first_call_ms": flagship_ms,
        "flagship_step_ms": flagship_steady,
        "bench_shape": f"{BENCH_ROWS}x{BENCH_COLS}",
        "bench_round_trip_first_call_ms": bench_ms,
        "bench_round_trip_ms": bench_steady,
        "jni_door_shape": f"{STRING_ROWS}x{STRING_COLS}",
        "jni_door_first_call_ms": jni_ms,
        "jni_door_round_trip_ms": jni_steady,
        "build_s": build_s}}))
    phase("kernel_timing")
    print(json.dumps({"phase_s": phase_s,
                      "total_s": sum(phase_s.values())}), flush=True)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
