#!/usr/bin/env python3
"""Device time of the fixed-width row-conversion kernels per call, on
one GPU.

    python3 scripts/row_kernel_times.py [--calls N]

Calls the to-rows wrapper (`ops/row_assembly_cuda.assemble_rows`) N
times (default 20, after two warm-up calls) under torch.profiler at
three shapes: the bench table (212 cycled fixed-width columns x 2^19
rows), the flagship table (INT64, INT32, FLOAT64 x 2^22 rows) and the
bench table with every third column nullable; then the from-rows
wrapper (`disassemble_rows`) the same way on the bench table's rows.
For each it prints one JSON line: the kernel's (`to_rows_kernel`,
`from_rows_kernel`) mean device milliseconds per call, the bytes the
function must move (each input read once, each output written once)
and their bound at 3.35 TB/s.  Only the wrappers are called, so the
script times whichever kernels the checkout it runs in has, each after
the same work.  Exits non-zero without a CUDA device, or when a call
did not launch its kernel once.
"""

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from spark_rapids_tpu_torch.columns import dtypes  # noqa: E402
from spark_rapids_tpu_torch.columns.column import Column  # noqa: E402
from spark_rapids_tpu_torch.columns.table import Table  # noqa: E402
from spark_rapids_tpu_torch.models import flagship as F  # noqa: E402
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA  # noqa: E402


def tables():
    yield "bench", CS.make_table(CS.BENCH_ROWS, CS.BENCH_COLS, "cuda", seed=7)
    a, b, c = F.example_inputs(CS.FLAGSHIP_ROWS, device="cuda")
    rows = CS.FLAGSHIP_ROWS
    yield "flagship", Table([Column(dtypes.INT64, rows, data=a),
                             Column(dtypes.INT32, rows, data=b),
                             Column(dtypes.FLOAT64, rows, data=c)])
    yield "bench_nullable", CS.make_table(CS.BENCH_ROWS, CS.BENCH_COLS,
                                          "cuda", seed=8, nullable_every=3)


def to_rows_bytes(table):
    cols = table.columns
    return (sum(c.data.numel() * c.data.element_size() for c in cols)
            + sum(c.validity.numel() for c in cols if c.validity is not None)
            + table.num_rows * CS.layout_of(table)[2])


def kernel_ms(kernel, fn, calls):
    """Mean device milliseconds of `kernel` per call of `fn`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
    CS.check(len(events) == calls,
             f"{len(events)} {kernel} launches in {calls} calls")
    return sum(e.device_time_total for e in events) / calls / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("row_kernel_times: needs a CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    for name, table in tables():
        cols = table.columns
        starts, voff, row_size = CS.layout_of(table)
        ms = kernel_ms("to_rows_kernel", lambda: RA.assemble_rows(
            cols, starts, voff, row_size), args.calls)
        report("to_rows", name, table, ms, to_rows_bytes(table))
        if name == "bench":
            schema = [c.dtype for c in cols]
            rows = RA.assemble_rows(cols, starts, voff, row_size)
            ms = kernel_ms("from_rows_kernel", lambda: RA.disassemble_rows(
                rows, schema, starts, voff, row_size), args.calls)
            # rows read; columns and a (ncols, rows) validity written
            moved = (rows.numel() + sum(c.data.numel() * c.data.element_size()
                                        for c in cols)
                     + len(cols) * table.num_rows)
            report("from_rows", name, table, ms, moved)
            del rows
        del table, cols
    return 0


def report(kernel, shape, table, ms, moved):
    print(json.dumps({
        "kernel": kernel, "shape": shape, "rows": table.num_rows,
        "cols": table.num_columns, "kernel_ms": ms, "bytes": moved,
        "bound_ms": moved / CS.HBM_BYTES_PER_S * 1e3}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
