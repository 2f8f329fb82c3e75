#!/usr/bin/env python3
"""Where the PyTorch port's main path spends device time, on one GPU.

    python3 scripts/torch_port_profile.py [--out DIR]

Profiles, after one warm-up call each, the flagship step on 2^22 rows,
the bench-shape round trip (212 cycled fixed-width columns x 2^19 rows,
to-rows then from-rows), the JNI-door round trip on chip_smoke.py's
string table (155 columns x 2^20 rows: the two hash entries, then
convert_to_rows and convert_from_rows), one fused call each of the
TPC-DS stage path's q5, q72 and q89 at chip_smoke.py's sizes (the
warm-up call compiles their stages), and one `groupby_aggregate` on
chip_smoke.py's 2^25-row store_sales batch, and chip_smoke.py's join
cells J2 (2^25 x 2^22 rows on (item, ticket)) and J3 (2^22 x 2^21 rows
on 204,000 items, about 43.1M pairs) under the device_sort and
device_hash engines, with torch.profiler.  For each it
prints one JSON line: wall milliseconds (synchronized), summed device
time of the kernels and copies, the device's busy share of the wall
time, the kernels that took the most device time and, for the JNI door,
the host milliseconds of each entry (a record_function range around each
call).  The join phases also give each step's range: host milliseconds
(`entry_host_ms`) and the device span from its first kernel to its last
(`range_device_ms`): the key ids, the pair count and the probe for
device_sort; the key words, the hashes, the probe and the probe with its
verify for device_hash.  The profiler's own table goes to
DIR/torch_profile_<phase>.txt.  Exits non-zero without a CUDA device or
when the profiler records no device activity.
"""

import argparse
import collections
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_RANGES = ("entry:", "stage:")


def _profile(name, fn, out_dir):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel = collections.Counter()
    ranges = collections.Counter()
    device_ranges = collections.Counter()
    for e in prof.events():
        if e.name.startswith(_RANGES):
            # this script's own ranges: host time, and on the device
            # timeline the span of the kernels launched inside (no kernel)
            if e.device_type == DeviceType.CPU:
                ranges[e.name] += e.time_range.elapsed_us() / 1e3
            else:
                device_ranges[e.name] += e.time_range.elapsed_us() / 1e3
        elif e.device_type == DeviceType.CUDA:
            per_kernel[e.name[:90]] += e.time_range.elapsed_us()
    device_us = sum(per_kernel.values())
    if device_us == 0:
        raise RuntimeError(f"{name}: torch.profiler recorded no device time")
    with open(os.path.join(out_dir, f"torch_profile_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_device_time_total",
                                          row_limit=40))
    return {
        "phase": name, "wall_ms": wall_us / 1e3,
        "entry_host_ms": dict(ranges),
        "range_device_ms": dict(device_ranges),
        "device_ms": device_us / 1e3,
        "device_busy_share": device_us / wall_us,
        "device_kernels": sum(1 for e in prof.events()
                              if e.device_type == DeviceType.CUDA
                              and not e.name.startswith(_RANGES)),
        "top": [{"kernel": k, "ms": us / 1e3}
                for k, us in per_kernel.most_common(12)],
    }


def _jni_door(chip_smoke):
    """The JNI-door step on chip_smoke's string table, each entry in a
    record_function range; it releases every handle it makes."""
    from torch.profiler import record_function

    from spark_rapids_tpu_torch.columns import interop
    from spark_rapids_tpu_torch.shim import jni_api

    table = interop.table_from_host(chip_smoke.string_host_specs(
        chip_smoke.STRING_ROWS, chip_smoke.STRING_COLS, seed=11), "cuda")
    handles = [jni_api.REGISTRY.register(c) for c in table.columns]
    keys = [handles[k] for k in chip_smoke.HASH_KEYS]
    kinds = [c.dtype.kind for c in table.columns]
    scales = [c.dtype.scale for c in table.columns]

    def step():
        with record_function("entry:murmur_hash3_32"):
            mm = jni_api.murmur_hash3_32(42, keys)
        with record_function("entry:xx_hash_64"):
            xx = jni_api.xx_hash_64(42, keys)
        with record_function("entry:convert_to_rows"):
            rows = jni_api.convert_to_rows(handles)
        with record_function("entry:convert_from_rows"):
            back = jni_api.convert_from_rows(rows, kinds, scales)
        chip_smoke.release_all(mm, xx, rows, back)
    return step


def _stage_query(chip_smoke, name):
    """One fused call of q5, q72 or q89 at chip_smoke's full size."""
    from spark_rapids_tpu_torch.models import tpcds as TT
    from spark_rapids_tpu_torch.plan import catalog as TC

    os.environ["SPARK_RAPIDS_TPU_STAGE_FUSION"] = "1"
    if name == "q89":
        d = TT.gen_q89(device="cuda", **chip_smoke.Q89_DATA)
        stores, items = (chip_smoke.Q89_DATA["stores"],
                         chip_smoke.Q89_DATA["items"])
        return lambda: TC.run_q89(d, stores, items)
    if name == "q5":
        d = TT.gen_q5(device="cuda", **chip_smoke.Q5_DATA)
        stores = chip_smoke.Q5_DATA["stores"]
        return lambda: TC.run_q5(d, stores, chip_smoke.Q5_CAPACITY)
    d = TT.gen_q72(device="cuda", **chip_smoke.Q72_DATA)
    return lambda: TC.run_q72(
        d, chip_smoke.Q72_DATA["items"], chip_smoke.Q72_MAX_WEEK,
        chip_smoke.Q72_CAPACITY, chip_smoke.Q72_LIMIT, chip_smoke.Q72_WEEK0)


def _groupby_batch(chip_smoke):
    """chip_smoke's group-by on its store_sales batch: (store, item)
    keys, sum(quantity), count, min and max(price), sum and
    mean(net_paid)."""
    from spark_rapids_tpu_torch.columns.table import Table
    from spark_rapids_tpu_torch.ops import groupby as G

    cols = chip_smoke.store_sales_batch(chip_smoke.OPS_ROWS, seed=29).columns
    keys = Table(cols[:2])
    values = [cols[2], cols[4], cols[3], cols[3], cols[4], cols[4]]
    aggs = ["sum", "count", "min", "max", "sum", "mean"]
    return lambda: G.groupby_aggregate(keys, values, aggs)


def _stage(name, fn):
    """``fn`` inside a record_function range named stage:<name>."""
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(f"stage:{name}"):
            return fn(*args, **kwargs)
    return wrapped


def _join_stages():
    """Wrap the join engines' steps in stage ranges (for this process
    only): the profile then splits each engine's time by step."""
    from spark_rapids_tpu_torch.ops import hash_join as HJ
    from spark_rapids_tpu_torch.ops import joins as J

    J._device_ids = _stage("key_ids", J._device_ids)
    J._device_join_total = _stage("pair_count", J._device_join_total)
    J.inner_join_device = _stage("probe", J.inner_join_device)
    HJ.join_key_words = _stage("key_words", HJ.join_key_words)
    HJ.key_hashes = _stage("hashes", HJ.key_hashes)
    HJ.inner_join_device = _stage("probe", HJ.inner_join_device)
    factory = HJ._device_step_factory
    HJ._device_step_factory = lambda cap: _stage("probe_and_verify",
                                                 factory(cap))


def _join_batch(chip_smoke):
    """(phase, step) for J2 and J3 under device_sort and device_hash."""
    from spark_rapids_tpu_torch.ops import joins as J

    engines = J._join_engines()
    for name, left, right, nulls, _ in chip_smoke.join_cells(oracle=False):
        if name in ("J2", "J3"):
            for engine in ("device_sort", "device_hash"):
                yield (f"join_{name}_{engine}",
                       lambda f=engines[engine], l=left, r=right, n=nulls:
                       f(l, r, n))
        if name == "J3":
            return


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_port_profile: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from spark_rapids_tpu_torch.models import flagship as F
    from spark_rapids_tpu_torch.ops import row_conversion as RC

    os.makedirs(args.out, exist_ok=True)
    inputs = F.example_inputs(chip_smoke.FLAGSHIP_ROWS, device="cuda")
    bench = chip_smoke.make_table(chip_smoke.BENCH_ROWS,
                                  chip_smoke.BENCH_COLS, "cuda", seed=7)
    schema = [c.dtype for c in bench.columns]
    phases = {
        "flagship_step": lambda: F.flagship_step(*inputs),
        "bench_round_trip": lambda: RC.convert_from_rows(
            RC.convert_to_rows(bench), schema),
        "jni_door_round_trip": _jni_door(chip_smoke),
    }
    print(f"device: {torch.cuda.get_device_name(0)}")
    for name, fn in phases.items():
        print(json.dumps(_profile(name, fn, args.out)), flush=True)
    del phases, inputs, bench
    for name in ("q5", "q72", "q89"):
        fn = _stage_query(chip_smoke, name)
        print(json.dumps(_profile(f"{name}_fused", fn, args.out)),
              flush=True)
        del fn
        torch.cuda.empty_cache()
    print(json.dumps(_profile("groupby_batch", _groupby_batch(chip_smoke),
                              args.out)), flush=True)
    torch.cuda.empty_cache()
    _join_stages()
    for name, fn in _join_batch(chip_smoke):
        print(json.dumps(_profile(name, fn, args.out)), flush=True)
    del fn
    torch.cuda.empty_cache()
    from torch._inductor.async_compile import shutdown_compile_workers
    shutdown_compile_workers()
    return 0


if __name__ == "__main__":
    sys.exit(main())
