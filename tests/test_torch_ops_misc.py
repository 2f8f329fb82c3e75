"""PyTorch port: z-order and Hilbert indexes, the Iceberg transforms,
substring_index, CASE WHEN's first-true index, random UUIDs and the
utilities, against the JAX package byte for byte on seeded values, with
the cases of tests/test_ops_batch1.py:165-259 and
tests/test_inventory_batch.py:106-155.

UUIDs are not compared with the JAX package's bytes: its generator is
jax.random's threefry, whose stream torch cannot reproduce, so the port
draws from a torch.Generator seeded with the same seed.  What is
checked is the format (version nibble 4, variant 8-b, dashes at 8, 13,
18 and 23, lowercase hex), that a seed gives the same column every time
and that 2^16 UUIDs hold no repeat."""

import datetime
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.ops import case_when as JCW
from spark_rapids_tpu.ops import iceberg as JIB
from spark_rapids_tpu.ops import utilities as JU
from spark_rapids_tpu.ops import zorder as JZ
from spark_rapids_tpu.ops.substring_index import \
    substring_index as jsubstring_index
from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu_torch.columns import dtypes
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import case_when as CW
from spark_rapids_tpu_torch.ops import iceberg as IB
from spark_rapids_tpu_torch.ops import string_utils as SU
from spark_rapids_tpu_torch.ops import utilities as U
from spark_rapids_tpu_torch.ops import uuid_gen as UG
from spark_rapids_tpu_torch.ops import zorder as Z
from spark_rapids_tpu_torch.ops.substring_index import substring_index
from torch_port_data import (col_parts, host_column, jax_column,
                             port_column, strings_spec, values_spec)


def both(spec):
    return port_column(spec), jax_column(spec)


def same(got, want):
    assert col_parts(got) == col_parts(want)


# ----------------------------------------------------------------- zorder


@pytest.mark.parametrize("kind,ncols", [
    ("int32", 2), ("int64", 3), ("float32", 2), ("float64", 2),
    ("int8", 5), ("bool8", 3), ("uint64", 2), ("int16", 1),
    ("timestamp_micros", 2)])
def test_interleave_bits_matches_reference(kind, ncols):
    rng = np.random.default_rng(ncols * 10 + len(kind))
    specs = [host_column(rng, kind, 257, nullable=i % 2 == 0)
             for i in range(ncols)]
    got = Z.interleave_bits([port_column(s) for s in specs])
    same(got, JZ.interleave_bits([jax_column(s) for s in specs]))


def test_interleave_goldens_and_refusals():
    a = Column.from_pylist([0b1010, 0], dtypes.INT32, "cpu")
    b = Column.from_pylist([0b0101, None], dtypes.INT32, "cpu")
    blobs = Z.interleave_bits([a, b]).to_pylist()
    assert len(blobs[0]) == 8 and blobs[0][-1] == 0x99
    assert blobs[1] == [0] * 8                  # null treated as 0
    with pytest.raises(ValueError):
        Z.interleave_bits([a, Column.from_pylist([1], dtypes.INT64, "cpu")])
    with pytest.raises(ValueError):
        Z.interleave_bits([])


@pytest.mark.parametrize("num_bits,ncols", [(2, 2), (10, 3), (18, 2),
                                            (32, 2), (16, 4), (1, 1),
                                            (21, 3)])
def test_hilbert_index_matches_reference(num_bits, ncols):
    rng = np.random.default_rng(num_bits * 7 + ncols)
    specs = [host_column(rng, "int32", 300, nullable=i == 0)
             for i in range(ncols)]
    got = Z.hilbert_index(num_bits, [port_column(s) for s in specs])
    same(got, JZ.hilbert_index(num_bits, [jax_column(s) for s in specs]))


def test_hilbert_goldens_and_refusals():
    xs = Column.from_pylist(list(range(4)) * 4, dtypes.INT32, "cpu")
    ys = Column.from_pylist([y for y in range(4) for _ in range(4)],
                            dtypes.INT32, "cpu")
    out = Z.hilbert_index(2, [xs, ys]).to_pylist()
    assert sorted(out) == list(range(16)) and out[0] == 0
    one = [Column.from_pylist([1], dtypes.INT32, "cpu")]
    for bad in (0, 33):
        with pytest.raises(ValueError, match="number of bits"):
            Z.hilbert_index(bad, one)
    with pytest.raises(ValueError, match="64"):
        Z.hilbert_index(32, one * 3)


# ---------------------------------------------------------------- iceberg


@pytest.mark.parametrize("kind", ["int32", "int64", "timestamp_days",
                                  "timestamp_micros", "decimal32",
                                  "decimal64", "decimal128", "string"])
@pytest.mark.parametrize("buckets", [16, 1000, 7])
def test_bucket_matches_reference(kind, buckets):
    rng = np.random.default_rng(len(kind) + buckets)
    spec = host_column(rng, kind, 300, nullable=True)
    p, j = both(spec)
    same(IB.bucket(p, buckets), JIB.bucket(j, buckets))


def test_bucket_goldens():
    """Iceberg spec vectors: bucket hash of int 34 = 2017239379 and of
    'iceberg' = 1210000089 (Iceberg BucketUtil javadoc)."""
    c = Column.from_pylist([34], dtypes.INT32, "cpu")
    h = IB._std_murmur_u64(c.data.to(torch.int64))
    assert int(np.int64(h[0]).astype(np.int32)) == 2017239379
    chars, lens = Column.from_strings(["iceberg"], "cpu").to_padded_chars()
    assert int(IB._std_murmur_varbytes(chars, lens)[0]) == 1210000089
    assert IB.bucket(c, 16).to_pylist() == [(2017239379 & 0x7FFFFFFF) % 16]


@pytest.mark.parametrize("kind,width", [("int32", 10), ("int64", 7),
                                        ("decimal32", 100),
                                        ("decimal64", 3), ("int64", 1)])
def test_truncate_matches_reference(kind, width):
    rng = np.random.default_rng(width)
    p, j = both(host_column(rng, kind, 300, nullable=True))
    same(IB.truncate(p, width), JIB.truncate(j, width))


def test_truncate_strings_and_goldens():
    vals = ["日本語テキスト", "ab", None, "", "éèê", "a\U0001F600b",
            "0123456789abc"]
    p, j = both(strings_spec(vals))
    for w in (1, 3, 10):
        same(IB.truncate(p, w), JIB.truncate(j, w))
    assert IB.truncate(p, 3).to_pylist()[:3] == ["日本語", "ab", None]
    c = Column.from_pylist([10, 15, -5, None], dtypes.INT32, "cpu")
    assert IB.truncate(c, 10).to_pylist() == [10, 10, -10, None]


@pytest.mark.parametrize("kind", ["timestamp_days", "timestamp_micros"])
def test_datetime_transforms_match_reference(kind):
    rng = np.random.default_rng(len(kind))
    if kind == "timestamp_days":
        vals = [int(x) for x in rng.integers(-200_000, 200_000, 400)]
    else:
        vals = [int(x) for x in rng.integers(-10**16, 10**16, 400)]
        vals[:4] = [-1, 0, 1, -86_400_000_001]
    vals[5] = None
    p, j = both(values_spec(kind, vals))
    for fn, jfn in ((IB.year, JIB.year), (IB.month, JIB.month),
                    (IB.day, JIB.day)):
        same(fn(p), jfn(j))
    if kind == "timestamp_micros":
        same(IB.hour(p), JIB.hour(j))


def test_datetime_goldens():
    d = (datetime.date(2017, 11, 16) - datetime.date(1970, 1, 1)).days
    c = Column.from_pylist([d], dtypes.TIMESTAMP_DAYS, "cpu")
    assert IB.year(c).to_pylist() == [47]
    assert IB.month(c).to_pylist() == [47 * 12 + 10]
    assert IB.day(c).to_pylist() == [d]
    t = Column.from_pylist([d * 86_400_000_000 + 3 * 3_600_000_000],
                           dtypes.TIMESTAMP_MICROS, "cpu")
    assert IB.hour(t).to_pylist() == [d * 24 + 3]


# -------------------------------------------------------- substring_index


SI_CASES = [("www.apache.org", ".", 3, "www.apache.org"),
            ("www.apache.org", ".", 2, "www.apache"),
            ("www.apache.org", ".", 1, "www"),
            ("www.apache.org", ".", 0, ""),
            ("www.apache.org", ".", -1, "org"),
            ("www.apache.org", ".", -2, "apache.org"),
            ("www.apache.org", ".", -3, "www.apache.org"),
            ("", ".", -2, ""),
            ("大千世界大千世界", "千", 2, "大千世界大"),
            ("www||apache||org", "||", 2, "www||apache"),
            ("aaa", "aa", -1, ""),
            ("aaa", "aa", 1, "")]


@pytest.mark.parametrize("s,delim,count,want", SI_CASES)
def test_substring_index_goldens(s, delim, count, want):
    got = substring_index(Column.from_strings([s], "cpu"), delim, count)
    assert got.to_pylist() == [want]


def _seeded_paths(seed, n=400):
    rng = np.random.default_rng(seed)
    parts = ["www", "apache", "org", "a", "", "||", "aa", "ab", "日本"]
    out = []
    for _ in range(n):
        k = int(rng.integers(0, 8))
        seps = [[".", "||", "aa", "/"][int(rng.integers(0, 4))]
                for _ in range(k)]
        words = [parts[int(rng.integers(0, len(parts)))]
                 for _ in range(k + 1)]
        out.append("".join(w + s for w, s in zip(words, seps + [""])))
    out[3] = None
    return out


@pytest.mark.parametrize("delim", [".", "||", "aa", "/", "日本", "x"])
@pytest.mark.parametrize("count", [1, 2, 3, -1, -2, -4, 0])
def test_substring_index_matches_reference(delim, count):
    p, j = both(strings_spec(_seeded_paths(len(delim) * 10 + count + 5)))
    same(substring_index(p, delim, count),
         jsubstring_index(j, delim, count))


def test_substring_index_edges_match_reference():
    p, j = both(strings_spec(["a", "", None, "bb"]))
    for delim, count in (("longer-than-any", 1), ("", 2), ("a", 0)):
        same(substring_index(p, delim, count),
             jsubstring_index(j, delim, count))
    assert SU.substring_index is substring_index


# -------------------------------------------------------------- case_when


def test_select_first_true_index_matches_reference():
    rng = np.random.default_rng(5)
    specs = [host_column(rng, "bool8", 500, nullable=i % 2 == 1)
             for i in range(4)]
    same(CW.select_first_true_index([port_column(s) for s in specs]),
         JCW.select_first_true_index([jax_column(s) for s in specs]))
    w1 = Column.from_pylist([True, False, None, False], dtypes.BOOL8, "cpu")
    w2 = Column.from_pylist([True, True, False, False], dtypes.BOOL8, "cpu")
    assert CW.select_first_true_index([w1, w2]).to_pylist() == [0, 1, 2, 2]
    with pytest.raises(ValueError):
        CW.select_first_true_index([])


# ------------------------------------------------------------------ uuids

UUID_RE = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}"
                     r"-[0-9a-f]{12}$")


def test_random_uuids_format_determinism_uniqueness():
    col = UG.random_uuids(1 << 16, seed=7, device="cpu")
    out = col.to_pylist()
    assert col.validity is None and col.offsets[-1] == 36 << 16
    assert all(UUID_RE.match(u) for u in out)
    assert all(u[8] == u[13] == u[18] == u[23] == "-" for u in out)
    assert len(set(out)) == 1 << 16
    again = SU.random_uuids(5, seed=7, device="cpu").to_pylist()
    assert again == out[:5]
    assert UG.random_uuids(5, seed=8, device="cpu").to_pylist() != again
    assert UG.random_uuids(0, seed=1, device="cpu").length == 0


# -------------------------------------------------------------- utilities


def test_utilities_match_reference():
    rng = np.random.default_rng(1)
    masks = [rng.integers(0, 256, 33).astype(np.uint8) for _ in range(3)]
    got = U.bitmask_bitwise_or([torch.from_numpy(m) for m in masks])
    want = JU.bitmask_bitwise_or([jnp.asarray(m) for m in masks])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        U.bitmask_bitwise_or([torch.zeros(1, dtype=torch.uint8),
                              torch.zeros(2, dtype=torch.uint8)])
    with pytest.raises(ValueError):
        U.bitmask_bitwise_or([])
    kinds = ["int8", "int16", "int32", "int64", "uint32", "float32",
             "float64", "decimal32", "decimal64", "decimal128", "string",
             "bool8", "timestamp_days", "list"]
    for k in kinds:
        assert U.is_spark_numeric(dtypes.DType(k)) == \
            JU.is_spark_numeric(jdtypes.DType(k))


# ----------------------------------------------------- the import rule

SLICE_MODULES = ["utilities", "arithmetic", "decimal_device",
                 "decimal_utils", "cast_more", "sha_device", "sha",
                 "bloom_filter", "hllpp", "histogram", "zorder", "iceberg",
                 "substring_index", "case_when", "uuid_gen", "string_utils"]


def test_slice_modules_load_no_jax():
    """Each module of this slice, imported alone in a fresh interpreter,
    loads neither JAX nor the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    mods = [f"spark_rapids_tpu_torch.ops.{m}" for m in SLICE_MODULES] + \
        ["spark_rapids_tpu_torch.shim.jni_entry"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "    bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'spark_rapids_tpu.')) or "
            "k == 'spark_rapids_tpu')\n"
            "    assert not bad, (m, bad)\n")
    subprocess.run([sys.executable, "-c", code],
                   cwd=Path(__file__).resolve().parents[1], check=True,
                   timeout=120)


def test_ops_phase_rehearsal_on_cpu():
    """chip_smoke.py's ops phase on CPU tensors at a small size: every
    call against its CPU slice, the decimals (forced onto the limbs)
    against the host loop, the bloom bytes, the merged sketches, the
    percentiles and the UUID format."""
    import chip_smoke as C
    res = C.ops_phase("cpu", rows=1 << 12, dec_rows=1 << 12,
                      str_rows=1 << 12, url_rows=1 << 11, ts_rows=1 << 12,
                      bin_rows=1 << 12, uuid_rows=1 << 12, cpu_rows=1 << 10,
                      wide_cpu_rows=1 << 11, host_rows=1 << 10,
                      customers=5000, iters=1)
    assert res["dec_divide_q49"]["route"] == C.ROUTE_LIMBS
    assert res["dec_multiply"]["overflow_rows_checked"] > 0
    assert res["multiply_int64_ansi"]["raised_at_row"] is not None
    assert res["hllpp_estimate"]["rel_err"] < C.HLL_MAX_ERR
    assert set(res["group_s"]) == {"decimals", "arithmetic", "casts", "sha",
                                   "sketches", "zorder_iceberg", "strings"}
