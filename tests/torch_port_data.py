"""Seeded host tables for the PyTorch-port parity tests.

A table is a list of `(kind, data, validity)` triples laid out as the JAX
package's Column holds them on the host (FLOAT64 as uint64 raw bits,
DECIMAL128 as (rows, 4) int32 limbs), and `("string", chars, validity,
offsets)` 4-tuples for STRING columns.  The same tuples build the JAX
table and, through spark_rapids_tpu_torch.columns.interop, the port's.
"""

import numpy as np

from spark_rapids_tpu.columns import bytesview as jbytes
from spark_rapids_tpu.ops import row_assembly_pallas as JP
from spark_rapids_tpu.ops import row_conversion as JRC
from spark_rapids_tpu_torch.columns import bytesview, dtypes, interop
from spark_rapids_tpu_torch.ops import row_conversion as RC

# the 8-dtype cycle of bench_impl.py and tests/test_row_assembly_pallas.py
CYCLE = ["int64", "int32", "float64", "float32", "int16", "int8", "bool8",
         "timestamp_micros"]
EXTRA = ["uint8", "uint16", "uint32", "uint64", "timestamp_days",
         "decimal32", "decimal64"]

_NP = {"bool8": np.uint8, "int8": np.int8, "int16": np.int16,
       "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
       "uint16": np.uint16, "uint32": np.uint32, "uint64": np.uint64,
       "float32": np.float32, "float64": np.float64,
       "timestamp_days": np.int32, "timestamp_micros": np.int64,
       "decimal32": np.int32, "decimal64": np.int64}

# bit patterns Spark's hash rules and the row format must carry exactly
F64_SPECIAL = np.array([0x7FF8000000000000, 0x7FF0000000000001,
                        0xFFFFFFFFFFFFFFFF, 0x7FFFFFFFFFFFFFFF,
                        0x8000000000000000, 0x0000000000000000,
                        0x7FF0000000000000, 0xFFF0000000000000,
                        0x0000000000000001], np.uint64)
# float32 denormals are left out: the JAX package's xxhash64 compares
# `x == 0.0`, which XLA's CPU backend evaluates with denormals flushed, so
# it hashes them as 0.0 where Spark does not (ROADMAP Queue C;
# test_torch_hash.py holds the port to Spark there)
F32_SPECIAL = np.array([0x7FC00000, 0x7F800001, 0xFFFFFFFF, 0x80000000,
                        0x00000000, 0x7F800000, 0xFF800000], np.uint32)


def host_strings(rng, rows, max_len=32, nullable=False, skew=0, lens=None):
    """A STRING host column of random bytes, lengths uniform in
    [0, max_len] (or `lens`).  A null row keeps its bytes and length, and
    the offsets start at `skew` (a sliced column)."""
    if lens is None:
        lens = rng.integers(0, max_len + 1, rows)
    lens = np.asarray(lens, np.int64)
    offs = np.zeros(rows + 1, np.int64)
    offs[1:] = np.cumsum(lens)
    offs += skew
    chars = rng.integers(0, 256, int(offs[-1]) + skew).astype(np.uint8)
    validity = None
    if nullable:
        validity = (rng.random(rows) >= 0.3).astype(np.uint8)
    return "string", chars, validity, offs.astype(np.int32)


def host_column(rng, kind, rows, nullable=False, specials=True):
    """One seeded host column; `specials` plants NaN payloads, +-0.0,
    infinities and integer extremes at random rows."""
    if kind == "string":
        return host_strings(rng, rows, nullable=nullable)
    if kind == "decimal128":
        data = rng.integers(-2**31, 2**31, (rows, 4)).astype(np.int32)
    elif kind == "float64":
        data = rng.normal(size=rows).view(np.uint64).copy()
        if specials and rows:
            idx = rng.integers(0, rows, F64_SPECIAL.size)
            data[idx] = F64_SPECIAL
    elif kind == "float32":
        data = rng.normal(size=rows).astype(np.float32)
        if specials and rows:
            idx = rng.integers(0, rows, F32_SPECIAL.size)
            data.view(np.uint32)[idx] = F32_SPECIAL
    elif kind == "bool8":
        data = rng.integers(0, 2, rows).astype(np.uint8)
    else:
        dt = np.dtype(_NP[kind])
        info = np.iinfo(dt)
        data = rng.integers(info.min, info.max, rows, dtype=dt,
                            endpoint=True)
        if specials and rows >= 3:
            data[:3] = [info.min, info.max, -1 if info.min else 0]
    validity = None
    if nullable:
        validity = rng.integers(0, 2, rows).astype(np.uint8)
    return kind, data, validity


def host_table(rng, rows, kinds, null_every=0, specials=True):
    """Host triples for `kinds`; every `null_every`-th column nullable."""
    return [host_column(rng, k, rows,
                        nullable=bool(null_every) and i % null_every == 0,
                        specials=specials)
            for i, k in enumerate(kinds)]


def cycle_kinds(ncols, dec128_every=0):
    kinds = [CYCLE[i % len(CYCLE)] for i in range(ncols)]
    if dec128_every:
        kinds = ["decimal128" if i % dec128_every == dec128_every - 1 else k
                 for i, k in enumerate(kinds)]
    return kinds


def jax_table(specs):
    """The JAX package's Table over the same host arrays."""
    import jax.numpy as jnp
    from spark_rapids_tpu.columns.column import Column
    from spark_rapids_tpu.columns.dtypes import DType
    from spark_rapids_tpu.columns.table import Table

    cols = []
    for kind, data, validity, *offsets in specs:
        v = None if validity is None else jnp.asarray(validity)
        if offsets:
            cols.append(Column(DType(kind), offsets[0].shape[0] - 1,
                               data=jnp.asarray(data), validity=v,
                               offsets=jnp.asarray(offsets[0])))
            continue
        cols.append(Column(DType(kind), data.shape[0],
                           data=jnp.asarray(data), validity=v))
    return Table(cols)


def port_table(specs):
    return interop.table_from_host(specs, device="cpu")


# ------------------------------------------ row conversion parity checks


def rowconv_specs(rows, ncols, dec_every):
    """Cycle-schema host table, every third column nullable."""
    rng = np.random.default_rng(rows * 1000 + ncols)
    return host_table(rng, rows, cycle_kinds(ncols, dec_every),
                      null_every=3)


def _jax_row_bytes(words, rows, row_size):
    return jbytes.to_host_bytes(words, rows * row_size)


def check_to_rows(rows, ncols, dec_every, br):
    specs = rowconv_specs(rows, ncols, dec_every)
    jt, pt = jax_table(specs), port_table(specs)
    starts, voff, fixed = JRC.compute_layout([c.dtype for c in jt.columns])
    row_size = RC.row_size_of([c.dtype for c in pt.columns])

    got = RC.convert_to_rows(pt)
    got_bytes = bytesview.to_host_bytes(got.children[0].data,
                                        rows * row_size)
    ref = JRC.convert_to_rows(jt)
    assert _jax_row_bytes(ref.children[0].data, rows, row_size) == got_bytes
    np.testing.assert_array_equal(np.asarray(ref.offsets),
                                  got.offsets.numpy())
    pallas = JP.assemble_fixed_words_pallas(
        jt.columns, starts, voff, row_size, block_rows=br, interpret=True)
    assert _jax_row_bytes(pallas, rows, row_size) == got_bytes


def check_from_rows(rows, ncols, dec_every, br):
    """The reference's row bytes, decoded by the port, the JAX default
    path and the Pallas kernel: every column and validity equal."""
    specs = rowconv_specs(rows, ncols, dec_every)
    jt = jax_table(specs)
    schema_j = [c.dtype for c in jt.columns]
    ref_rows = JRC.convert_to_rows(jt)
    port_rows = interop.rows_from_host(np.asarray(ref_rows.offsets),
                                       np.asarray(ref_rows.children[0].data),
                                       device="cpu")
    got = interop.table_to_host(RC.convert_from_rows(
        port_rows, [dtypes.DType(k) for k, _d, _v in specs]))
    for ref in (JRC.convert_from_rows(ref_rows, schema_j),
                JP.convert_from_rows_pallas(ref_rows, schema_j,
                                            block_rows=br, interpret=True)):
        for ci, (rc, (_k, d, v)) in enumerate(zip(ref.columns, got)):
            assert np.asarray(rc.data).tobytes() == d.tobytes(), ci
            np.testing.assert_array_equal(np.asarray(rc.validity), v,
                                          err_msg=f"validity {ci}")
    for (_k, d0, v0), (_k2, d, v) in zip(specs, got):   # and the input
        assert d0.tobytes() == d.tobytes()
        want = np.ones_like(v) if v0 is None else (v0 != 0).astype(np.uint8)
        np.testing.assert_array_equal(want, v)


# ------------------------------------------------- TPC-DS catalog cases
# name -> (generator, its arguments, run(catalog module, data)): the
# catalog's single-stage queries at the sizes of tests/test_stage_fusion.py,
# 3001 rows so the bucket pad path runs, q67 also at 100 rows (dead groups)
CATALOG_CASES = {
    "q3": ("gen_q3", dict(rows=3001, items=64, days=730, brands=8),
           lambda m, d: m.run_q3(d, 10_957, years=3, brands=8, manufact=2)),
    "q9": ("gen_q9", dict(rows=3001), lambda m, d: m.run_q9(*d)),
    "q67": ("gen_q67", dict(rows=3001, ncat=6, ncls=5),
            lambda m, d: m.run_q67(d, 6, 5)),
    "q67_sparse": ("gen_q67", dict(rows=100, ncat=10, ncls=16, seed=4),
                   lambda m, d: m.run_q67(d, 10, 16)),
    "cube": ("gen_q67", dict(rows=3001, ncat=4, ncls=3, seed=3),
             lambda m, d: m.run_cube(d, 4, 3)),
    "q89": ("gen_q89", dict(rows=3001, stores=9, items=400),
            lambda m, d: m.run_q89(d, 9, 400)),
}


def np_of(x):
    """A tensor's or an array's host numpy value."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def same_outputs(got, want):
    """Equal output tuples: dtype, shape and bytes of each."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np_of(g), np_of(w)
        assert g.dtype == w.dtype and g.shape == w.shape, (i, g.dtype,
                                                           w.dtype)
        assert g.tobytes() == w.tobytes(), i
