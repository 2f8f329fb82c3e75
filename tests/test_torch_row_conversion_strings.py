"""PyTorch port: JCUDF rows of tables with strings held byte for byte
against the JAX package (its default path, its Pallas paste kernel in
interpret mode, and its XLA scatter) on the same seeded host tables.  On
the CPU the port runs the variable-width kernel's plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns import bytesview as jbytes
from spark_rapids_tpu.columns.dtypes import DType as JDType
from spark_rapids_tpu.ops import row_assembly_pallas as JP
from spark_rapids_tpu.ops import row_conversion as JRC
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
from spark_rapids_tpu_torch.ops import row_conversion as RC

from torch_port_data import (host_column, host_strings, host_table,
                             jax_table, port_table)

# the string main path's column cycle (chip_smoke.py)
STRING_CYCLE = ["int8", "int32", "int16", "int64", "int32", "bool8",
                "string", "uint16", "uint8", "uint64"]


def _var_specs(case):
    """Seeded host tables for each variable-width case."""
    rng = np.random.default_rng(len(case))
    if case == "ragged":
        return host_table(rng, 37, STRING_CYCLE + ["decimal128", "string"],
                          null_every=3)
    if case == "zero_rows":
        return host_table(rng, 0, ["int64", "string", "int8"])
    if case == "all_empty":
        return [host_strings(rng, 20, lens=[0] * 20),
                host_column(rng, "int16", 20, nullable=True),
                host_strings(rng, 20, lens=[0] * 20, nullable=True)]
    if case == "null_span_skew":
        # null strings whose offsets span bytes, offsets starting past 0,
        # and a 9-byte fixed section (the payload starts unaligned)
        return [host_strings(rng, 40, max_len=40, nullable=True, skew=6),
                ("int8", rng.integers(-9, 9, 40).astype(np.int8), None)]
    if case == "strings_only":
        return [host_strings(rng, 25, max_len=70, nullable=True, skew=1)]
    if case == "long_strings":
        # strings of a few KB, as in the rows the kernel writes straight
        # to device memory when a tile outgrows its shared buffer
        return [host_strings(rng, 12, max_len=6000, nullable=True, skew=3),
                host_column(rng, "int32", 12, nullable=True),
                host_strings(rng, 12, max_len=3000)]
    return host_table(rng, 300, [STRING_CYCLE[i % 10] for i in range(155)],
                      null_every=3)


VAR_CASES = ["ragged", "zero_rows", "all_empty", "null_span_skew",
             "strings_only", "long_strings", "cycle_155"]


def _port_rows(specs):
    got = RC.convert_to_rows(port_table(specs))
    return got, got.children[0].data.numpy().tobytes()


def _jax_rows(rows_col):
    nbytes = int(np.asarray(rows_col.offsets)[-1])
    return jbytes.to_host_bytes(rows_col.children[0].data, nbytes)


@pytest.mark.parametrize("case", VAR_CASES)
def test_to_rows_with_strings_matches_reference(case):
    specs = _var_specs(case)
    got, got_bytes = _port_rows(specs)
    ref = JRC.convert_to_rows(jax_table(specs))
    assert got.offsets.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(ref.offsets),
                                  got.offsets.numpy())
    assert _jax_rows(ref) == got_bytes


def test_to_rows_with_strings_matches_pallas_paste(monkeypatch):
    """The JAX package's variable-width path with its Pallas paste kernel
    (interpret mode) gives the port's bytes."""
    specs = _var_specs("ragged")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PALLAS_ROWCONV", "1")
    ref = JRC.convert_to_rows(jax_table(specs))
    assert _jax_rows(ref) == _port_rows(specs)[1]


@pytest.mark.parametrize("case", VAR_CASES)
def test_from_rows_with_strings_matches_reference(case):
    """The JAX package's row bytes, decoded by the port and by the JAX
    package: every column's data, offsets and validity equal."""
    specs = _var_specs(case)
    schema = [dtypes.DType(s[0]) for s in specs]
    ref_rows = JRC.convert_to_rows(jax_table(specs))
    port_rows = interop.rows_from_host(np.asarray(ref_rows.offsets),
                                       _jax_rows(ref_rows), device="cpu")
    got = RC.convert_from_rows(port_rows, schema)
    ref = JRC.convert_from_rows(ref_rows, [JDType(s[0]) for s in specs])
    for ci, (a, b) in enumerate(zip(got.columns, ref.columns)):
        assert a.data.numpy().tobytes() == np.asarray(b.data).tobytes(), ci
        np.testing.assert_array_equal(a.validity.numpy(),
                                      np.asarray(b.validity))
        if a.dtype.is_string:
            np.testing.assert_array_equal(a.offsets.numpy(),
                                          np.asarray(b.offsets))


@pytest.mark.parametrize("case", VAR_CASES)
def test_round_trip_with_strings_gives_the_input(case):
    specs = _var_specs(case)
    t = port_table(specs)
    back = RC.convert_from_rows(RC.convert_to_rows(t),
                                [c.dtype for c in t.columns])
    for a, b in zip(t.columns, back.columns):
        want = (torch.ones(t.num_rows, dtype=torch.uint8)
                if a.validity is None else (a.validity != 0).to(torch.uint8))
        assert torch.equal(b.validity, want)
        assert b.data.is_contiguous() and b.validity.is_contiguous()
        if a.dtype.is_string:   # chars come back compacted from offset 0
            lo, hi = int(a.offsets[0]), int(a.offsets[-1])
            assert torch.equal(b.data, a.data[lo:hi])
            assert torch.equal(b.offsets, a.offsets - a.offsets[0])
        else:
            assert b.data.numpy().tobytes() == a.data.numpy().tobytes()


@pytest.mark.parametrize("rows,max_row,pad,max_len,seed", [
    (100, 64, 16, 16, 5),    # tests/test_row_assembly_pallas.py's shape
    (37, 40, 8, 12, 6),      # lengths past pad, spans past the row end
])
def test_paste_strings_plain_matches_pallas_and_scatter(rows, max_row, pad,
                                                       max_len, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (rows, max_row)).astype(np.uint8)
    chars = rng.integers(97, 123, (rows, pad)).astype(np.uint8)
    lens = rng.integers(0, max_len + 1, rows).astype(np.int32)
    vstart = rng.integers(0, max_row - min(pad, max_len) + 8,
                          rows).astype(np.int32)
    got = RA.paste_strings_plain(*(torch.from_numpy(a) for a in
                                   (mat, chars, vstart, lens))).numpy()
    pallas = np.asarray(JP.paste_strings_pallas(
        jnp.asarray(mat), jnp.asarray(chars), jnp.asarray(vstart),
        jnp.asarray(lens), interpret=True))
    np.testing.assert_array_equal(pallas, got)
    j = np.arange(pad, dtype=np.int32)
    dest = vstart[:, None] + j[None, :]
    m = j[None, :] < lens[:, None]
    scatter = np.asarray(JRC._masked_row_scatter(
        jnp.asarray(mat), jnp.asarray(dest), jnp.asarray(chars),
        jnp.asarray(m)))
    np.testing.assert_array_equal(scatter, got)


def test_row_offsets_refuse_int32_overflow():
    """2^31 bytes of rows overflow the int32 offsets: the sum runs in
    int64 and raises before any row is built."""
    huge = Column(dtypes.STRING, 2, data=torch.zeros(0, dtype=torch.uint8),
                  offsets=torch.tensor([0, 2**30, 2**31 - 1],
                                       dtype=torch.int32))
    with pytest.raises(ValueError, match="overflow"):
        RC.var_row_offsets([huge], 16)
    offs, total = RC.var_row_offsets(
        [Column(dtypes.STRING, 2, data=torch.zeros(0, dtype=torch.uint8),
                offsets=torch.tensor([0, 2**29, 2**30],
                                     dtype=torch.int32))], 16)
    assert offs.dtype == torch.int32 and total == 2**30 + 32


def test_var_wrapper_refuses_devices_without_a_kernel():
    s = Column(dtypes.STRING, 2,
               data=torch.empty(4, dtype=torch.uint8, device="meta"),
               offsets=torch.empty(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="no to-rows kernel"):
        RA.assemble_var_rows([s], [0], 8, 9,
                             torch.empty(3, dtype=torch.int32,
                                         device="meta"), 32)


@pytest.mark.parametrize("fixed,rows,mean,ncols,nstr,log2_tile", [
    (888, 1 << 20, 1132, 155, 15, None),   # the JNI-door table
    (888, 1 << 20, 1132, 155, 15, 5),      # its timed tile sizes
    (888, 1 << 20, 1132, 155, 15, 7),
    (9, 7, 24, 3, 1, None),                # short rows: 256 a tile
    (25, 40, 37000, 4, 1, None),           # long strings: one row a tile
    (856, 40, 538981, 150, 15, None),      # rows past shared memory
    (2000, 64, 2100, 700, 20, None),       # many descriptors
])
def test_var_tile_fits_shared_memory(fixed, rows, mean, ncols, nstr,
                                     log2_tile):
    """The variable-width kernel's tile: rows from the mean row, a buffer
    of at least the tile's mean rows (when shared memory allows) and its
    fixed sections, all within one block's shared memory."""
    lg, buf = RA.var_tile(fixed, rows, rows * mean, ncols, nstr, log2_tile)
    t = 1 << lg
    if log2_tile is None:
        assert t == 1 or t * mean <= RA._VAR_TILE_BYTES
        assert t == 256 or 2 * t * mean > RA._VAR_TILE_BYTES
    else:
        assert lg == log2_tile
    smem = RA.var_smem_bytes(buf, ncols, nstr, t)
    assert buf % 16 == 0 and smem <= 227 * 1024
    assert buf >= t * ((fixed + 7) // 8 * 8)
    want = t * mean * (1 + RA._VAR_SLACK) + 16
    assert buf >= want or smem > 227 * 1024 - 16


def test_var_tile_keeps_four_blocks_an_sm_at_the_jni_door_shape():
    lg, buf = RA.var_tile(888, 1 << 20, 1132 << 20, 155, 15)
    assert lg == 5
    assert buf >= 32 * 1132 * (1 + RA._VAR_SLACK)
    assert 4 * (RA.var_smem_bytes(buf, 155, 15, 32) + 1024) <= 228 * 1024
    assert 5 * (RA.var_smem_bytes(buf, 155, 15, 32) + 1024) > 228 * 1024


def test_var_tile_refuses_what_shared_memory_cannot_hold():
    with pytest.raises(ValueError, match="shared memory"):
        RA.var_tile(16, 10, 160, 6000, 1)


def test_var_direct_tiles_counts_tiles_past_the_buffer():
    rng = np.random.default_rng(9)
    sizes = rng.integers(1, 40, 203) * 8
    sizes[[5, 77, 200]] = 4000
    offsets = torch.from_numpy(
        np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32))
    for lg, buf in ((0, 1024), (3, 2048), (5, 8192), (8, 1 << 20)):
        t = 1 << lg
        spans = [int(sizes[i:i + t].sum()) for i in range(0, 203, t)]
        want = sum(s + 8 > buf for s in spans)
        assert RA.var_direct_tiles(offsets, lg, buf) == want
