"""PyTorch port: JCUDF fixed-width row conversion held byte for byte against
the JAX package (its default path and its Pallas kernels in interpret
mode) on the same seeded host tables.  On the CPU the port runs the
kernels' plain versions."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns.dtypes import DType as JDType
from spark_rapids_tpu.ops import row_assembly_pallas as JP
from spark_rapids_tpu.ops import row_conversion as JRC
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.columns.table import Table
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
from spark_rapids_tpu_torch.ops import row_conversion as RC

from torch_port_data import (CYCLE, EXTRA, check_from_rows, check_to_rows,
                             cycle_kinds, host_table)

# (rows, ncols, DECIMAL128 every n-th column, Pallas block rows); the
# 212-column bench schema is in test_torch_row_conversion_wide.py
SHAPES = [
    (1000, 20, 11, 256),   # ragged last tile, DECIMAL128, nulls
    (7, 3, 0, 512),        # rows < tile
    (256, 12, 5, 256),     # exact single tile, two DECIMAL128 columns
]


@pytest.mark.parametrize("schema_kinds", [
    ["bool8", "int16", "int32"],
    ["int32", "int16", "bool8"],
    CYCLE + EXTRA + ["decimal128"],
    ["int8", "decimal128", "int16", "float64", "bool8"] * 3,
    cycle_kinds(212),
])
def test_layout_matches_reference(schema_kinds):
    ours = [dtypes.DType(k) for k in schema_kinds]
    ref = [JDType(k) for k in schema_kinds]
    assert RC.compute_layout(ours) == JRC.compute_layout(ref)
    starts, voff, fixed = RC.compute_layout(ours)
    n_words = RC.row_size_of(ours) // 4
    for o, r, st in zip(ours, ref, starts):
        assert RC.field_word_slots(o, st) == JRC.field_word_slots(r, st)
    assert RA.build_extract_plan(ours, starts, voff, n_words) == \
        JP.build_extract_plan(ref, starts, voff, n_words)


@pytest.mark.parametrize("rows,ncols,dec_every,br", SHAPES)
def test_to_rows_matches_reference_and_pallas(rows, ncols, dec_every, br):
    check_to_rows(rows, ncols, dec_every, br)


@pytest.mark.parametrize("rows,ncols,dec_every,br", SHAPES)
def test_from_rows_matches_reference_and_pallas(rows, ncols, dec_every, br):
    check_from_rows(rows, ncols, dec_every, br)


def test_from_rows_columns_are_contiguous():
    """Every decoded column owns a contiguous buffer (none is a strided
    view into the row words), so it can go straight back to a kernel."""
    specs = host_table(np.random.default_rng(2), 33,
                       CYCLE + EXTRA + ["decimal128"], null_every=2)
    t = interop.table_from_host(specs, "cpu")
    back = RC.convert_from_rows(RC.convert_to_rows(t),
                                [c.dtype for c in t.columns])
    for c in back.columns:
        assert c.data.is_contiguous() and c.validity.is_contiguous()
        c.data.view(torch.uint8)   # byte view needs unit stride


@pytest.mark.parametrize("kinds", [["int32", "int64"],
                                   CYCLE + EXTRA + ["decimal128"]])
def test_one_row_from_rows_owns_its_columns(kinds):
    """At one row a column of the row words counts as contiguous whatever
    its stride: every decoded column must still be dense storage of its
    own, not a view into the row buffer."""
    specs = host_table(np.random.default_rng(3), 1, kinds, null_every=2)
    t = interop.table_from_host(specs, "cpu")
    rows = RC.convert_to_rows(t)
    back = RC.convert_from_rows(rows, [c.dtype for c in t.columns])
    want = [c.data.clone() for c in back.columns]
    for c in back.columns:
        if c.data.dim() == 1:
            assert c.data.stride() == (1,)
        c.data.view(torch.uint8)
    rows.children[0].data.zero_()
    for c, w, orig in zip(back.columns, want, t.columns):
        assert torch.equal(c.data, w) and torch.equal(c.data, orig.data)


def test_zero_rows():
    t = interop.table_from_host(
        [("int64", np.zeros(0, np.int64), None),
         ("int8", np.zeros(0, np.int8), np.zeros(0, np.uint8))], "cpu")
    rows = RC.convert_to_rows(t)
    assert rows.length == 0 and rows.children[0].data.numel() == 0
    back = RC.convert_from_rows(rows, [dtypes.INT64, dtypes.INT8])
    assert back.num_rows == 0


def test_unported_schemas_raise():
    child = Column(dtypes.INT32, 1, data=torch.zeros(1, dtype=torch.int32))
    for nested in (Column(dtypes.LIST, 1, children=(child,),
                          offsets=torch.tensor([0, 1], dtype=torch.int32)),
                   Column(dtypes.STRUCT, 1, children=(child,))):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RC.convert_to_rows(Table([nested]))
    rows = interop.rows_from_host(np.array([0, 8], np.int32), bytes(8), "cpu")
    for kind in (dtypes.LIST, dtypes.STRUCT):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            RC.convert_from_rows(rows, [kind])


def test_from_rows_needs_uniform_rows():
    buf = bytes(32)
    ok = interop.rows_from_host(np.array([0, 16, 32], np.int32), buf, "cpu")
    assert RC.convert_from_rows(ok, [dtypes.INT64]).num_rows == 2
    uneven = interop.rows_from_host(np.array([0, 8, 32], np.int32), buf,
                                    "cpu")
    short = Column.make_list_from_parts(torch.tensor([0, 16, 32]),
                                        torch.zeros(24, dtype=torch.uint8))
    for bad in (uneven, short):
        with pytest.raises(ValueError, match="uniform"):
            RC.convert_from_rows(bad, [dtypes.INT64])


def test_wrappers_refuse_devices_without_a_kernel():
    """A tensor off the CPU goes to the kernel or raises: the plain
    version runs only for CPU tensors."""
    col = Column(dtypes.INT32, 4, data=torch.empty(4, dtype=torch.int32,
                                                   device="meta"))
    with pytest.raises(ValueError, match="no to-rows kernel"):
        RA.assemble_rows([col], [0], 4, 8)
    with pytest.raises(ValueError, match="no from-rows kernel"):
        RA.disassemble_rows(torch.empty(32, dtype=torch.uint8,
                                        device="meta"),
                            [dtypes.INT32], [0], 4, 8)


@pytest.mark.parametrize("row_size,log2", [
    (8, 8), (32, 8), (192, 8), (200, 7), (1096, 5), (24576, 1),
    (24584, 0), (200000, 0)])
def test_tile_rows_fit_shared_memory(row_size, log2):
    assert RA.tile_log2(row_size) == log2
    assert (row_size << log2) <= max(48 * 1024, row_size)


def test_tile_rows_refuse_rows_wider_than_shared_memory():
    with pytest.raises(ValueError, match="shared"):
        RA.tile_log2(227 * 1024 + 8)
