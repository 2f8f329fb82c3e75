"""PyTorch port: the fixed-width to-rows kernel's plan and tile choice,
on the CPU.  The plan's plain mirror (`assemble_rows_by_plan`: the
kernel's staging offsets and word entries, applied with PyTorch ops)
must give the JAX package's row bytes (its default path and its Pallas
kernel in interpret mode) and the port's plain version's; the tile
helper must keep every block within one block's shared memory."""

import numpy as np
import pytest

from spark_rapids_tpu.ops import row_assembly_pallas as JP
from spark_rapids_tpu.ops import row_conversion as JRC
from spark_rapids_tpu_torch.columns import bytesview, dtypes
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
from spark_rapids_tpu_torch.ops import row_conversion as RC

from torch_port_data import (CYCLE, EXTRA, _jax_row_bytes, cycle_kinds,
                             host_table, jax_table, port_table)

MAX_BLOCK = 227 * 1024


def layout(kinds):
    schema = [dtypes.DType(k) for k in kinds]
    starts, voff, _ = RC.compute_layout(schema)
    return schema, starts, voff, RC.row_size_of(schema)


def key_of(kinds, null_every=0):
    _schema, starts, voff, row_size = layout(kinds)
    widths = tuple(RC._col_byte_size(dtypes.DType(k)) for k in kinds)
    nullable = tuple(bool(null_every) and i % null_every == 0
                     for i in range(len(kinds)))
    return (widths, tuple(starts), nullable, voff), row_size


# (rows, kinds, every n-th column nullable, (log2 tile, staged) settings)
MIRROR_CASES = [
    (300, cycle_kinds(20, 11), 3, [(4, True), (6, True), (2, False)]),
    (7, cycle_kinds(3), 0, [(4, True), (0, False)]),
    (1, cycle_kinds(212), 3, [(4, True), (0, False)]),
    (333, cycle_kinds(212), 3, [(4, True), (5, True)]),
    (100, (CYCLE + EXTRA + ["decimal128"]) * 2, 2,
     [(4, True), (5, True), (1, False)]),
    (65, ["bool8"] * 9 + ["decimal128"], 1, [(4, True), (3, False)]),
]


@pytest.mark.parametrize("rows,kinds,null_every,settings", MIRROR_CASES)
def test_plan_mirror_matches_reference_and_plain(rows, kinds, null_every,
                                                 settings):
    specs = host_table(np.random.default_rng(rows + len(kinds)), rows,
                       kinds, null_every=null_every)
    jt, pt = jax_table(specs), port_table(specs)
    cols = pt.columns
    _schema, starts, voff, row_size = layout(kinds)
    want = RA.assemble_rows_plain(cols, starts, voff, row_size)
    ref = JRC.convert_to_rows(jt)
    assert _jax_row_bytes(ref.children[0].data, rows, row_size) == \
        bytesview.to_host_bytes(want, rows * row_size)
    pallas = JP.assemble_fixed_words_pallas(
        jt.columns, starts, voff, row_size, block_rows=128, interpret=True)
    assert _jax_row_bytes(pallas, rows, row_size) == \
        bytesview.to_host_bytes(want, rows * row_size)
    for log2_tile, staged in settings:
        got = RA.assemble_rows_by_plan(cols, starts, voff, row_size,
                                       log2_tile, staged)
        assert bool((got == want).all()), (log2_tile, staged)


def test_plan_layout():
    """Runs, pieces, validity bytes, chunks and validity runs of a small
    schema at 16 rows a tile."""
    key, row_size = key_of(["int64", "int32", "int8", "decimal128"], 2)
    assert row_size == 40
    plan = RA.to_rows_plan(*key, 4)
    assert (plan.ncols, plan.nruns, plan.nnarrow, plan.npieces, plan.ndyn,
            plan.ncst, plan.nchunks, plan.stage_bytes) == \
        (4, 3, 1, 4, 1, 0, 3, 48)
    assert plan.ints == (
        2, 0, 1, 12,  0, 16, 0, 0,  2, 32, 0, 0,       # int8; validity 0, 2
        0, 0 << 8 | 3 << 2 | 1,                        # int64 at 0
        1, 8 << 8 | 2 << 2,                            # int32 at 8
        3, 16 << 8 | 4 << 2 | 1,                       # decimal128's halves
        3, 24 << 8 | 32 | 4 << 2 | 1,
        32, 0b1010 | 0b0101 << 8,                      # validity byte 0
        0 << 8, 1 << 8, 2 << 8,                        # one chunk a run
        16, -1, 32, -1)                                # validity runs


@pytest.mark.parametrize("kinds,null_every", [
    (["int8"], 0),                                  # 8-byte rows
    (cycle_kinds(3), 0),                            # the flagship's width
    (cycle_kinds(212), 0),                          # the bench shape
    (cycle_kinds(212), 3),
    (cycle_kinds(1000, 7), 2),
    (cycle_kinds(3000), 0),
    (cycle_kinds(3000), 3),
    (["int8"] * 3000, 1),
    (["decimal128"] * 3000, 0),
    (["decimal128"] * 14000, 4),                    # about 220 KB rows
    (["int64"] * 28000, 0),                         # about 227 KB rows
])
def test_to_rows_tile_fits_one_block(kinds, null_every):
    key, row_size = key_of(kinds, null_every)
    assert row_size <= MAX_BLOCK
    for lg, most in [(None, None), (4, 1), (4, 2), (5, 3), (8, 4)]:
        plan, stages, flags = RA.to_rows_tile(key, row_size, lg, most)
        assert RA.to_rows_smem_bytes(plan, row_size, stages,
                                     flags) <= MAX_BLOCK
        assert 1 <= stages <= (most or 4)
        if flags & RA.NARROW_STAGED:   # runs of whole 16-byte chunks
            assert plan.log2_tile >= 4
        assert (1 << plan.log2_tile) * row_size <= MAX_BLOCK


def test_to_rows_tile_at_the_main_path_shapes():
    key, row_size = key_of(cycle_kinds(212))
    plan, stages, flags = RA.to_rows_tile(key, row_size)
    assert (plan.log2_tile, stages, flags) == (5, 1, 7)
    key, row_size = key_of(["int64", "int32", "float64"])
    plan, stages, flags = RA.to_rows_tile(key, row_size)
    assert (plan.log2_tile, stages, flags) == (9, 2, 7)


def test_to_rows_tile_refuses_rows_wider_than_shared_memory():
    key, row_size = key_of(["int64"] * 29100)
    assert row_size > MAX_BLOCK
    with pytest.raises(ValueError, match="shared"):
        RA.to_rows_tile(key, row_size)
