"""PyTorch port: STRING columns and the host-value constructors held
against the JAX package (`from_strings`, `from_pylist`, `to_pylist`, the
string helpers) and the STRING host form of interop."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columns import dtypes as jdtypes
from spark_rapids_tpu.columns.column import Column as JColumn
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column

from torch_port_data import (CYCLE, EXTRA, host_strings, host_table,
                             jax_table)

STRING_CASES = {
    "mixed": ["alpha", "", None, "bee", "héllo wörld", "日本語", "x" * 70],
    "bytes": [b"\x00\xff\x80", b"", None, b"abc"],
    "all_null": [None, None, None],
    "all_empty": ["", "", ""],
    "no_rows": [],
}


def _same_buffers(ours: Column, ref: JColumn):
    for a, b in ((ours.data, ref.data), (ours.offsets, ref.offsets),
                 (ours.validity, ref.validity)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.numpy().tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("case", sorted(STRING_CASES))
def test_from_strings_matches_reference(case):
    values = STRING_CASES[case]
    ours = Column.from_strings(values, device="cpu")
    ref = JColumn.from_strings(values)
    _same_buffers(ours, ref)
    assert ours.to_pylist() == ref.to_pylist()
    assert ours.dtype.is_string and ours.length == len(values)


PYLISTS = {
    "int8": [1, None, -128, 127],
    "int32": [0, -(2**31), 2**31 - 1, None],
    "int64": [None, 2**63 - 1, -(2**63), 5],
    "uint64": [2**64 - 1, 0, None],
    "bool8": [True, False, None],
    "float32": [1.5, float("inf"), None, -0.0],
    "float64": [0.1, -0.0, None, float("-inf")],
    "timestamp_micros": [0, None, -1],
    "decimal128": [0, 1, -1, -(2**127), 2**127 - 1, None, 2**64 + 3],
    "string": ["a", None, "", "ü"],
}


@pytest.mark.parametrize("kind", sorted(PYLISTS))
def test_from_pylist_matches_reference(kind):
    values = PYLISTS[kind]
    ours = Column.from_pylist(values, dtypes.DType(kind), device="cpu")
    ref = JColumn.from_pylist(values, jdtypes.DType(kind))
    assert ours.to_pylist() == ref.to_pylist()
    if kind != "float64":   # the JAX package holds FLOAT64 as raw bits
        assert ours.data.numpy().tobytes() == np.asarray(ref.data).tobytes()
    else:
        assert ours.data.numpy().view(np.uint64).tobytes() == \
            np.asarray(ref.data).tobytes()
    assert (ours.validity is None) == (ref.validity is None)


@pytest.mark.parametrize("null_every", [0, 2])
def test_to_pylist_matches_reference(null_every):
    rng = np.random.default_rng(5 + null_every)
    specs = host_table(rng, 40, CYCLE + EXTRA + ["decimal128", "string"],
                       null_every=null_every)
    ours = interop.table_from_host(specs, device="cpu")
    for a, b in zip(ours.columns, jax_table(specs).columns):
        got, want = a.to_pylist(), b.to_pylist()
        assert len(got) == len(want)
        for x, y in zip(got, want):   # NaN != NaN: compare NaN-ness
            assert x == y or (x != x and y != y)


@pytest.mark.parametrize("skew,pad", [(0, None), (5, None), (3, 40)])
def test_string_helpers_match_reference(skew, pad):
    """Lengths come from the offsets whatever the validity, and the
    offsets may start past 0 (a sliced column)."""
    rng = np.random.default_rng(skew)
    spec = host_strings(rng, 50, max_len=33, nullable=True, skew=skew)
    ours = interop.table_from_host([spec], device="cpu").columns[0]
    ref = jax_table([spec]).columns[0]
    np.testing.assert_array_equal(ours.string_lengths().numpy(),
                                  np.asarray(ref.string_lengths()))
    assert ours.max_string_length() == ref.max_string_length()
    for fill in (0, 7):
        chars, lens = ours.to_padded_chars(pad_to=pad, fill=fill)
        rchars, rlens = ref.to_padded_chars(pad_to=pad, fill=fill)
        np.testing.assert_array_equal(chars.numpy(), np.asarray(rchars))
        np.testing.assert_array_equal(lens.numpy(), np.asarray(rlens))


def test_empty_string_column_helpers():
    c = Column.from_strings([], device="cpu")
    assert c.max_string_length() == 0
    chars, lens = c.to_padded_chars()
    assert chars.shape == (0, 1) and lens.shape == (0,)
    e = Column.from_strings(["", ""], device="cpu")
    chars, _ = e.to_padded_chars()
    assert chars.tolist() == [[0], [0]]


@pytest.mark.parametrize("rows,skew", [(0, 0), (1, 0), (257, 4)])
def test_string_interop_round_trip(rows, skew):
    rng = np.random.default_rng(rows)
    specs = [host_strings(rng, rows, nullable=True, skew=skew),
             ("int32", rng.integers(0, 9, rows).astype(np.int32), None),
             host_strings(rng, rows, max_len=3)]
    t = interop.table_from_host(specs, device="cpu")
    assert t.num_rows == rows
    assert t.columns[0].offsets.dtype == torch.int32
    for spec, back in zip(specs, interop.table_to_host(t)):
        assert len(spec) == len(back) and spec[0] == back[0]
        for a, b in zip(spec[1:], back[1:]):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("spec", [
    ("string", np.zeros(3, np.uint8), None, np.array([0, 1], np.int64)),
    ("string", np.zeros(3, np.int32), None, np.array([0, 1], np.int32)),
    ("string", np.zeros(3, np.uint8), np.ones(2, np.uint8),
     np.array([0, 1], np.int32)),
    ("int32", np.zeros(3, np.int32), None, np.array([0, 1], np.int32)),
])
def test_interop_rejects_malformed_string_columns(spec):
    with pytest.raises(ValueError):
        interop.table_from_host([spec], device="cpu")
