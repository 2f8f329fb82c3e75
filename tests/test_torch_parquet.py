"""PyTorch port: the parquet footer (io/parquet_footer) and the columnar
reader (io/parquet_reader) against the JAX package's on the same
pyarrow-written files, byte for byte (FLOAT64 as its bits), and against
pyarrow's own decode: every supported type, plain, dictionary and v2
pages, several row groups, snappy, all-null and empty columns, the
212-column schema, projection bytes, serialized and pruned footers, and
each typed refusal with the counterpart exception class; a corrupt page
is never retried."""

from decimal import Decimal

import numpy as np
import pytest
import torch

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

from spark_rapids_tpu import observability as obs  # noqa: E402
from spark_rapids_tpu.io import page_decode as JPD  # noqa: E402
from spark_rapids_tpu.io import parquet_footer as JPF  # noqa: E402
from spark_rapids_tpu.io import parquet_reader as JPR  # noqa: E402
from spark_rapids_tpu_torch.io import page_decode as PD  # noqa: E402
from spark_rapids_tpu_torch.io import parquet_footer as PF  # noqa: E402
from spark_rapids_tpu_torch.io import parquet_reader as PR  # noqa: E402
from spark_rapids_tpu_torch.memory.exceptions import \
    CudfException  # noqa: E402
from spark_rapids_tpu_torch.robustness import retry  # noqa: E402
from test_parquet_reader import mixed_table  # noqa: E402
from torch_port_data import col_parts  # noqa: E402


def _ref_pylist(ref, name):
    c = ref.column(name)
    if pa.types.is_date32(c.type):
        c = c.cast(pa.int32())
    elif pa.types.is_timestamp(c.type):
        c = c.cast(pa.int64())
    elif pa.types.is_decimal(c.type):
        return [None if v is None else int(v.scaleb(c.type.scale))
                for v in c.to_pylist()]
    return c.to_pylist()


def both(path, columns=None):
    """The port's read (on the CPU) and the JAX package's, which must
    agree buffer for buffer, and match pyarrow's values."""
    got = PR.read_table(path, columns=columns, device="cpu")
    want = JPR.read_table(path, columns=columns)
    assert got.names == want.names
    assert got.num_rows == want.num_rows
    for name, g, w in zip(got.names, got.columns, want.columns):
        assert g.dtype.kind == w.dtype.kind, name
        assert g.dtype.scale == w.dtype.scale, name
        assert col_parts(g) == col_parts(w), name
        assert g.device.type == "cpu"
    ref = pq.read_table(path, columns=columns and list(dict.fromkeys(
        columns)))
    assert got.names == ref.schema.names
    for name in ref.schema.names:
        g = got.column(name).to_pylist()
        r = _ref_pylist(ref, name)
        for i, (a, b) in enumerate(zip(g, r)):
            if isinstance(b, float) and a is not None and b is not None:
                assert a == b or (np.isnan(a) and np.isnan(b)), \
                    (name, i, a, b)
            else:
                assert a == b, (name, i, a, b)
    return got


def same_refusal(port_call, jax_call, port_types, jax_types):
    """Both calls refuse, with counterpart classes and the same text."""
    with pytest.raises(port_types) as got:
        port_call()
    with pytest.raises(jax_types) as want:
        jax_call()
    assert type(got.value).__name__ == type(want.value).__name__
    assert str(got.value) == str(want.value)
    return got.value


PORT_TYPED = (PD.ParquetDecodeException, PF.ParquetFooterException)
JAX_TYPED = (JPD.ParquetDecodeException, JPF.ParquetFooterException)


# ----------------------------------------------------------------- footer


@pytest.fixture
def pq_file(tmp_path):
    path = tmp_path / "t.parquet"
    pq.write_table(pa.table({
        "id": pa.array(np.arange(10, dtype=np.int64)),
        "Name": pa.array([f"n{i}" for i in range(10)]),
        "score": pa.array(np.linspace(0, 1, 10)),
    }), str(path))
    return str(path)


def test_parse_real_footer(pq_file):
    tree = PF.read_footer_from_file(pq_file)
    assert tree == JPF.read_footer_from_file(pq_file)
    assert PF._sval(tree, 3) == 10
    assert PF.schema_names(tree) == ["id", "Name", "score"]
    assert len(PF._sval(tree, 4)[2]) >= 1


def test_roundtrip_serialize(pq_file):
    tree = PF.read_footer_from_file(pq_file)
    blob = PF.serialize_footer(tree)
    assert blob == JPF.serialize_footer(JPF.read_footer_from_file(pq_file))
    again = PF.parse_footer(blob)
    assert PF.serialize_footer(again) == blob
    raw = open(pq_file, "rb").read()
    flen = int.from_bytes(raw[-8:-4], "little")
    assert blob == raw[-8 - flen:-8]


@pytest.mark.parametrize("keep,case_sensitive", [
    (["id", "score"], True), (["name"], False), (["name"], True),
    (["score", "id", "nope"], True)])
def test_prune_matches_reference(pq_file, keep, case_sensitive):
    tree = PF.read_footer_from_file(pq_file)
    pruned = PF.prune_columns(tree, keep, case_sensitive)
    want = JPF.prune_columns(JPF.read_footer_from_file(pq_file), keep,
                             case_sensitive)
    assert PF.serialize_footer(pruned) == JPF.serialize_footer(want)
    names = PF.schema_names(pruned)
    assert names == JPF.schema_names(want)
    assert PF._sval(PF._schema_elements(pruned)[0], 5) == len(names)
    for rg in PF._sval(pruned, 4)[2]:
        heads = [PF._sval(PF._sval(cc, 3), 3)[2][0].decode()
                 for cc in PF._sval(rg, 1)[2]]
        assert heads == names


def test_read_and_filter_end_to_end(pq_file):
    blob = PF.read_and_filter(pq_file, ["id"])
    assert blob == JPF.read_and_filter(pq_file, ["id"])
    tree = PF.parse_footer(blob)
    assert PF.schema_names(tree) == ["id"]
    assert PF._sval(tree, 3) == 10


def test_not_parquet(tmp_path):
    bad = tmp_path / "x.bin"
    bad.write_bytes(b"0123456789abcdef")
    err = same_refusal(lambda: PF.read_footer_from_file(str(bad)),
                       lambda: JPF.read_footer_from_file(str(bad)),
                       PF.ParquetFooterException,
                       JPF.ParquetFooterException)
    assert isinstance(err, ValueError) and "not a parquet file" in str(err)


def _nested_file(tmp_path):
    t = pa.table({
        "id": pa.array([1, 2], pa.int64()),
        "s": pa.array([{"a": 1, "b": "x", "c": 2.5},
                       {"a": 3, "b": "y", "c": 0.5}],
                      pa.struct([("a", pa.int32()), ("b", pa.string()),
                                 ("c", pa.float64())])),
        "arr": pa.array([[{"p": 1, "q": 2}], []],
                        pa.list_(pa.struct([("p", pa.int32()),
                                            ("q", pa.int32())]))),
        "drop_me": pa.array(["z", "w"]),
    })
    src = tmp_path / "nested.parquet"
    pq.write_table(t, str(src))
    raw = src.read_bytes()
    flen = int.from_bytes(raw[-8:-4], "little")
    return raw, flen


@pytest.mark.parametrize("spec,case_sensitive,paths", [
    ({"id": None, "s": {"a": None, "c": None},
      "arr": {"list": {"element": {"q": None}}}}, True,
     ["id", "s.a", "s.c", "arr.list.element.q"]),
    ({"s": {"nope": None}, "id": None}, True, ["id"]),
    ({"S": {"A": None}}, False, ["s.a"]),
], ids=["per_leaf", "empty_group_vanishes", "case_insensitive"])
def test_prune_columns_nested(tmp_path, spec, case_sensitive, paths):
    raw, flen = _nested_file(tmp_path)
    tree = PF.parse_footer(raw[-8 - flen:-8])
    out = PF.serialize_footer(PF.prune_columns_nested(tree, spec,
                                                      case_sensitive))
    assert out == JPF.serialize_footer(JPF.prune_columns_nested(
        JPF.parse_footer(raw[-8 - flen:-8]), spec, case_sensitive))
    dst = tmp_path / "pruned.parquet"
    dst.write_bytes(raw[:-8 - flen] + out
                    + len(out).to_bytes(4, "little") + b"PAR1")
    md = pq.read_metadata(str(dst))
    rg = md.row_group(0)
    assert [rg.column(i).path_in_schema
            for i in range(rg.num_columns)] == paths
    pq.read_table(str(dst))


def test_schema_leaves_mapping(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": pa.array([1], pa.int64()),
                             "b": pa.array(["x"]),
                             "c": pa.array([1.0], pa.float32())}),
                   path, compression="NONE")
    leaves = PF.schema_leaves(PF.read_footer_from_file(path))
    assert [(lf.name, lf.physical_type, lf.max_def_level)
            for lf in leaves] == [("a", 2, 1), ("b", 6, 1), ("c", 4, 1)]
    assert [tuple(lf) for lf in leaves] == [
        tuple(lf) for lf in JPF.schema_leaves(
            JPF.read_footer_from_file(path))]


@pytest.mark.parametrize("blob", [b"\x19\x4c\x15", b"\x1d\x00",
                                  b"\x17\x00\x00"],
                         ids=["truncated", "type_nibble", "double"])
def test_footer_garbage_refused_typed(blob):
    same_refusal(lambda: PF.parse_footer(blob),
                 lambda: JPF.parse_footer(blob),
                 PF.ParquetFooterException, JPF.ParquetFooterException)


@pytest.mark.parametrize("content", [
    b"PAR1 not really parquet PAR!", b"PAR1",
    b"PAR1" + b"\x00" * 8 + (2 ** 20).to_bytes(4, "little") + b"PAR1"],
    ids=["no_magic", "short", "length_past_start"])
def test_footer_tail_refused_typed(tmp_path, content):
    bad = tmp_path / "x.parquet"
    bad.write_bytes(content)
    same_refusal(lambda: PF.read_footer_from_file(str(bad)),
                 lambda: JPF.read_footer_from_file(str(bad)),
                 PF.ParquetFooterException, JPF.ParquetFooterException)
    same_refusal(lambda: PR.read_table(str(bad), device="cpu"),
                 lambda: JPR.read_table(str(bad)), PORT_TYPED, JAX_TYPED)


@pytest.mark.parametrize("tree", [
    ("struct", {}),
    ("struct", {2: (9, ("list", 12, [
        ("struct", {5: (5, 1)}),
        ("struct", {1: (5, 1), 3: (5, 1), 7: (12, ("struct", {}))}),
    ]))})], ids=["no_schema", "scale_is_struct"])
def test_malformed_footer_tree_refused_typed(tree):
    same_refusal(lambda: PF.schema_leaves(tree),
                 lambda: JPF.schema_leaves(tree),
                 PF.ParquetFooterException, JPF.ParquetFooterException)


# ----------------------------------------------------------------- reader


@pytest.mark.parametrize("kw", [
    dict(use_dictionary=False, compression="NONE"),
    dict(use_dictionary=True, compression="NONE"),
    dict(use_dictionary=True, compression="NONE",
         data_page_version="2.0"),
    dict(use_dictionary=False, compression="NONE",
         data_page_version="2.0"),
    dict(use_dictionary=True, compression="NONE", row_group_size=64),
], ids=["plain", "dict", "v2", "plain_v2", "multi_rg"])
def test_golden_mixed(tmp_path, kw):
    path = str(tmp_path / "t.parquet")
    pq.write_table(mixed_table(500), path, **kw)
    got = both(path)
    assert got.column("f64").data.dtype == torch.float64
    assert got.column("s").offsets.dtype == torch.int32
    assert got.column("s").data.dtype == torch.uint8
    assert got.column("b").validity.dtype == torch.uint8


@pytest.mark.parametrize("codec", ["snappy", "zstd", "gzip"])
def test_golden_compressed(tmp_path, codec):
    if not pa.Codec.is_available(codec):
        pytest.skip(f"{codec} codec unavailable")
    path = str(tmp_path / "t.parquet")
    pq.write_table(mixed_table(500), path, compression=codec,
                   row_group_size=200)
    both(path)
    stats = {}
    PR.read_table(path, device="cpu", stats=stats)
    assert 0 < stats["decompress_ns"] <= stats["decode_ns"]


def test_more_types(tmp_path):
    """The kinds mixed_table leaves out: unsigned ints, decimal32/64,
    the int16 and uint16 logical types over INT32."""
    rng = np.random.default_rng(8)
    n = 300
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({
        "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
        "u16": pa.array(rng.integers(0, 2**16, n).astype(np.uint16)),
        "u32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32)),
        "u64": pa.array(rng.integers(0, 2**63, n).astype(np.uint64)
                        * np.uint64(2)),
        "dec9": pa.array([None if i % 6 == 0 else
                          Decimal(i * 7 - 900).scaleb(-2)
                          for i in range(n)], pa.decimal128(9, 2)),
        "dec18": pa.array([Decimal(i * 10**10 - 7).scaleb(-3)
                           for i in range(n)], pa.decimal128(18, 3)),
        "f64s": pa.array(np.array([0.0, -0.0, np.inf, -np.inf, np.nan,
                                   5e-324] * 50)),
    }), path, compression="NONE", use_dictionary=["u16"],
        store_decimal_as_integer=True)
    got = both(path)
    assert got.column("dec9").dtype.kind == "decimal32"
    assert got.column("dec18").dtype.kind == "decimal64"
    assert got.column("u64").data.dtype == torch.uint64


def test_all_null_and_no_null_pages(tmp_path):
    path = str(tmp_path / "t.parquet")
    n = 200
    pq.write_table(pa.table({
        "all_null": pa.array([None] * n, pa.int64()),
        "none_null": pa.array(list(range(n)), pa.int64()),
        "null_str": pa.array([None] * n, pa.string()),
    }), path, compression="NONE")
    got = both(path)
    assert int(got.column("all_null").validity.sum()) == 0
    assert got.column("none_null").validity is None


def test_empty_table_and_empty_strings(tmp_path):
    path = str(tmp_path / "e.parquet")
    pq.write_table(mixed_table(7).slice(0, 0), path, compression="NONE")
    got = both(path)
    assert got.num_rows == 0 and got.num_columns == 10
    path2 = str(tmp_path / "s.parquet")
    pq.write_table(pa.table({"s": pa.array(["", "", "x", ""]),
                             "t": pa.array([None, "", None, "yy"])}),
                   path2, compression="NONE")
    both(path2)


def test_plain_vs_dictionary_strings_identical(tmp_path):
    vals = [None if i % 5 == 0 else f"v{i % 13}" for i in range(300)]
    t = pa.table({"s": pa.array(vals, pa.string())})
    p1, p2 = str(tmp_path / "p.parquet"), str(tmp_path / "d.parquet")
    pq.write_table(t, p1, use_dictionary=False, compression="NONE")
    pq.write_table(t, p2, use_dictionary=True, compression="NONE")
    a = both(p1).column("s")
    b = both(p2).column("s")
    assert col_parts(a) == col_parts(b)
    assert a.to_pylist() == vals


def test_wide_212_column_schema(tmp_path):
    """The SF100-shaped wide schema."""
    rng = np.random.default_rng(212)
    n = 64
    cols = {}
    for i in range(212):
        kind = i % 5
        if kind == 0:
            arr = pa.array([None if j % 7 == i % 7 else int(v)
                            for j, v in enumerate(
                                rng.integers(-2**50, 2**50, n))],
                           pa.int64())
        elif kind == 1:
            arr = pa.array(rng.integers(-2**31, 2**31, n)
                           .astype(np.int32))
        elif kind == 2:
            arr = pa.array([None if j % 5 == i % 5 else float(v)
                            for j, v in enumerate(rng.normal(size=n))],
                           pa.float64())
        elif kind == 3:
            arr = pa.array([bool(v) for v in rng.integers(0, 2, n)],
                           pa.bool_())
        else:
            arr = pa.array([None if j % 6 == i % 6 else
                            f"c{i}_{j % 9}" for j in range(n)],
                           pa.string())
        cols[f"c{i:03d}"] = arr
    path = str(tmp_path / "wide.parquet")
    pq.write_table(pa.table(cols), path, compression="NONE")
    got = both(path)
    assert got.num_columns == 212
    stats = {}
    PR.read_table(path, device="cpu", stats=stats)
    assert stats["columns"] == 212


def _jax_read_bytes(path, columns=None):
    obs.enable()
    obs.reset()
    try:
        JPR.read_table(path, columns=columns)
        return obs.METRICS.snapshot()[
            "srt_io_read_bytes_total"]["series"][0]["value"]
    finally:
        obs.disable()
        obs.reset()


def test_projection_pushdown_prunes_fetches(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(mixed_table(300), path, compression="NONE")
    whole, proj = {}, {}
    PR.read_table(path, device="cpu", stats=whole)
    all_bytes = whole["read_bytes"]
    assert all_bytes == _jax_read_bytes(path)
    got = both(path, columns=["i64", "s"])
    PR.read_table(path, columns=["i64", "s"], device="cpu", stats=proj)
    proj_bytes = proj["read_bytes"]
    assert proj_bytes == _jax_read_bytes(path, ["i64", "s"])
    assert got.names == ["i64", "s"]
    assert proj_bytes < all_bytes
    assert proj["rows"] == 300 and proj["columns"] == 2
    assert proj["pages"] >= 2
    for key in ("decode_ns", "upload_ns", "wall_ns"):
        assert proj[key] > 0
    assert proj["decompress_ns"] == 0   # uncompressed pages
    err = same_refusal(
        lambda: PR.read_table(path, columns=["i64", "nope"], device="cpu"),
        lambda: JPR.read_table(path, columns=["i64", "nope"]),
        PF.ParquetFooterException, JPF.ParquetFooterException)
    assert "nope" in str(err)


def test_duplicate_requested_columns_dedup(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2]),
                             "b": pa.array([3, 4])}), path,
                   compression="NONE")
    got = both(path, columns=["a", "a"])
    assert got.names == ["a"] and got.column("a").to_pylist() == [1, 2]
    err = same_refusal(
        lambda: PR.read_table(path, columns=["a", "nope", "nope"],
                              device="cpu"),
        lambda: JPR.read_table(path, columns=["a", "nope", "nope"]),
        PF.ParquetFooterException, JPF.ParquetFooterException)
    assert "nope" in str(err)


@pytest.mark.parametrize("garbage", [b"\xff" * 8, b"\x17\x00\x00",
                                     b"\x1d\x00", b"\x15"],
                         ids=["deltas", "double", "type_nibble", "varint"])
def test_page_header_garbage_raises_typed(garbage):
    same_refusal(lambda: PR._parse_struct_at(garbage, 0),
                 lambda: JPR._parse_struct_at(garbage, 0),
                 PD.ParquetDecodeException, JPD.ParquetDecodeException)


def test_truncated_chunk_raises_typed(tmp_path):
    src = tmp_path / "t.parquet"
    pq.write_table(mixed_table(300, with_nulls=False), str(src),
                   compression="NONE")
    raw = src.read_bytes()
    broken = tmp_path / "b.parquet"
    broken.write_bytes(raw[:4] + b"\xff" * 24 + raw[28:])
    same_refusal(lambda: PR.read_table(str(broken), device="cpu"),
                 lambda: JPR.read_table(str(broken)), PORT_TYPED,
                 JAX_TYPED)


def test_chunk_outside_file_raises_typed(tmp_path):
    src = tmp_path / "t.parquet"
    pq.write_table(mixed_table(400, with_nulls=False), str(src),
                   compression="NONE")
    raw = src.read_bytes()
    shrunk = tmp_path / "s.parquet"
    shrunk.write_bytes(raw[:64] + raw[1064:])  # footer intact
    same_refusal(lambda: PR.read_table(str(shrunk), device="cpu"),
                 lambda: JPR.read_table(str(shrunk)), PORT_TYPED,
                 JAX_TYPED)


def test_non_micros_timestamp_refused_typed(tmp_path):
    for unit in ("ns", "ms"):
        path = str(tmp_path / f"{unit}.parquet")
        pq.write_table(pa.table({"t": pa.array([1577836800_000],
                                               pa.timestamp(unit))}),
                       path, compression="NONE", coerce_timestamps=None)
        err = same_refusal(lambda: PR.read_table(path, device="cpu"),
                           lambda: JPR.read_table(path),
                           PD.ParquetDecodeException,
                           JPD.ParquetDecodeException)
        assert "micros" in str(err)


def test_nested_schema_refused_typed(tmp_path):
    path = str(tmp_path / "n.parquet")
    pq.write_table(pa.table({"s": pa.array([{"a": 1}],
                                           pa.struct([("a", pa.int32())]))}),
                   path, compression="NONE")
    err = same_refusal(lambda: PR.read_table(path, device="cpu"),
                       lambda: JPR.read_table(path),
                       PF.ParquetFooterException,
                       JPF.ParquetFooterException)
    assert "flat" in str(err)


def test_nested_chunk_in_flat_leaf_refused_typed(tmp_path):
    """A footer pruned to one leaf of a list column reads as a flat
    leaf whose chunk holds more values than its row group has rows."""
    path = tmp_path / "l.parquet"
    pq.write_table(pa.table({"l": pa.array([[1, 2, 3], [4, 5]],
                                           pa.list_(pa.int64()))}),
                   str(path), compression="NONE")
    raw = path.read_bytes()
    flen = int.from_bytes(raw[-8:-4], "little")
    tree = PF.parse_footer(raw[-8 - flen:-8])
    elems = PF._schema_elements(tree)
    leaf = ("struct", {k: v for k, v in elems[-1][1].items() if k != 3})
    leaf[1][3] = (5, 1)                   # OPTIONAL, not REPEATED
    leaf[1][4] = (8, b"l")
    root = ("struct", dict(elems[0][1]))
    root[1][5] = (5, 1)
    fields = dict(tree[1])
    fields[2] = (9, ("list", 12, [root, leaf]))
    out = PF.serialize_footer(("struct", fields))
    flat = tmp_path / "f.parquet"
    flat.write_bytes(raw[:-8 - flen] + out + len(out).to_bytes(4, "little")
                     + b"PAR1")
    err = same_refusal(lambda: PR.read_table(str(flat), device="cpu"),
                       lambda: JPR.read_table(str(flat)),
                       PD.ParquetDecodeException,
                       JPD.ParquetDecodeException)
    assert "nested data" in str(err)


def test_malformed_row_group_list_refused_typed(pq_file, tmp_path):
    raw = open(pq_file, "rb").read()
    flen = int.from_bytes(raw[-8:-4], "little")
    tree = PF.parse_footer(raw[-8 - flen:-8])
    fields = dict(tree[1])
    fields[4] = (9, ("list", 12, [("struct", {3: (12, ("struct", {}))})]))
    out = PF.serialize_footer(("struct", fields))
    bad = tmp_path / "rg.parquet"
    bad.write_bytes(raw[:-8 - flen] + out + len(out).to_bytes(4, "little")
                    + b"PAR1")
    err = same_refusal(lambda: PR.read_table(str(bad), device="cpu"),
                       lambda: JPR.read_table(str(bad)),
                       PF.ParquetFooterException,
                       JPF.ParquetFooterException)
    assert "row-group" in str(err)


def test_string_offsets_overflow_refused_typed():
    """A string column past int32 offsets is refused, not wrapped."""
    parts = [(np.zeros(4, np.uint8),
              np.array([2**31 - 2, 5], np.int32))]
    same_refusal(lambda: PR._build_string_column(parts, [None], [2]),
                 lambda: JPR._build_string_column(parts, [None], [2]),
                 PD.ParquetDecodeException, JPD.ParquetDecodeException)


@pytest.mark.parametrize("codec", [3, 99])
def test_missing_codec_refused_typed(codec):
    """An unknown codec id, or one pyarrow lacks (LZO), is refused."""
    same_refusal(lambda: PR._decompress(b"abc", codec, 3),
                 lambda: JPR._decompress(b"abc", codec, 3),
                 PD.ParquetDecodeException, JPD.ParquetDecodeException)


def test_decode_exception_is_non_retryable():
    assert issubclass(PD.ParquetDecodeException, CudfException)
    assert issubclass(PD.ParquetDecodeException, retry.RETRYABLE)
    assert PD.ParquetDecodeException in retry.NON_RETRYABLE
    calls = []

    def boom():
        calls.append(1)
        raise PD.ParquetDecodeException("corrupt page")

    with pytest.raises(PD.ParquetDecodeException):
        retry.with_retry(boom, name="ingest")
    assert len(calls) == 1
    with pytest.raises(PD.ParquetDecodeException):
        retry.split_and_retry(lambda part: boom(), [1, 2, 3, 4],
                              name="ingest_batch")
    assert len(calls) == 2


def test_corrupt_file_read_under_retry_is_not_retried(tmp_path,
                                                      monkeypatch):
    src = tmp_path / "t.parquet"
    pq.write_table(mixed_table(300, with_nulls=False), str(src),
                   compression="NONE")
    raw = src.read_bytes()
    broken = tmp_path / "b.parquet"
    broken.write_bytes(raw[:4] + b"\xff" * 24 + raw[28:])
    calls = []
    real = PR._decode_chunk

    def counted(*a):
        calls.append(1)
        return real(*a)

    monkeypatch.setattr(PR, "_decode_chunk", counted)
    with pytest.raises(PD.ParquetDecodeException):
        retry.with_retry(lambda: PR.read_table(str(broken), device="cpu"),
                         name="ingest")
    assert len(calls) == 1


@pytest.mark.parametrize("bit_width", [1, 3, 8, 13, 32])
def test_hybrid_runs_match_reference(bit_width):
    """RLE and bit-packed runs of every width class decode alike."""
    rng = np.random.default_rng(bit_width)
    vals = rng.integers(0, 2**bit_width, 24, dtype=np.uint64)
    bits = np.unpackbits(vals.astype("<u8").view(np.uint8)
                         .reshape(-1, 8), axis=1, bitorder="little")
    packed = np.packbits(bits[:, :bit_width].reshape(-1),
                         bitorder="little").tobytes()
    byte_w = (bit_width + 7) // 8
    rle = bytes([7 << 1]) + int(vals[0]).to_bytes(byte_w, "little")
    buf = bytes([(3 << 1) | 1]) + packed + rle
    got, pos = PD.decode_hybrid(buf, 0, len(buf), bit_width, 31)
    want, wpos = JPD.decode_hybrid(buf, 0, len(buf), bit_width, 31)
    assert pos == wpos and np.array_equal(got, want)
    assert np.array_equal(got[:24], vals.astype(np.uint32))


def test_read_table_defaults_to_the_card(monkeypatch, tmp_path):
    """Without a device the reader targets "cuda": here, with no card,
    the first upload refuses rather than fall back to the CPU."""
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table({"a": pa.array([1, 2])}), path)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        PR.read_table(path)


def _varint(v):
    out = bytearray()
    while True:
        b, v = v & 0x7F, v >> 7
        out.append(b | 0x80 if v else b)
        if not v:
            return bytes(out)


@pytest.mark.parametrize("bit_width", [1, 2, 3, 8, 12, 17, 24, 32])
def test_hybrid_streams_match_reference(bit_width):
    """Seeded RLE/bit-packed streams, whole and corrupted (bytes flipped,
    cut short, padded), decode to the reference's values and position or
    raise its error: the bit-width-1 header chain and the wider walk."""
    rng = np.random.default_rng(100 + bit_width)
    byte_w = (bit_width + 7) // 8
    for trial in range(150):
        parts, count = [], 0
        for _ in range(int(rng.integers(1, 30))):
            if rng.random() < 0.5:
                ng = int(rng.integers(1, 70))
                parts.append(_varint(ng << 1 | 1) + rng.integers(
                    0, 256, ng * bit_width, dtype=np.uint8).tobytes())
                count += ng * 8
            else:
                run = int(rng.integers(1, 3000))
                parts.append(_varint(run << 1) + int(rng.integers(
                    0, 2**bit_width)).to_bytes(byte_w, "little"))
                count += run
        buf = bytearray(b"".join(parts))
        want = int(rng.integers(1, count + 1))
        if trial % 3 == 0:
            for _ in range(int(rng.integers(1, 4))):
                buf[int(rng.integers(0, len(buf)))] = int(rng.integers(0, 256))
            if trial % 2:
                buf = buf[:int(rng.integers(0, len(buf) + 1))]
            want = int(rng.integers(1, count + 50))
        pad = int(rng.integers(0, 4))
        data = bytes(pad) + bytes(buf) + bytes(int(rng.integers(0, 4)))
        end = pad + len(buf)
        try:
            got, err = PD.decode_hybrid(memoryview(data), pad, end,
                                        bit_width, want), None
        except PD.ParquetDecodeException as e:
            got, err = None, str(e)
        try:
            ref, ref_err = JPD.decode_hybrid(data, pad, end, bit_width,
                                             want), None
        except JPD.ParquetDecodeException as e:
            ref, ref_err = None, str(e)
        assert err == ref_err, trial
        if ref is not None:
            assert got[1] == ref[1] and got[0].dtype == ref[0].dtype
            assert np.array_equal(got[0], ref[0]), trial


def test_fileio_matches_reference(tmp_path):
    """io/fileio: vectored reads validated before any IO, one stream a
    RangeReader, typed short and negative reads, output files."""
    from spark_rapids_tpu.io import fileio as JF
    from spark_rapids_tpu_torch.io import fileio as F
    path = tmp_path / "x.bin"
    path.write_bytes(bytes(range(256)) * 4)
    for mod in (F, JF):
        inp = mod.LocalFileIO().new_input_file(str(path))
        assert inp.get_length() == 1024
        assert inp.read_fully() == path.read_bytes()
        out = bytearray(16)
        inp.read_vectored(out, [mod.CopyRange(10, 4, 0),
                                mod.CopyRange(300, 8, 8)])
        assert bytes(out) == bytes([10, 11, 12, 13, 0, 0, 0, 0]) + \
            bytes(range(44, 52))
        inp.read_vectored(out, [])
        for bad in ([mod.CopyRange(0, 8, 12)], [mod.CopyRange(-1, 1, 0)]):
            with pytest.raises(ValueError):
                inp.read_vectored(out, bad)
        with pytest.raises(ValueError):
            inp.read_vectored(out, None)
        with pytest.raises(EOFError):
            inp.read_vectored(out, [mod.CopyRange(1020, 8, 0)])
        with mod.RangeReader(str(path)) as rr:
            assert rr.length == 1024
            assert rr.read(250, 10) == bytes(range(250, 256)) + \
                bytes(range(4))
            with pytest.raises(EOFError):
                rr.read(1020, 8)
            with pytest.raises(ValueError):
                rr.read(-1, 4)
        assert mod.read_range(str(path), 1000, 3) == bytes(range(232, 235))
        dst = tmp_path / f"{mod.__name__}.out"
        with mod.LocalFileIO().new_output_file(str(dst)).create() as f:
            f.write(b"ok")
        assert dst.read_bytes() == b"ok"
        with pytest.raises(NotImplementedError):
            mod.RapidsFileIO().new_output_file(str(dst))
