"""The port's protobuf decoder (ops/protobuf.py's host oracle and router,
ops/protobuf_device.py's field-step engine, jni_entry's entry) held to
the JAX package on the same wire bytes: every case of
tests/test_protobuf.py and tests/test_protobuf_device.py, a seeded fuzz
over chip_smoke.py's clickstream schema (nested, packed, unpacked,
defaults, the malformed taxonomy), small engine chunks, the repeat-cap
fallback and the JNI door.

The port's host oracle gives the JAX oracle's bytes, and the port's
engine on CPU tensors the JAX engine's (which keeps what it captured
under null rows, where the oracles zero).  Between engine and oracle of
one package the comparison is by value, as the JAX tests make it.
"""

import struct

import jax.numpy as jnp
import numpy as np
import pytest

from spark_rapids_tpu.columns import dtypes as jdt
from spark_rapids_tpu.columns.column import Column as JColumn
from spark_rapids_tpu.ops import protobuf as jpb
from spark_rapids_tpu.ops import protobuf_device as jpd
from spark_rapids_tpu_torch.columns import dtypes as tdt
from spark_rapids_tpu_torch.columns.column import Column as TColumn
from spark_rapids_tpu_torch.ops import protobuf as tpb
from spark_rapids_tpu_torch.ops import protobuf_device as tpd
from torch_port_data import col_parts


def varint(v):
    v &= (1 << 64) - 1
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def tag(num, wire):
    return varint((num << 3) | wire)


def ld(num, payload: bytes):
    return tag(num, 2) + varint(len(payload)) + payload


def port_fields(fields):
    """The port's descriptor of a JAX package descriptor."""
    return [tpb.Field(f.field_number, tdt.DType(f.dtype.kind, f.dtype.scale),
                      f.encoding, f.repeated, f.required, f.default,
                      f.name, tuple(port_fields(f.children)))
            for f in fields]


def columns(msgs):
    """(JAX column, port CPU column) over the same bytes."""
    return JColumn.from_strings(msgs), TColumn.from_strings(msgs, "cpu")


def same_values(got, want):
    """Equal to_pylist rows, NaN equal to NaN (the JAX tests'
    comparison between engine and oracle)."""
    h, d = want.to_pylist(), got.to_pylist()
    assert len(h) == len(d)
    for i, (hr, dr) in enumerate(zip(h, d)):
        if hr is None or dr is None:
            assert hr == dr, f"row {i}: host={hr} dev={dr}"
            continue
        for j, (hv, dv) in enumerate(zip(hr, dr)):
            if isinstance(hv, float) and isinstance(dv, float):
                assert (np.isnan(hv) and np.isnan(dv)) or hv == dv, (i, j)
            else:
                assert hv == dv, f"row {i} field {j}: host={hv} dev={dv}"


def engine(col, fields, chunk=None, monkeypatch=None):
    if chunk is not None:
        monkeypatch.setattr(tpd, "DEVICE_ROW_CHUNK", chunk)
    return tpd.decode_protobuf_to_struct_device(col, fields)


def check_all(msgs, fields, monkeypatch, jax_engine=True):
    """Port oracle == JAX oracle (bytes); port engine == port oracle
    (values); port engine == JAX engine (bytes); a 3-row chunk gives
    the port engine's bytes."""
    jc, tc = columns(msgs)
    tf = port_fields(fields)
    t_host = tpb.decode_protobuf_host(tc, tf)
    assert col_parts(t_host) == col_parts(
        jpb.decode_protobuf_to_struct(jc, fields))
    t_dev = engine(tc, tf)
    assert t_dev is not None, "schema should be device-supported"
    same_values(t_dev, t_host)
    if jax_engine:
        assert col_parts(t_dev) == col_parts(
            jpd.decode_protobuf_to_struct_device(jc, fields))
    assert col_parts(engine(tc, tf, 3, monkeypatch)) == col_parts(t_dev)
    return t_dev


# ------------------------------------------------ tests/test_protobuf.py

SCALARS = [jpb.Field(1, jdt.INT64, name="a"),
           jpb.Field(2, jdt.STRING, name="s"),
           jpb.Field(3, jdt.FLOAT64, name="d"),
           jpb.Field(4, jdt.BOOL8, name="b"),
           jpb.Field(5, jdt.INT32, name="n")]

HOST_CASES = {
    "scalars_and_string": (
        [tag(1, 0) + varint(150) + ld(2, b"hello")
         + tag(3, 1) + struct.pack("<d", 2.5) + tag(4, 0) + varint(1)
         + tag(5, 0) + varint((1 << 64) - 5), None],
        SCALARS, [(150, "hello", 2.5, True, -5), None]),
    "zigzag_fixed_and_defaults": (
        [tag(1, 0) + varint(7) + tag(2, 5) + struct.pack("<i", -9)
         + tag(3, 5) + struct.pack("<f", 1.5), b""],
        [jpb.Field(1, jdt.INT64, encoding=jpb.ZIGZAG),
         jpb.Field(2, jdt.INT32, encoding=jpb.FIXED),
         jpb.Field(3, jdt.FLOAT32),
         jpb.Field(9, jdt.INT64, default=42)],
        [(-4, -9, 1.5, 42), (None, None, None, 42)]),
    "repeated_and_packed": (
        [ld(1, varint(1) + varint(2) + varint(300)) + ld(2, b"x")
         + ld(2, b"y")],
        [jpb.Field(1, jdt.INT64, repeated=True),
         jpb.Field(2, jdt.STRING, repeated=True)],
        [([1, 2, 300], ["x", "y"])]),
    "nested_message_and_unknown_fields": (
        [ld(1, tag(1, 0) + varint(5) + ld(2, b"in"))
         + tag(99, 0) + varint(1234) + ld(98, b"unknown bytes")],
        [jpb.Field(1, jdt.STRUCT, name="m", children=(
            jpb.Field(1, jdt.INT64), jpb.Field(2, jdt.STRING)))],
        [((5, "in"),)]),
    "required_and_malformed": (
        [tag(1, 0) + varint(1), b"", b"\xff" * 11],
        [jpb.Field(1, jdt.INT64, required=True)],
        [(1,), None, None]),
    "repeated_nested_messages": (
        [ld(1, tag(1, 0) + varint(10)) + ld(1, tag(1, 0) + varint(20))],
        [jpb.Field(1, jdt.STRUCT, repeated=True,
                   children=(jpb.Field(1, jdt.INT64),))],
        [([(10,), (20,)],)]),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_oracle_cases(case):
    """tests/test_protobuf.py through the port's router on a CPU column
    (the host route): the same values, and the JAX oracle's bytes."""
    msgs, fields, want = HOST_CASES[case]
    jc, tc = columns(msgs)
    got = tpb.decode_protobuf_to_struct(tc, port_fields(fields))
    assert tpd.LAST_CALL["route"] == "host"
    assert got.to_pylist() == want
    assert col_parts(got) == col_parts(
        jpb.decode_protobuf_to_struct(jc, fields))


# ------------------------------------------ tests/test_protobuf_device.py

FLAT_FIELDS = SCALARS + [
    jpb.Field(6, jdt.INT64, encoding=jpb.ZIGZAG, name="z"),
    jpb.Field(7, jdt.INT32, encoding=jpb.FIXED, name="f32"),
    jpb.Field(8, jdt.FLOAT32, name="fl")]
SUB = [jpb.Field(1, jdt.INT64, name="x"), jpb.Field(2, jdt.STRING, name="y")]
NESTED = [jpb.Field(1, jdt.INT64, name="a"),
          jpb.Field(2, jdt.STRUCT, children=tuple(SUB), name="m")]
REP_FIELDS = [jpb.Field(1, jdt.INT64, repeated=True, name="xs"),
              jpb.Field(2, jdt.STRING, repeated=True, name="ss"),
              jpb.Field(3, jdt.INT32, name="a")]
SUB1 = tag(1, 0) + varint(7) + ld(2, b"hi")
SUB2 = tag(1, 0) + varint(9)
VALS = [0, 1, 127, 128, 300, 2**31 - 1, 2**31, 2**32 - 1, 2**32,
        2**63 - 1, 2**63, 2**64 - 1]

DEVICE_CASES = {
    "flat_scalars": (
        [(tag(1, 0) + varint(150) + ld(2, b"hello")
          + tag(3, 1) + struct.pack("<d", 2.5) + tag(4, 0) + varint(1)
          + tag(5, 0) + varint((1 << 64) - 5) + tag(6, 0) + varint(7)
          + tag(7, 5) + struct.pack("<i", -9)
          + tag(8, 5) + struct.pack("<f", 1.5)),
         b"", None, tag(1, 0) + varint(0),
         tag(1, 0) + varint(1) + tag(1, 0) + varint(2),
         ld(2, b"") + tag(99, 0) + varint(5)], FLAT_FIELDS),
    "malformed_rows": (
        [b"\xff" * 11, tag(1, 0), tag(3, 1) + b"\x01\x02",
         ld(2, b"abcd")[:-2], tag(1, 3) + b"\x00", tag(1, 4),
         b"\x00" + varint(3), tag(1, 0) + varint(7),
         varint((1 << 29) << 3 | 0)[:1]], FLAT_FIELDS),
    "wire_mismatch_skips": (
        [tag(1, 1) + struct.pack("<q", 9) + tag(1, 0) + varint(4),
         tag(2, 0) + varint(3) + ld(2, b"ok")], FLAT_FIELDS),
    "required_and_defaults": (
        [tag(1, 0) + varint(5), tag(2, 0) + varint(9), b"", None],
        [jpb.Field(1, jdt.INT64, required=True, name="r"),
         jpb.Field(2, jdt.INT32, default=42, name="dflt"),
         jpb.Field(3, jdt.FLOAT64, default=1.25, name="fd"),
         jpb.Field(4, jdt.BOOL8, default=True, name="bd")]),
    "varint_edge_values": (
        [tag(1, 0) + varint(v) + tag(2, 0) + varint(v) + tag(3, 0)
         + varint(v) for v in VALS],
        [jpb.Field(1, jdt.INT64, name="a"),
         jpb.Field(2, jdt.INT32, name="b"),
         jpb.Field(3, jdt.INT64, encoding=jpb.ZIGZAG, name="c")]),
    "string_default": (
        [ld(1, b"xx"), tag(2, 0) + varint(5), b"", ld(1, b""),
         b"\xff" * 11],
        [jpb.Field(1, jdt.STRING, default="dflt", name="s"),
         jpb.Field(2, jdt.INT64, name="a")]),
    "nested_message": (
        [tag(1, 0) + varint(5) + ld(2, SUB1), tag(1, 0) + varint(6),
         ld(2, b"") + tag(1, 0) + varint(1),
         tag(1, 0) + varint(2) + ld(2, tag(1, 0) + b"\xff" * 11),
         tag(1, 0) + varint(3) + tag(2, 0) + varint(1),
         ld(2, SUB1) + ld(2, tag(1, 0) + varint(9)), b""], NESTED),
    "deep_nested_message": (
        [ld(1, ld(1, tag(1, 0) + varint(42)) + tag(2, 0) + varint(3)),
         ld(1, tag(2, 0) + varint(8)), b""],
        [jpb.Field(1, jdt.STRUCT, name="mid", children=(
            jpb.Field(1, jdt.STRUCT, name="inner",
                      children=(jpb.Field(1, jdt.INT64, name="q"),)),
            jpb.Field(2, jdt.INT32, name="r")))]),
    "nested_required_inside_submessage": (
        [tag(1, 0) + varint(1) + ld(2, tag(1, 0) + varint(9)),
         tag(1, 0) + varint(2) + ld(2, b"")],
        [jpb.Field(1, jdt.INT64, name="a"),
         jpb.Field(2, jdt.STRUCT, name="m", children=(
             jpb.Field(1, jdt.INT64, required=True, name="x"),))]),
    "repeated": (
        [tag(1, 0) + varint(3) + tag(1, 0) + varint(4) + tag(3, 0)
         + varint(9), ld(1, varint(1) + varint(2) + varint(300)),
         ld(2, b"aa") + ld(2, b"bb") + ld(2, b""), b"", ld(1, b""),
         tag(1, 0) + varint(7) + ld(1, varint(8) + varint(9)),
         tag(1, 0) + b"\xff" * 11], REP_FIELDS),
    "repeated_packed_fixed_zigzag": (
        [ld(1, varint(3) + varint(4)),
         ld(2, struct.pack("<dd", 1.5, -2.5)),
         ld(3, struct.pack("<ff", 0.5, 7.25)),
         tag(2, 1) + struct.pack("<d", 9.0) + ld(2, struct.pack("<d", 3.0)),
         ld(2, struct.pack("<d", 1.0) + b"\x01")],
        [jpb.Field(1, jdt.INT64, encoding=jpb.ZIGZAG, repeated=True,
                   name="z"),
         jpb.Field(2, jdt.FLOAT64, repeated=True, name="d"),
         jpb.Field(3, jdt.FLOAT32, repeated=True, name="f")]),
    "repeated_message": (
        [tag(1, 0) + varint(1) + ld(2, SUB1) + ld(2, SUB2),
         tag(1, 0) + varint(2), ld(2, b""),
         ld(2, SUB1) + tag(1, 0) + varint(3) + ld(2, SUB2),
         ld(2, tag(1, 0) + b"\xff" * 11), tag(2, 0) + varint(1), b""],
        [jpb.Field(1, jdt.INT64, name="a"),
         jpb.Field(2, jdt.STRUCT, repeated=True, children=tuple(SUB),
                   name="ms")]),
    "repeated_message_nested_repeated_scalar": (
        [ld(2, ld(1, varint(1) + varint(2))) + ld(2, tag(1, 0) + varint(5)),
         ld(2, b""), b""],
        [jpb.Field(2, jdt.STRUCT, repeated=True, name="ms", children=(
            jpb.Field(1, jdt.INT64, repeated=True, name="xs"),))]),
    "repeated_message_all_empty": (
        [tag(3, 0) + varint(1), b""],
        [jpb.Field(2, jdt.STRUCT, repeated=True, name="ms",
                   children=(jpb.Field(1, jdt.INT64, name="x"),)),
         jpb.Field(3, jdt.INT64, name="a")]),
    # length varints of 2^63 and more: negative on int64 lanes, so only
    # an unsigned clamp keeps them from passing as short payloads
    "huge_length_flat": (
        [tag(2, 2) + varint(2**63) + b"ab", tag(2, 2) + varint(2**64 - 1),
         tag(12, 2) + varint(2**63 + 1) + b"abc",
         tag(1, 0) + varint(5) + tag(2, 2) + varint(2**63 + 2) + b"x",
         tag(2, 2) + varint(2**62) + b"ab", tag(1, 0) + varint(5)],
        FLAT_FIELDS),
    "huge_length_nested": (
        [ld(2, tag(2, 2) + varint(2**64 - 1)),
         ld(2, tag(7, 2) + varint(2**63 + 1)),
         tag(1, 0) + varint(2) + ld(2, SUB1)], NESTED),
    "huge_length_repeated": (
        [tag(1, 2) + varint(2**63) + varint(1),
         tag(2, 2) + varint(2**63 + 5) + b"aa",
         ld(2, b"ok") + tag(2, 2) + varint(2**64 - 1),
         ld(1, varint(1)) + tag(3, 0) + varint(4)], REP_FIELDS),
}

# rows of the huge-length cases that decode: every other one is null
HUGE_LENGTH_VALID = {"huge_length_flat": [5],
                     "huge_length_nested": [2],
                     "huge_length_repeated": [3]}


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_engine_cases(case, monkeypatch):
    """tests/test_protobuf_device.py's differential cases: the port's
    engine equal to its oracle, and at a 3-row chunk to itself (its
    bytes against the JAX engine's: test_torch_protobuf_parity.py)."""
    msgs, fields = DEVICE_CASES[case]
    got = check_all(msgs, fields, monkeypatch, jax_engine=False)
    if case == "repeated_message_all_empty":
        lst = got.children[0]
        assert lst.dtype.kind == "list"
        assert lst.children[0].dtype.kind == "struct"
        assert lst.children[0].length == 0


@pytest.mark.parametrize("case", sorted(HUGE_LENGTH_VALID))
def test_huge_length_varints_are_null(case, monkeypatch):
    """A LEN field whose length varint is 2^62, 2^63 or 2^64 - 1 makes
    its row null in the oracle and in the engine, in both packages."""
    msgs, fields = DEVICE_CASES[case]
    jc, tc = columns(msgs)
    tf = port_fields(fields)
    valid = HUGE_LENGTH_VALID[case]
    for out in (tpb.decode_protobuf_host(tc, tf), engine(tc, tf),
                engine(tc, tf, 1, monkeypatch),
                jpb.decode_protobuf_to_struct(jc, fields)):
        rows = out.to_pylist()
        assert [i for i, r in enumerate(rows) if r is not None] == valid


@pytest.mark.parametrize("length", [len(SUB1) + 4, 2**63, 2**64 - 1])
def test_overlong_nested_message_oracle_vs_engine(length):
    """A nested message whose length runs past the row's end: both
    packages' host oracles decode what bytes there are, both engines
    null the row (ROADMAP Queue C, reference side)."""
    fields = NESTED
    msgs = [tag(1, 0) + varint(1) + tag(2, 2) + varint(length) + SUB1]
    jc, tc = columns(msgs)
    tf = port_fields(fields)
    want = [(1, (7, "hi"))]
    assert tpb.decode_protobuf_host(tc, tf).to_pylist() == want
    assert jpb.decode_protobuf_to_struct(jc, fields).to_pylist() == want
    assert engine(tc, tf).to_pylist() == [None]
    assert jpd.decode_protobuf_to_struct_device(jc, fields).to_pylist() \
        == [None]


def fuzz_flat(rng, rows=300):
    msgs = []
    for _ in range(rows):
        parts = []
        for _f in range(rng.integers(0, 6)):
            num = int(rng.integers(1, 12))
            wire = int(rng.choice([0, 1, 2, 5]))
            if wire == 0:
                parts.append(tag(num, 0)
                             + varint(int(rng.integers(0, 2**63))))
            elif wire == 1:
                parts.append(tag(num, 1) + bytes(rng.integers(
                    0, 256, 8, dtype=np.uint8)))
            elif wire == 5:
                parts.append(tag(num, 5) + bytes(rng.integers(
                    0, 256, 4, dtype=np.uint8)))
            else:
                n = int(rng.integers(0, 12))
                parts.append(ld(num, bytes(rng.integers(65, 90, n,
                                                        dtype=np.uint8))))
        msg = b"".join(parts)
        if rng.random() < 0.15 and msg:   # random truncation
            msg = msg[:int(rng.integers(0, len(msg)))]
        msgs.append(msg)
    return msgs


def fuzz_nested(rng, rows=60):
    msgs = []
    for _ in range(rows):
        parts = []
        if rng.random() < 0.8:
            parts.append(tag(1, 0) + varint(int(rng.integers(0, 99))))
        if rng.random() < 0.8:
            sub = b""
            if rng.random() < 0.8:
                sub += tag(1, 0) + varint(int(rng.integers(0, 1000)))
            if rng.random() < 0.6:
                sub += ld(2, bytes(rng.integers(97, 122, 5,
                                                dtype=np.uint8)))
            if rng.random() < 0.2:
                sub += tag(9, 0) + varint(4)      # unknown field
            parts.append(ld(2, sub))
        if rng.random() < 0.1:
            parts.append(bytes([0xFF]))           # trailing garbage
        rng.shuffle(parts)
        msgs.append(b"".join(parts))
    return msgs


def fuzz_repeated(rng, rows=50):
    msgs = []
    for _ in range(rows):
        parts = []
        for _k in range(int(rng.integers(0, 4))):
            parts.append(tag(1, 0) + varint(int(rng.integers(0, 500))))
        if rng.random() < 0.5:
            parts.append(ld(1, b"".join(
                varint(int(v)) for v in
                rng.integers(0, 1000, int(rng.integers(0, 6))))))
        for _k in range(int(rng.integers(0, 3))):
            parts.append(ld(2, bytes(rng.integers(
                97, 122, int(rng.integers(0, 6)), dtype=np.uint8))))
        if rng.random() < 0.3:
            parts.append(tag(3, 0) + varint(int(rng.integers(0, 99))))
        rng.shuffle(parts)
        msgs.append(b"".join(parts))
    return msgs


@pytest.mark.parametrize("name,make,seed,fields", [
    ("flat", fuzz_flat, 7, FLAT_FIELDS),
    ("nested", fuzz_nested, 41, NESTED),
    ("repeated", fuzz_repeated, 77, REP_FIELDS)])
def test_fuzz_differential(name, make, seed, fields, monkeypatch):
    """The JAX tests' seeded fuzz corpora: the port's engine against its
    oracle (and the JAX oracle's bytes)."""
    check_all(make(np.random.default_rng(seed)), fields, monkeypatch,
              jax_engine=False)


# ------------------------------------------------ the chip phase's schema


def jax_fields_of(fields):
    return [jpb.Field(f.field_number, jdt.DType(f.dtype.kind),
                      f.encoding, f.repeated, f.required, f.default,
                      f.name, tuple(jax_fields_of(f.children)))
            for f in fields]


def jax_column_of(col):
    """The JAX package's STRING column over a port column's buffers
    (null rows keep their bytes)."""
    return JColumn(jdt.STRING, col.length,
                   data=jnp.asarray(col.data.numpy()),
                   validity=None if col.validity is None
                   else jnp.asarray(col.validity.numpy()),
                   offsets=jnp.asarray(col.offsets.numpy()))


@pytest.mark.parametrize("seed", [3])
def test_chip_schema_fuzz(seed, monkeypatch):
    """chip_smoke.py's clickstream events (nested device message, packed
    item_ids, unpacked tags, a quantity default, every edge kind) at a
    small size and a 1/4 edge share: both packages' oracles and engines
    byte for byte, the port's engine equal to its oracle in canonical
    form, with chunk edges inside the column."""
    import chip_smoke as C
    col = C.protobuf_events(400, seed, "cpu", edge_every=4)
    tf = C.pb_fields()
    jf = jax_fields_of(tf)
    jc = jax_column_of(col)
    t_host = tpb.decode_protobuf_host(col, tf)
    assert col_parts(t_host) == col_parts(
        jpb.decode_protobuf_to_struct(jc, jf))
    t_dev = engine(col, tf, 37, monkeypatch)
    assert tpd.LAST_CALL["chunk_steps"][0] > 20
    assert col_parts(t_dev) == col_parts(
        jpd.decode_protobuf_to_struct_device(jc, jf))
    C.same_nested(C.pb_canonical(t_dev), C.pb_canonical(t_host),
                  "engine == oracle")
    assert t_dev.validity is not None        # the edges and nulls


def test_chip_phase_rehearsal_on_cpu(monkeypatch):
    """chip_smoke.py's protobuf phase on CPU tensors at a small size
    (the engine forced, as a card column takes it)."""
    import chip_smoke as C
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_PROTOBUF", "1")
    monkeypatch.setattr(tpd, "DEVICE_ROW_CHUNK", 300)
    res = C.protobuf_phase("cpu", rows=1200, check_rows=600,
                           fallback_rows=200, iters=1)
    assert res["decode"]["route"] == "device"
    assert res["decode"]["host_rows"] == 0
    assert res["fallback"]["route"] == "host"
    assert res["stats"]["fallback"] == 1


# ------------------------------------------------ routing and the JNI door


def test_router_routes_by_device(monkeypatch):
    """A CPU column takes the host oracle; FORCE_DEVICE_PROTOBUF=1 drives
    the engine on CPU tensors (the JAX package's knob)."""
    msgs = [tag(1, 0) + varint(5)] * 4
    fields = [tpb.Field(1, tdt.INT64, name="a")]
    col = TColumn.from_strings(msgs, "cpu")
    assert not tpd.use_device(col, fields)
    out = tpb.decode_protobuf_to_struct(col, fields)
    assert tpd.LAST_CALL == {"route": "host", "fallback": False,
                             "host_rows": 4}
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_PROTOBUF", "1")
    got = tpb.decode_protobuf_to_struct(col, fields)
    assert tpd.LAST_CALL["route"] == "device"
    assert tpd.LAST_CALL["host_rows"] == 0
    assert got.to_pylist() == out.to_pylist() == [(5,)] * 4


def test_repeat_cap_fallback(monkeypatch):
    """A row past SPARK_RAPIDS_TPU_PROTOBUF_REPEAT_CAP hands the column
    back (None) and the router decodes all of it on the host, counted;
    the JAX engine hands it back too."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PROTOBUF_REPEAT_CAP", "4")
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_PROTOBUF", "1")
    jpd._ENGINE_CACHE.clear()
    msgs = [ld(1, b"".join(varint(i) for i in range(10))),
            ld(1, varint(3))]
    fields = [jpb.Field(1, jdt.INT64, repeated=True, name="xs")]
    jc, tc = columns(msgs)
    tf = port_fields(fields)
    assert tpd.decode_protobuf_to_struct_device(tc, tf) is None
    assert jpd.decode_protobuf_to_struct_device(jc, fields) is None
    jpd._ENGINE_CACHE.clear()
    tpd.reset_stats()
    got = tpb.decode_protobuf_to_struct(tc, tf)
    assert tpd.LAST_CALL["route"] == "host" and tpd.LAST_CALL["fallback"]
    assert tpd.LAST_CALL["host_rows"] == 2
    assert tpd.STATS == {"device": 0, "host": 1, "fallback": 1}
    assert got.to_pylist() == [(list(range(10)),), ([3],)]
    assert col_parts(got) == col_parts(
        jpb.decode_protobuf_to_struct(jc, fields))


def test_unsupported_schema_routes_host():
    fields = [tpb.Field(1, tdt.INT64, encoding=99, name="weird")]
    assert not tpd.supported_schema(fields)
    col = TColumn.from_strings([tag(1, 0) + varint(7)], "cpu")
    assert tpd.decode_protobuf_to_struct_device(col, fields) is None


def test_invalid_utf8_divergence_in_both_packages(monkeypatch):
    """The host oracle writes U+FFFD for invalid UTF-8, the engine passes
    the bytes through: in both packages alike (protobuf_device's
    divergence note)."""
    msgs = [ld(1, b"ok\xff\xfe"), ld(1, b"fine")]
    fields = [jpb.Field(1, jdt.STRING, name="s")]
    jc, tc = columns(msgs)
    tf = port_fields(fields)
    t_host = tpb.decode_protobuf_host(tc, tf)
    t_dev = tpd.decode_protobuf_to_struct_device(tc, tf)
    assert bytes(t_host.children[0].data.numpy()) == \
        "ok��".encode() + b"fine"
    assert bytes(t_dev.children[0].data.numpy()) == b"ok\xff\xfefine"
    assert col_parts(t_host) == col_parts(
        jpb.decode_protobuf_to_struct(jc, fields))
    assert col_parts(t_dev) == col_parts(
        jpd.decode_protobuf_to_struct_device(jc, fields))


def test_binary_list_input_column(monkeypatch):
    """A LIST<UINT8> binary column decodes as its STRING view does."""
    msgs = [tag(1, 0) + varint(9) + ld(2, b"zz"), b"", None]
    fields = [tpb.Field(1, tdt.INT64, name="a"),
              tpb.Field(2, tdt.STRING, name="s")]
    s = TColumn.from_strings(msgs, "cpu")
    lst = TColumn.make_list_from_parts(s.offsets, s.data)
    lst.validity = s.validity
    monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_PROTOBUF", "1")
    for col in (s, lst):
        assert col_parts(tpb.decode_protobuf_to_struct(col, fields)) == \
            col_parts(tpb.decode_protobuf_to_struct(s, fields))
    with pytest.raises(ValueError, match="binary"):
        tpb.decode_protobuf_to_struct(
            TColumn.from_pylist([1], tdt.INT64, "cpu"), fields)


def test_jni_entry_protobuf_decode_to_struct():
    """jni_entry.protobuf_decode_to_struct on handles: the JAX entry's
    arguments and bytes."""
    from spark_rapids_tpu.shim import jni_entry as JJE
    from spark_rapids_tpu.shim.handles import REGISTRY as JREG
    from spark_rapids_tpu_torch.shim import jni_entry as TJE
    from spark_rapids_tpu_torch.shim.handles import REGISTRY as TREG
    msgs = [tag(1, 0) + varint(150) + ld(2, b"hi") + tag(3, 5)
            + struct.pack("<i", -3), tag(2, 0) + varint(1), None]
    args = ([1, 2, 3], ["int64", "string", "int32"], [0, 0, 1],
            [True, False, False])
    jc, tc = columns(msgs)
    live = TJE.live_handles()
    th, jh = TREG.register(tc), JREG.register(jc)
    t_out = TJE.protobuf_decode_to_struct(th, *args)
    j_out = JJE.protobuf_decode_to_struct(jh, *args)
    got = TREG.get(t_out)
    assert got.to_pylist() == [(150, "hi", -3), None, None]
    assert col_parts(got) == col_parts(JREG.get(j_out))
    for h in (th, t_out):
        TJE.free(h)
    for h in (jh, j_out):
        JJE.free(h)
    assert TJE.live_handles() == live
