"""PyTorch port: the from_json family -- the raw map (host tree-builder,
device multi-capture scan, structural-index tokenizer), flat and nested
structs (host builder, device scan, tokenizer), convert_from_strings,
remove_quotes, concat_json -- and the five map ops, held byte for byte
against the JAX package.

The cases are those of tests/test_raw_map_device.py,
test_from_json_device.py and test_inventory_batch.py, built from the same
host arrays for both packages and compared on host bytes (data,
validity, offsets, children).  Engines of one package are compared with
each other as text (to_pylist), since the device engines pass invalid
UTF-8 through where the host oracle writes U+FFFD.  Columns the JAX
device scans read are padded to fixed shapes so the JAX package
compiles each scan once.
"""

import numpy as np
import pytest

from spark_rapids_tpu.columns import dtypes as Jdt
from spark_rapids_tpu.ops import from_json_device as JFJ
from spark_rapids_tpu.ops import json_tokenizer as JJT
from spark_rapids_tpu.ops import json_utils as JJU
from spark_rapids_tpu.ops import map_utils as JMU
from spark_rapids_tpu.ops import raw_map_device as JRM
from spark_rapids_tpu.ops.exceptions import (ExceptionWithRowIndex as
                                             JExceptionWithRowIndex)
from spark_rapids_tpu_torch.columns import dtypes as dt
from spark_rapids_tpu_torch.ops import from_json_device as FJ
from spark_rapids_tpu_torch.ops import json_tokenizer as JT
from spark_rapids_tpu_torch.ops import json_utils as JU
from spark_rapids_tpu_torch.ops import map_utils as MU
from spark_rapids_tpu_torch.ops import raw_map_device as RM
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex
from spark_rapids_tpu_torch.perf import calibrate

from torch_port_data import (JSON_EDGE_DOCS, col_parts, jax_column,
                             json_event_docs, port_column, strings_spec,
                             values_spec)


def _wide_object(n):
    return "{" + ", ".join('"k%d": %d' % (i, i) for i in range(n)) + "}"


RAW_DOCS = [
    '{"a": 1, "b": "x"}', '{}', '{"k": true, "l": false, "m": null}',
    '{"n": -1.5e3, "o": 0, "p": 0.25}', '{"s": "with space", "t": ""}',
    '{ "ws" : 7 , "x" : "y" }', '{"nested": {"a": 1}}', '{"arr": [1, 2]}',
    '{"esc": "a\\nb"}', '{"dup": 1, "dup": 2}', '{"a": 007}',
    '{"a": NaN}', '[1, 2]', '"str"', 'not json', '', None, '{"a": 1',
    '{"a": 1} trailing', '{"many": 1, "keys": 2, "here": 3, "now": 4}',
    "{'sq': 1}", '{"unicode": "café"}',
    '{"a": 1, "b": "x", "c": [1,2], "a": 9}', '{"price": 200.000, "x": 1.5e3}',
    '{"k": 01}', '{"a": 00.5, "b": -01}', '{"a\\u0062": 1}',
    _wide_object(33), _wide_object(40), _wide_object(65),
    b'{"bad": "\xff", "ok": 1}',
]


def _raw_fuzz(seed, n):
    rng = np.random.default_rng(seed)
    keys = ["a", "bb", "ccc", "d_d", "e-e", "f f"]
    docs = []
    for _ in range(n):
        parts = []
        for _k in range(int(rng.integers(0, 6))):
            k = keys[rng.integers(len(keys))]
            r = rng.random()
            if r < 0.3:
                v = str(rng.integers(-10**6, 10**6))
            elif r < 0.5:
                v = "%.4g" % rng.normal()
            elif r < 0.65:
                v = '"s%d"' % rng.integers(50)
            elif r < 0.75:
                v = ["true", "false", "null"][rng.integers(3)]
            elif r < 0.85:
                v = '{"in": 1}'
            else:
                v = "[3]"
            parts.append('"%s": %s' % (k, v))
        doc = "{" + ", ".join(parts) + "}"
        r = rng.random()
        if r < 0.07 and doc != "{}":
            doc = doc[:-1]
        elif r < 0.1:
            doc = doc + "x"
        docs.append(doc)
    return docs


RAW_CORPUS = RAW_DOCS + _raw_fuzz(31, 200) + ['{"end": 1}']


def _both(values):
    spec = strings_spec(values)
    return jax_column(spec), port_column(spec)


def _same(got, want):
    assert col_parts(got) == col_parts(want)


def _same_text(got, want):
    assert got.to_pylist() == want.to_pylist()


@pytest.fixture(autouse=True)
def _calib_file(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    calibrate.forget()


@pytest.fixture(scope="module")
def raw_corpus():
    return _both(RAW_CORPUS)


@pytest.mark.parametrize("lz", [False, True])
def test_raw_map_engines(raw_corpus, lz):
    """Each raw-map engine (wider than 32 and 64 pairs, duplicate keys,
    leading zeros under both settings): the port's == the JAX
    package's, and the three agree as text."""
    jc, pc = raw_corpus
    host = JU._raw_map_host(pc, lz)
    _same(host, JJU._raw_map_host(jc, lz))
    dev = RM.from_json_to_raw_map_device(pc, lz)
    _same(dev, JRM.from_json_to_raw_map_device(jc, lz))
    _same_text(dev, host)
    assert RM.last_stats["fallback_rows"] > 0
    tok = JT.from_json_to_raw_map_tokenized(pc, lz)
    _same(tok, JJT.from_json_to_raw_map_tokenized(jc, lz))
    assert JT.last_stats == JJT.last_stats
    _same_text(tok, host)


@pytest.mark.parametrize("engine", ["host", "device_scan", "tokenizer",
                                    "force"])
def test_raw_map_router(engine, monkeypatch):
    """from_json_to_raw_map with each engine pinned (and the force knob),
    in both packages; the result lives on the input's device."""
    docs = RAW_DOCS[:26] * 12
    jc, pc = _both(docs)
    if engine == "force":
        monkeypatch.setenv("SPARK_RAPIDS_TPU_FORCE_DEVICE_RAW_MAP", "1")
    else:
        monkeypatch.setenv("SPARK_RAPIDS_TPU_PATH_JSON_RAW_MAP", engine)
    got = JU.from_json_to_raw_map(pc)
    _same(got, JJU.from_json_to_raw_map(jc))
    assert got.children[0].children[0].device == pc.device
    small = _both(RAW_DOCS[:5])
    _same(JU.from_json_to_raw_map(small[1]),
          JJU.from_json_to_raw_map(small[0]))


def test_raw_map_inventory_vectors():
    """test_inventory_batch / test_json_uri_strings expectations."""
    jc, pc = _both(['{"a": 1, "b": "x", "c": [1,2], "a": 9}', 'not json',
                    '[1,2]', None, "{}"])
    got = JU.from_json_to_raw_map(pc)
    _same(got, JJU.from_json_to_raw_map(jc))
    assert got.to_pylist() == [[("a", "9"), ("b", "x"), ("c", "[1,2]")],
                               None, None, None, []]
    m = JU.from_json_to_raw_map(port_column(strings_spec(
        ['{"price": 200.000, "x": 1.5e3}'])))
    assert m.children[0].children[1].to_pylist() == ["200.000", "1.5e3"]
    bad = port_column(strings_spec(['{"k": 01}']))
    assert JU.from_json_to_raw_map(bad).validity.tolist() == [0]
    assert JU.from_json_to_raw_map(bad, allow_leading_zeros=True) \
        .children[0].children[1].to_pylist() == ["01"]


FIELDS = [("a", "int64"), ("s", "string"), ("d", "float64"),
          ("b", "bool8"), ("n", "int32")]

STRUCT_DOCS = [
    '{"a": 1, "s": "x", "d": 2.5, "b": true, "n": -7}', '{"a": 1}',
    '{"s": "esc\\nape"}', '{"a": null, "b": false}', '{"a": "12", "d": "3.5"}',
    '{"a": 1.5}', '{"x": 9}', '[1, 2]', '"just a string"', 'not json', '',
    None, '{"a": 1, "a": 2}', '{"s": {"nested": 1}}', '{"s": [1, 2, 3]}',
    '{"d": -0.0}', '{"d": 1e300, "a": 9223372036854775807}',
    '{"n": 2147483648}', '{  "a"  :  42  }', "{'a': 5}", '{"b": "true"}',
    '{"s": ""}', '{"a": 007}', '{"s": "caf\\u00e9", "b": "false"}',
    b'{"s": "\xfe", "a": 3}',
]


def _struct_fuzz(seed, n):
    rng = np.random.default_rng(seed)
    keys = ["a", "s", "d", "b", "n", "zz"]
    docs = []
    for _ in range(n):
        parts = []
        for _k in range(int(rng.integers(0, 5))):
            k = keys[rng.integers(len(keys))]
            r = rng.random()
            if r < 0.25:
                v = str(rng.integers(-10**9, 10**9))
            elif r < 0.45:
                v = f"{rng.normal():.6g}"
            elif r < 0.6:
                v = '"w%d"' % rng.integers(100)
            elif r < 0.7:
                v = ["true", "false", "null"][rng.integers(3)]
            elif r < 0.8:
                v = '[1, 2]'
            else:
                v = '{"q": 1}'
            parts.append('"%s": %s' % (k, v))
        doc = "{" + ", ".join(parts) + "}"
        if rng.random() < 0.1:
            doc = doc[:-1]
        docs.append(doc)
    return docs


def _fields(spec, mod):
    """A schema with kind names swapped for `mod`'s DTypes."""
    if isinstance(spec, str):
        return getattr(mod, spec.upper())
    if isinstance(spec, list):
        return [(n, _fields(s, mod)) for n, s in spec]
    return (spec[0], _fields(spec[1], mod))


@pytest.fixture(scope="module")
def struct_corpus():
    docs = STRUCT_DOCS + _struct_fuzz(23, 230) + ['{"end": 1}']
    assert len(docs) == 256      # the routers' device floor
    return _both(docs)


def test_flat_structs_engines(struct_corpus):
    """Each flat-struct engine: the port's == the JAX package's, and the
    three agree as text; the public entry in both packages."""
    jc, pc = struct_corpus
    pf, jf = _fields(FIELDS, dt), _fields(FIELDS, Jdt)
    host = JU._build_json_column(list(JU._parse_rows(pc)),
                                 ("struct", pf), pc.device)
    _same(host, JJU._build_json_column(list(JJU._parse_rows(jc)),
                                       ("struct", jf)))
    dev = FJ.from_json_to_structs_device(pc, pf)
    _same(dev, JFJ.from_json_to_structs_device(jc, jf))
    _same_text(dev, host)
    tok = JT.from_json_to_structs_tokenized(pc, pf)
    _same(tok, JJT.from_json_to_structs_tokenized(jc, jf))
    assert JT.last_stats == JJT.last_stats
    _same_text(tok, host)
    _same(JU.from_json_to_structs(pc, pf), JJU.from_json_to_structs(jc, jf))


@pytest.mark.parametrize("engine", ["host", "device_scan", "tokenizer"])
def test_structs_router_pinned(struct_corpus, engine, monkeypatch):
    jc, pc = struct_corpus
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PATH_JSON_FROM_JSON", engine)
    pf, jf = _fields(FIELDS, dt), _fields(FIELDS, Jdt)
    got = JU.from_json_to_structs(pc, pf)
    _same(got, JJU.from_json_to_structs(jc, jf))
    assert got.children[1].device == pc.device


NESTED_DOCS = [
    '{"a": {"b": 7, "c": "x"}, "d": [1, 2, 3]}', '{"a": {"b": null}, "d": []}',
    '{"a": 5, "d": [10]}', '{"d": [[1, 2], [3]]}',
    '{"d": [ {"e": "y"}, {"e": "z"} ]}', '{"d": ["s1", "s2", null]}',
    '{"a": {"b": 1, "b": 2}}', '{"a": {"deep": {"x": 1}}}', '{"d": [ 1 , 2 ]}',
    '{"d": "[1,2]"}', '{"d": [1, [2, {"k": [3]}], "s"]}', '{"d": [  ]}',
    'null', 'not json', None, '{}', '{"a": {"c": "q\\"uote"}}',
    "{'a': {'b': 3}}", '{"d": [1,,2]}', '{"d": [1, 2,]}',
    '{"d": [\'x\', "y"]}', '{"d": ["a,b", "c]d", "e\\\\"]}',
]

NESTED_SCHEMAS = [
    [("a", ("struct", [("b", "int64"), ("c", "string")])),
     ("d", ("list", "int64"))],
    [("d", ("list", ("list", "int64")))],
    [("d", ("list", ("struct", [("e", "string")])))],
    [("d", ("list", "string"))],
    [("a", ("struct", [("deep", ("struct", [("x", "int64")]))]))],
    [("d", ("list", ("list", ("list", "int32"))))],
]


@pytest.mark.parametrize("schema", range(len(NESTED_SCHEMAS)))
def test_nested_structs(schema):
    """Nested schemas: the host builder == the JAX package's, the port's
    device engine == its host builder; on the list-of-structs schema the
    device engine == the JAX package's device engine."""
    jc, pc = _both(NESTED_DOCS)
    pf = _fields(NESTED_SCHEMAS[schema], dt)
    jf = _fields(NESTED_SCHEMAS[schema], Jdt)
    host = JU.from_json_to_structs_nested(pc, ("struct", pf))
    _same(host, JJU.from_json_to_structs_nested(jc, ("struct", jf)))
    dev = FJ.from_json_to_structs_device(pc, pf)
    _same_text(dev, host)
    if schema == 2:
        _same(dev, JFJ.from_json_to_structs_device(jc, jf))


def test_nested_event_schema():
    """The clickstream schema the card's phase runs: user struct and the
    items list of structs, on the seeded events with the edge
    vocabulary."""
    schema = [("user", ("struct", [("id", "int64"), ("name", "string"),
                                   ("tags", ("list", "string"))])),
              ("items", ("list", ("struct", [("sku", "string"),
                                             ("qty", "int32"),
                                             ("price", "float64")])))]
    docs = json_event_docs(5, 90, edge_every=4) + ['{"end": 1}']
    jc, pc = _both(docs)
    pf, jf = _fields(schema, dt), _fields(schema, Jdt)
    host = JU.from_json_to_structs_nested(pc, ("struct", pf))
    _same(host, JJU.from_json_to_structs_nested(jc, ("struct", jf)))
    _same_text(FJ.from_json_to_structs_device(pc, pf), host)


def test_nested_inventory_vectors():
    rows = [
        '{"a": 1, "b": {"x": "hi", "y": 2.5}, "c": [1,2,3],'
        ' "d": [{"k": 7}, {"k": 8}]}',
        '{"a": 2, "b": null, "c": [], "d": null}',
        '{"b": {"x": null, "y": "nope"}, "c": [4, null]}',
        'not json', None, '[1,2]',
        '{"a": "5", "c": "notalist", "d": [{"z": 1}, 3]}',
    ]
    schema = [("a", "int64"), ("b", ("struct", [("x", "string"),
                                                 ("y", "float64")])),
              ("c", ("list", "int64")),
              ("d", ("list", ("struct", [("k", "int32")])))]
    jc, pc = _both(rows)
    pf, jf = _fields(schema, dt), _fields(schema, Jdt)
    got = JU.from_json_to_structs_nested(pc, ("struct", pf))
    _same(got, JJU.from_json_to_structs_nested(jc, ("struct", jf)))
    _same_text(FJ.from_json_to_structs_device(pc, pf), got)
    assert got.to_pylist()[0] == (1, ("hi", 2.5), [1, 2, 3], [(7,), (8,)])


def test_allow_leading_zeros_device():
    docs = ['{"a": 007}', '{"a": 7}', '{"a": 0}', '{"a": 00.5}',
            '{"a": [01, 2]}', '{"m": {"b": 012}}', '{"a": 0x7}', "bad", None]
    jc, pc = _both(docs)
    for schema in ([("a", "int64")], [("a", ("list", "int64"))],
                   [("m", ("struct", [("b", "int64")]))],
                   [("a", "float64")]):
        pf, jf = _fields(schema, dt), _fields(schema, Jdt)
        for lz in (False, True):
            host = JU.from_json_to_structs_nested(pc, ("struct", pf),
                                                  allow_leading_zeros=lz)
            _same(host, JJU.from_json_to_structs_nested(
                jc, ("struct", jf), allow_leading_zeros=lz))
            _same_text(FJ.from_json_to_structs_device(pc, pf, lz), host)


def test_nested_fuzz_device_vs_host():
    rng = np.random.default_rng(61)

    def leaf():
        r = rng.random()
        if r < 0.3:
            return str(rng.integers(-(10**6), 10**6))
        if r < 0.5:
            return f"{rng.normal():.4g}"
        if r < 0.7:
            return '"s%d"' % rng.integers(50)
        return ["true", "false", "null"][rng.integers(3)]

    def value(depth):
        r = rng.random()
        if depth >= 3 or r < 0.5:
            return leaf()
        if r < 0.75:
            return "[" + ", ".join(value(depth + 1) for _ in range(
                int(rng.integers(0, 4)))) + "]"
        return "{" + ", ".join('"%s": %s' % (["b", "f", "g"][
            rng.integers(3)], value(depth + 1)) for _ in range(
                int(rng.integers(0, 3)))) + "}"

    docs = []
    for _ in range(120):
        doc = "{" + ", ".join('"%s": %s' % (["a", "d", "e"][
            rng.integers(3)], value(1)) for _ in range(
                int(rng.integers(0, 4)))) + "}"
        docs.append(doc[:-1] if rng.random() < 0.08 else doc)
    jc, pc = _both(docs)
    for schema in ([("a", ("struct", [("b", "int64")])),
                    ("d", ("list", "int64"))],
                   [("e", ("list", ("struct", [("f", "string")])))],
                   [("d", ("list", ("list", "float64")))]):
        pf, jf = _fields(schema, dt), _fields(schema, Jdt)
        host = JU.from_json_to_structs_nested(pc, ("struct", pf))
        _same(host, JJU.from_json_to_structs_nested(jc, ("struct", jf)))
        _same_text(FJ.from_json_to_structs_device(pc, pf), host)


@pytest.mark.parametrize("kind", ["bool8", "int8", "int32", "int64",
                                  "float32", "float64", "string"])
def test_convert_from_strings(kind):
    vals = ["true", "false", "True", "1", "-7", "300", " 12 ", "1.5",
            "-0.0", "1e3", "NaN", "9223372036854775808", "", None, "tru",
            "falsey", "0x10", "+4"] * 3
    jc, pc = _both(vals)
    _same(JU.convert_from_strings(pc, getattr(dt, kind.upper())),
          JJU.convert_from_strings(jc, getattr(Jdt, kind.upper())))


def test_remove_quotes_and_concat_json():
    jc, pc = _both(['"hi"', "plain", None, '"', '""', '"a"b"'])
    for nullify in (False, True):
        _same(JU.remove_quotes(pc, nullify), JJU.remove_quotes(jc, nullify))
    for docs in (['{"a":1}', None, "  ", '{"b":2}'],
                 ['{"a":"x\\ny"}', "\n", "{}"]):
        jc, pc = _both(docs)
        buf, delim, valid = JU.concat_json(pc)
        jbuf, jdelim, jvalid = JJU.concat_json(jc)
        assert (buf, delim) == (jbuf, jdelim)
        _same(valid, jvalid)
        assert valid.data.device == pc.device
    with pytest.raises(ValueError):
        JU.concat_json(port_column(strings_spec(["\n\r\x01\x02\x03"])))


def _map_spec(offsets, keys, vals, key_valid=None, entry_valid=None,
              row_valid=None):
    k = strings_spec(keys)
    if key_valid is not None:
        k = (k[0], k[1], np.asarray(key_valid, np.uint8), k[3])
    st = ("struct", None, None if entry_valid is None
          else np.asarray(entry_valid, np.uint8), None,
          (k, values_spec("int64", vals)))
    return ("list", None, None if row_valid is None
            else np.asarray(row_valid, np.uint8),
            np.asarray(offsets, np.int32), (st,))


MAPS = [
    _map_spec([0, 3, 5], ["a", "b", "a", "x", "y"], [1, 2, 3, 4, 5]),
    _map_spec([0, 3, 3, 6], ["c", "a", "b", "b", "b", "a"],
              [1, 2, 3, 4, 5, 6], row_valid=[1, 0, 1]),
    _map_spec([0, 2, 4], ["k", "j", "z", "k"], [1, 2, 3, None],
              key_valid=[1, 0, 1, 1], entry_valid=[1, 1, 0, 1]),
    _map_spec([0, 0], [], []),
]


@pytest.mark.parametrize("m", range(len(MAPS)))
def test_map_ops(m):
    """is_valid_map, map_from_entries (both null-key modes),
    sort_map_column (both orders) and map_zip_full against the JAX
    package; every result on the input's device."""
    jm, pm = jax_column(MAPS[m]), port_column(MAPS[m])
    assert MU.is_valid_map(pm) == JMU.is_valid_map(jm)
    try:
        want_valid = JMU.is_valid_map(jm, throw_on_null_key=True)
    except JExceptionWithRowIndex as e:
        with pytest.raises(ExceptionWithRowIndex) as got_e:
            MU.is_valid_map(pm, throw_on_null_key=True)
        assert got_e.value.row_index == e.row_index
    else:
        assert MU.is_valid_map(pm, throw_on_null_key=True) == want_valid
    for desc in (False, True):
        got = MU.sort_map_column(pm, desc)
        _same(got, JMU.sort_map_column(jm, desc))
    try:
        want = JMU.map_from_entries(jm)
    except JExceptionWithRowIndex as e:
        with pytest.raises(ExceptionWithRowIndex) as got_e:
            MU.map_from_entries(pm)
        assert got_e.value.row_index == e.row_index
    else:
        _same(MU.map_from_entries(pm), want)
    _same(MU.map_from_entries(pm, False), JMU.map_from_entries(jm, False))
    other = jax_column(MAPS[1]) if MAPS[m][3].shape[0] == 4 else jm
    pother = port_column(MAPS[1]) if MAPS[m][3].shape[0] == 4 else pm
    got = MU.map_zip_full(pm, pother)
    _same(got, JMU.map_zip_full(jm, other))
    assert got.offsets.device == pm.device


def test_map_zip_and_zip_full_key_union():
    keys = ("list", None, None, np.array([0, 2], np.int32),
            (strings_spec(["k1", "k2"]),))
    a = ("list", None, None, np.array([0, 2], np.int32),
         (values_spec("int64", [1, 2]),))
    b = ("list", None, None, np.array([0, 2], np.int32),
         (values_spec("int64", [10, 20]),))
    bad = ("list", None, None, np.array([0, 1], np.int32),
           (values_spec("int64", [1]),))
    got = MU.map_zip(*(port_column(s) for s in (keys, a, b)))
    _same(got, JMU.map_zip(*(jax_column(s) for s in (keys, a, b))))
    assert got.to_pylist() == [[("k1", 1, 10), ("k2", 2, 20)]]
    with pytest.raises(ValueError):
        MU.map_zip(port_column(keys), port_column(a), port_column(bad))

    def mk(rows):
        offs, ks, vs = [0], [], []
        for r in rows:
            for k, v in (r or []):
                ks.append(k)
                vs.append(v)
            offs.append(len(ks))
        return _map_spec(offs, ks, vs,
                         row_valid=[r is not None for r in rows])

    x = mk([[("a", 1), ("b", 2)], [("x", 5)], None, [], [("d", 1), ("d", 2)]])
    y = mk([[("b", 20), ("c", 30)], [], [("q", 9)], [("z", 7)], [("d", 3)]])
    got = MU.map_zip_full(port_column(x), port_column(y))
    _same(got, JMU.map_zip_full(jax_column(x), jax_column(y)))
    pair = got.children[0].children[1]
    assert pair.children[0].to_pylist() == [1, 2, None, 5, None, 2]


def test_event_docs_raw_map_and_structs():
    """The seeded events with the edge vocabulary through the raw map's
    tokenizer and host engines and the flat-struct tokenizer."""
    docs = json_event_docs(9, 160, edge_every=4) + JSON_EDGE_DOCS + \
        ['{"end": 1}']
    jc, pc = _both(docs)
    host = JU._raw_map_host(pc)
    _same(host, JJU._raw_map_host(jc))
    tok = JT.from_json_to_raw_map_tokenized(pc)
    _same(tok, JJT.from_json_to_raw_map_tokenized(jc))
    _same_text(tok, host)
    fields = [("event", "string"), ("ts", "int64"), ("user", "string")]
    pf, jf = _fields(fields, dt), _fields(fields, Jdt)
    _same(JT.from_json_to_structs_tokenized(pc, pf),
          JJT.from_json_to_structs_tokenized(jc, jf))
    assert JT.last_stats == JJT.last_stats
