"""PyTorch port: get_json_object's three engines -- the host oracle, the
per-row device scan and the structural-index tokenizer -- the router,
the multi-path entry (with its budget chunking) and the JNI door, held
byte for byte against the JAX package.

The cases are those of tests/test_json_device.py, test_json_uri_strings.py
(get_json_object), the tokenizer corpus of test_device_join_paths.py and
a seeded fuzz corpus of clickstream events with an edge vocabulary
(torch_port_data.JSON_EDGE_DOCS, invalid UTF-8 included).  Columns are
built from the same host arrays for both packages and compared on host
bytes: data, validity and offsets.  Every column the JAX device scan
reads is padded to one shape (ROWS x WIDTH), so the JAX package compiles
its scan once per path; each ends in an object row (see
test_tokenizer_reference_rejected_chunks for why).
"""

import numpy as np
import pytest

from spark_rapids_tpu.ops import json_device as JJD
from spark_rapids_tpu.ops import json_path as JJP
from spark_rapids_tpu.ops import json_tokenizer as JJT
from spark_rapids_tpu.perf import calibrate as Jcal
from spark_rapids_tpu.shim import jni_api as Jjni
from spark_rapids_tpu.shim.handles import REGISTRY as JREGISTRY
from spark_rapids_tpu_torch.ops import json_device as JD
from spark_rapids_tpu_torch.ops import json_path as JP
from spark_rapids_tpu_torch.ops import json_tokenizer as JT
from spark_rapids_tpu_torch.perf import calibrate
from spark_rapids_tpu_torch.shim import jni_api
from spark_rapids_tpu_torch.shim.handles import REGISTRY

from torch_port_data import (JSON_EDGE_DOCS, col_parts, jax_column,
                             json_event_docs, port_column, strings_spec)

ROWS = 384
WIDTH = 256
PAD_DOC = '{"pad": "' + "x" * (WIDTH - 11) + '"}'

BASIC = ['{"k": "v"}', '{"k1": {"k2": "v"}}', '{"a": 7}', '{"a": true}',
         '{"a": null}', '{"a": [1, 2]}', '{"a": {"x": 1, "y": "z"}}',
         '{"a": 1}', "not json", None]
ARRAYS = ['{"a": [{"b": 1}, {"b": 2}, {"c": 3}]}', '{"a": [{"b": "only"}]}',
          '{"a": [[1,2],[3]]}', '{"a": []}', '[1,2,3]',
          '{"a": [{"b": "x"}, {"b": "y"}]}']
TOLERANT = ["{'k': 'v'}", '{"k": "a\\nb"}', '{"k": "\\u0041"}',
            '{ "k" :  42 }', '{"k": 1.5e3}', '{"k" "v"}', '{"k":}',
            '{"k": 1,}', '[1 2]', '""', "''", '" x "', "{}", "[]",
            '  {"k": 3}  ', '\t[true]\n']
NUMBERS = ["[100.0,200.000,351.980]", "[12345678900000000000.0]", "[0.0]",
           "[-0.0]", "[-0]", "[12345678999999999999999999]",
           "[9.299999257686047e-0005603333574677677]",
           "9.299999257686047e0005603333574677677", "[1E308]",
           "[1.0E309,-1E309,1E5000]", "0.3", "0.03", "0.003", "0.0003",
           "0.00003"]
NUMBERS_WANT = ["[100.0,200.0,351.98]", "[1.23456789E19]", "[0.0]", "[-0.0]",
                "[0]", "[12345678999999999999999999]", "[0.0]", '"Infinity"',
                "[1.0E308]", '["Infinity","-Infinity","Infinity"]', "0.3",
                "0.03", "0.003", "3.0E-4", "3.0E-5"]
ZEROS = ["00", "01", "02", "000", "-01", "-00", "-02", "0", "-0", "0.5",
         "1e007", "1.", "-", ".5", "+1", "1e", "1e+", "01.5", "truex", "tru",
         "nul", "falsee"]
ESCAPES = ["{ \"a\": \"A\" }", "{'a':'A\"'}", "{'a':\"B'\"}",
           "['a','b','\"C\"']",
           "'\\u4e2d\\u56FD\\\"\\'\\\\\\/\\b\\f\\n\\r\\t\\b'"]
ESCAPES_WANT = ['{"a":"A"}', '{"a":"A\\""}', '{"a":"B\'"}',
                '["a","b","\\"C\\""]', '中国"\'\\/\b\f\n\r\t\b']
BRACKETS = ['{"a b": 5}', '{"a": {"b c": [10, 20]}}']
DEEP = ["[" * 40 + "1" + "]" * 40]
SURROGATES = ['{"a":"\\ud83d\\ude00"}', '{"a":"\\ud83d"}',
              '{"a":"\\udc00x"}', '{"a":"ok"}']
STRICT_HEX = ['{"a":"\\u 041"}', '{"a":"\\u0x41"}', '{"a":"\\u00_1"}',
              '{"a":"\\u0041"}']
ADVERSARIAL = [
    '{"a": 1, "b": "x"}',
    '{"a": {"b": {"c": [1, 2, {"d": "deep"}]}}}',
    '{"esc": "a\\"b\\\\c\\/d\\n\\t\\u0041"}',
    '{"a\\u0062c": 1}',                      # escaped KEY
    '{"dup": 1, "dup": 2}',
    '{"dup": 1, "dup": 2, "dup": 3}',
    '"just a string"', '42', '1e10', '1.5E-3', '12.', 'false', '', '   ',
    '{"n": -0.0, "m": 007}',                 # leading zeros (invalid)
    '{"a": [', '{"a": }', '{broken',
    '{"unterminated": "x',
    '{"ctrl": "a\tb"}',                      # raw control char in str
    '{"nested": ' + '[' * 20 + '1' + ']' * 20 + '}',   # > MAX_DEPTH
    '{"ws" :  { "a" : [ 1 , 2 ] } }',        # whitespace everywhere
    '{"num": 123456789012345678901234567890123}',    # overlong prim
    '{"b": "café 中文"}',
    '{"a": {}}', '  {"lead": 1}  ',
]

# every instruction kind, named access on arrays, bracket names
PATHS = ["$", "$.a", "$.a.b", "$.a[0]", "$.a[0].b", "$.a[*].b",
         "$.a['b c'][1]", "$.event", "$.user.id", "$.items[*].sku",
         "$.ctx.a.b.c"]


def _corpus():
    fixed = (BASIC + ARRAYS + TOLERANT + NUMBERS + ZEROS + ESCAPES + BRACKETS
             + DEEP + SURROGATES + STRICT_HEX + ADVERSARIAL + JSON_EDGE_DOCS)
    docs = fixed + json_event_docs(7, ROWS - 1 - len(fixed))
    return docs + [PAD_DOC]


CORPUS = _corpus()


def _both(values):
    spec = strings_spec(values)
    return jax_column(spec), port_column(spec)


@pytest.fixture(scope="module")
def corpus():
    assert len(CORPUS) == ROWS
    assert max(len(v if isinstance(v, bytes) else v.encode())
               for v in CORPUS if v is not None) == WIDTH
    return _both(CORPUS)


@pytest.fixture(autouse=True)
def _calib_file(tmp_path, monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_CALIB_CACHE",
                       str(tmp_path / "calib.json"))
    calibrate.forget()
    Jcal.forget()


def _same(got, want):
    assert col_parts(got) == col_parts(want)


def _same_text(got, want):
    """Equal as text: the engines differ only on invalid UTF-8, which
    the verbatim rows of the device engines pass through and the host
    oracle replaces by U+FFFD (as in the JAX package)."""
    assert got.to_pylist() == want.to_pylist()


def _stats(mine, ref):
    return {k: mine[k] for k in ref} == ref


@pytest.mark.parametrize("path", PATHS)
def test_engines_match_reference(corpus, path):
    """Each engine on the whole corpus: the port's == the JAX package's,
    with equal fallback counts, and the three port engines == each
    other."""
    jc, pc = corpus
    host = JP.get_json_object_host(pc, path)
    _same(host, JJP.get_json_object_host(jc, path))
    dev = JD.get_json_object_device(pc, path)
    _same(dev, JJD.get_json_object_device(jc, path))
    assert _stats(JD.last_stats, JJD.last_stats)
    assert JD.last_stats["chunk_steps"] == [WIDTH + 1]
    _same_text(dev, host)
    tok = JT.get_json_object_tokenized(pc, path)
    want = JJT.get_json_object_tokenized(jc, path)
    if want is None:
        assert tok is None
        return
    _same(tok, want)
    assert JT.last_stats == JJT.last_stats
    _same_text(tok, host)


CASES = {
    "basic": (BASIC, ["$.k", "$.k1.k2", "$.a", "$.b", "$.a.x"]),
    "arrays": (ARRAYS, ["$.a[0]", "$.a[0].b", "$.a[*].b", "$.a[9]", "$.a.b",
                        "$.a", "$[1]", "$[*]"]),
    "tolerant": (TOLERANT, ["$.k", "$"]),
    "numbers": (NUMBERS, ["$", "$[0]"]),
    "leading_zeros": (ZEROS, ["$"]),
    "escapes": (ESCAPES, ["$", "$.a"]),
    "brackets": (BRACKETS, ["$['a b']", "$.a['b c'][1]"]),
    "deep": (DEEP, ["$", "$[0]"]),
    "surrogates": (SURROGATES, ["$.a"]),
    "strict_hex": (STRICT_HEX, ["$.a"]),
    "tokenizer_corpus": (ADVERSARIAL, [
        "$.a", "$.a.b", "$.a.b.c[1]", "$.dup", "$.esc", "$.ws.a[0]",
        "$.nested", "$.num", "$.b", "$['a']", "$.a[1].b"]),
    "edge": (JSON_EDGE_DOCS, [
        "$.event", "$.ts", "$.user.name", "$.user.id", "$.items[0].price",
        "$.ctx", "$.items[*]", "bad path", "$..x"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cases_every_engine(name):
    """The vector families at their own shapes: the port's host and
    tokenizer engines == the JAX package's (fallback counts too), and
    the port's device scan == its host oracle."""
    docs, paths = CASES[name]
    jc, pc = _both(docs + ['{"pad": 0}'])
    for path in paths:
        host = JP.get_json_object_host(pc, path)
        _same(host, JJP.get_json_object_host(jc, path))
        _same_text(JD.get_json_object_device(pc, path), host)
        tok = JT.get_json_object_tokenized(pc, path)
        want = JJT.get_json_object_tokenized(jc, path)
        assert (tok is None) == (want is None)
        if want is not None:
            _same(tok, want)
            assert JT.last_stats == JJT.last_stats
            _same_text(tok, host)


@pytest.mark.parametrize("mode", ["host", "device", "tokenizer"])
def test_spark_vectors(mode, monkeypatch):
    """GetJsonObjectTest's expected values, through the public entry
    with each engine forced."""
    if mode == "tokenizer":
        monkeypatch.setenv("SPARK_RAPIDS_TPU_PATH_JSON_GET_OBJECT",
                           "tokenizer")
        monkeypatch.setattr(JP, "DEVICE_MIN_ROWS", 0)
    else:
        monkeypatch.setenv("SPARK_RAPIDS_TPU_JSON", mode)

    def run(docs, path):
        return JP.get_json_object(port_column(strings_spec(docs)),
                                  path).to_pylist()

    assert run(NUMBERS, "$") == NUMBERS_WANT
    assert run(ESCAPES, "$") == ESCAPES_WANT
    assert run(ZEROS[:7], "$") == [None] * 7
    assert run(["0", "-0", "0.5", "1e007"], "$") == \
        ["0", "0", "0.5", "1.0E7"]
    assert run(SURROGATES, "$.a") == ["😀", "�", "�x", "ok"]
    assert run(STRICT_HEX, "$.a") == [None, None, None, "A"]
    assert run(['{"a": {"x": 1, "y": "z"}}', '{"a": [1, 2]}', "x"],
               "$.a") == ['{"x":1,"y":"z"}', "[1,2]", None]
    assert run(['{"a": 1}'], "bad path") == [None]


@pytest.mark.parametrize("engine", ["host", "device_scan", "tokenizer"])
def test_router_pinned_engine(corpus, engine, monkeypatch):
    """get_json_object with the engine pinned by
    SPARK_RAPIDS_TPU_PATH_JSON_GET_OBJECT, in both packages."""
    jc, pc = corpus
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PATH_JSON_GET_OBJECT", engine)
    for path in ("$.user.id", "$.items[*].sku"):
        got = JP.get_json_object(pc, path)
        _same(got, JJP.get_json_object(jc, path))
        assert got.device == pc.device


def test_router_calibrates_on_the_column_device(monkeypatch):
    """Above the calibration floor the router times every engine on a
    sample and keeps the winner, keyed by the column's device; a
    declining engine is left out (_EngineDeclined), not timed as a
    success."""
    monkeypatch.setattr(JP, "JSON_CALIBRATE_MIN_ROWS", 8)
    monkeypatch.setattr(JP, "JSON_SAMPLE_ROWS", 8)
    pc = port_column(strings_spec(['{"a": %d}' % i for i in range(20)]))
    seen = {}

    def engine(name, out):
        def fn(c):
            seen.setdefault(name, []).append(c.length)
            return out(c)
        return fn

    engines = {"declines": engine("declines", lambda c: None),
               "host": engine("host",
                              lambda c: JP.get_json_object_host(c, "$.a"))}
    assert JP.route_json_engine("json.test", pc, engines, "declines",
                                extra="x") == "host"
    assert seen["host"][0] == 8 and seen["declines"] == [8]
    assert calibrate.last_verdict("json.test", "x|rb5|lb4",
                                  pc.device) == "host"
    # a pin wins without timing; small columns take the default
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PATH_JSON_TEST", "declines")
    assert JP.route_json_engine("json.test", pc, engines, "host") == \
        "declines"
    small = port_column(strings_spec(['{"a": 1}'] * 4))
    monkeypatch.delenv("SPARK_RAPIDS_TPU_PATH_JSON_TEST")
    assert JP.route_json_engine("json.test", small, engines, "x") == "x"


MULTI = ["$.event", "$.user.id", "$.a[0]", "$.nope", "bad"]


@pytest.mark.parametrize("engine", ["host", "device_scan", "tokenizer"])
def test_multiple_paths(corpus, engine, monkeypatch):
    """The multi-path entry with each engine, in both packages; the
    device scan shares one set of padded chunks across paths."""
    jc, pc = corpus
    if engine == "host":
        monkeypatch.setenv("SPARK_RAPIDS_TPU_JSON", "host")
    else:
        monkeypatch.setenv("SPARK_RAPIDS_TPU_PATH_JSON_GET_OBJECT", engine)
    outs = JP.get_json_object_multiple_paths(pc, MULTI)
    wants = JJP.get_json_object_multiple_paths(jc, MULTI)
    for got, want, path in zip(outs, wants, MULTI):
        _same(got, want)
        _same_text(got, JP.get_json_object_host(pc, path))


@pytest.mark.parametrize("budget", [
    dict(memory_budget_bytes=(2 * (WIDTH + 1) + 64) * (ROWS // 2)),
    dict(parallel_override=ROWS // 2)])
def test_multiple_paths_budget_device(budget):
    """memory_budget_bytes / parallel_override: the device scan runs on
    row slices, each padded on its own; results equal the unbudgeted
    ones and the JAX package's."""
    docs = CORPUS[:ROWS // 2 - 1] + [PAD_DOC] + CORPUS[ROWS // 2:]
    jc, pc = _both(docs)
    paths = ["$.event", "$.a"]
    want = JD.get_json_object_multiple_paths_device(pc, paths)
    got = JD.get_json_object_multiple_paths_device(pc, paths, **budget)
    ref = JJD.get_json_object_multiple_paths_device(jc, paths, **budget)
    for g, w, r in zip(got, want, ref):
        _same(g, w)
        _same(g, r)


@pytest.mark.parametrize("budget", [(2 * WIDTH, -1), (-1, 1), (-1, 2)])
def test_multiple_paths_budget_host(corpus, budget, monkeypatch):
    """The host evaluator parses every document once per chunk of paths
    that fits the budget; results equal the unbudgeted ones and the JAX
    package's."""
    jc, pc = corpus
    monkeypatch.setenv("SPARK_RAPIDS_TPU_JSON", "host")
    want = JP.get_json_object_multiple_paths(pc, MULTI)
    for g, r, w in zip(JP.get_json_object_multiple_paths(pc, MULTI, *budget),
                       JJP.get_json_object_multiple_paths(jc, MULTI, *budget),
                       want):
        _same(g, r)
        _same(g, w)


def test_device_fast_path_stays_on_device():
    """Compact machine JSON is copied verbatim: no host rows, in either
    package."""
    docs = ['{"name":"u%d","id":%d,"tags":["a","b"],"info":{"x":1}}'
            % (i, i) for i in range(64)]
    jc, pc = _both(docs)
    for path, want in (("$.name", [f"u{i}" for i in range(64)]),
                       ("$.info", ['{"x":1}'] * 64),
                       ("$.id", [str(i) for i in range(64)])):
        out = JD.get_json_object_device(pc, path)
        assert out.to_pylist() == want
        assert JD.last_stats["fallback_rows"] == 0
        assert JD.last_stats["device_rows"] == 64
        _same(JT.get_json_object_tokenized(pc, path),
              JJT.get_json_object_tokenized(jc, path))
        assert JT.last_stats["fallback_rows"] == 0


def test_device_scan_pads_each_chunk(monkeypatch):
    """Each DEVICE_ROW_CHUNK-row chunk pads to its own longest row: a
    long document lengthens only its own chunk's scan."""
    monkeypatch.setattr(JD, "DEVICE_ROW_CHUNK", 16)
    docs = ['{"a": %d}' % i for i in range(40)]
    docs[20] = '{"a": 1, "b": "' + "y" * 100 + '"}'
    pc = port_column(strings_spec(docs))
    out = JD.get_json_object_device(pc, "$.a")
    assert JD.last_stats["chunk_steps"] == [10, 118, 10]
    _same(out, JP.get_json_object_host(pc, "$.a"))


def test_tokenizer_row_chunks_and_validity(monkeypatch):
    """Row chunking and an input validity mask must not shift results."""
    docs = ['{"a": %d}' % i for i in range(50)] + [None, '{"a": 1}']
    jc, pc = _both(docs)
    monkeypatch.setattr(JT, "ROW_CHUNK", 16)
    monkeypatch.setattr(JJT, "ROW_CHUNK", 16)
    got = JT.get_json_object_tokenized(pc, "$.a")
    _same(got, JJT.get_json_object_tokenized(jc, "$.a"))
    _same(got, JP.get_json_object_host(pc, "$.a"))
    host_doc = ['{"a": 1}'] * 10 + ["{'host': 1}"]
    JT.get_json_object_tokenized(port_column(strings_spec(host_doc)), "$.a")
    assert JT.last_stats == {"rows": 11, "fallback_rows": 1,
                             "token_rows": 10}


@pytest.mark.parametrize("docs", [
    ['{"a": 1}', ""], ['{"a": 1}', None], ["42", "1"], [None, None],
    ["", ""], ['{"a": [1]}', "", "", None]])
def test_tokenizer_reference_rejected_chunks(docs):
    """Chunks the JAX package's tokenizer raises IndexError on (a chunk
    that ends in empty rows after a token, or holds no token at all --
    ROADMAP Queue C): the port's tokenizer == its host oracle and == the
    JAX package's host oracle."""
    jc, pc = _both(docs)
    for path in ("$.a", "$.a[0]"):
        got = JT.get_json_object_tokenized(pc, path)
        _same(got, JP.get_json_object_host(pc, path))
        _same(got, JJP.get_json_object_host(jc, path))


def test_jni_door():
    """get_json_object through the handle API, in both packages; every
    handle released."""
    docs = ['{"a": {"b": 5}}', None, '{"a": {"b": [1.50]}}', "x"]
    start = REGISTRY.live_count()
    jstart = JREGISTRY.live_count()
    jc, pc = _both(docs)
    h, jh = REGISTRY.register(pc), JREGISTRY.register(jc)
    out = jni_api.get_json_object(h, "$.a.b")
    jout = Jjni.get_json_object(jh, "$.a.b")
    try:
        _same(REGISTRY.get(out), JREGISTRY.get(jout))
        assert jni_api.column_to_host(out) == ["5", None, "[1.5]", None]
        assert REGISTRY.get(out).device.type == "cpu"
    finally:
        for hh in (h, out):
            jni_api.release_column(hh)
        for hh in (jh, jout):
            JREGISTRY.release(hh)
    assert REGISTRY.live_count() == start
    assert JREGISTRY.live_count() == jstart


def test_fuzz_corpus_seeds():
    """A second seeded corpus at a smaller width: every engine == the
    host oracle, the tokenizer == the JAX package's."""
    docs = json_event_docs(23, 200, edge_every=4) + [PAD_DOC[:60] + '"}']
    jc, pc = _both(docs)
    for path in ("$.user.name", "$.items[1].price", "$.ctx.a", "$.ts"):
        host = JP.get_json_object_host(pc, path)
        _same(host, JJP.get_json_object_host(jc, path))
        _same_text(JD.get_json_object_device(pc, path), host)
        _same(JT.get_json_object_tokenized(pc, path),
              JJT.get_json_object_tokenized(jc, path))
        assert JT.last_stats == JJT.last_stats
    assert np.count_nonzero([d is None for d in docs]) > 0


def test_scan_steps_with_a_device_index(monkeypatch):
    """The scans' CUDA-graph form -- the char index a (1,) tensor, the
    carry written into fixed buffers -- run step by step on the CPU:
    the same bytes as the plain loop."""
    import torch

    from spark_rapids_tpu_torch.ops import raw_map_device as RM

    docs = json_event_docs(3, 120, edge_every=4) + ['{"a": 1, "b": 2.5}']
    pc = port_column(strings_spec(docs))

    def run():
        return ([JD.get_json_object_device(pc, p) for p in
                 ("$.user.id", "$.items[0]", "$.items[*].sku", "$")]
                + [RM.from_json_to_raw_map_device(pc)])

    want = run()

    def run_steps(step, steps, device):
        for j in range(steps):
            step(torch.tensor([j]), True)

    monkeypatch.setattr(JD, "run_steps", run_steps)
    monkeypatch.setattr(RM, "run_steps", run_steps)
    for got, w in zip(run(), want):
        _same(got, w)


def _rand_json(rng, depth=0):
    r = rng.random()
    if depth > 3 or r < 0.25:
        return rng.choice(
            [1, -5, 0, 3.25, 1e3, True, False, None, "s", "a b",
             'q"x', 17, 123456789012345678901234567890])
    if r < 0.55:
        return {rng.choice("abcde"): _rand_json(rng, depth + 1)
                for _ in range(rng.randrange(4))}
    return [_rand_json(rng, depth + 1) for _ in range(rng.randrange(4))]


def test_differential_fuzz_of_the_device_tests():
    """test_json_device.py's differential fuzz (single quotes, spaced
    colons, cut tails): the port's host and tokenizer engines == the
    JAX package's, its device scan == its host oracle."""
    import json
    import random

    rng = random.Random(7)
    docs = []
    for _ in range(300):
        s = json.dumps(_rand_json(rng))
        if rng.random() < 0.3:
            s = s.replace('"', "'")
        if rng.random() < 0.2:
            s = " " + s.replace(":", " : ") + "  "
        if rng.random() < 0.1:
            s = s[: max(1, len(s) - 2)]   # corrupt tail
        docs.append(s)
    docs += [None, "", "{", "}", "[[]", '{"a"}', '{"a":1 2}', '{"end": 1}']
    jc, pc = _both(docs)
    for path in ["$", "$.a", "$.a.b", "$.a[0]", "$.a[*]", "$[0]", "$.b.c",
                 "$['a']", "$.a[1].b"]:
        host = JP.get_json_object_host(pc, path)
        _same(host, JJP.get_json_object_host(jc, path))
        _same(JD.get_json_object_device(pc, path), host)
        tok = JT.get_json_object_tokenized(pc, path)
        want = JJT.get_json_object_tokenized(jc, path)
        assert (tok is None) == (want is None)
        if want is not None:
            _same(tok, want)
            assert JT.last_stats == JJT.last_stats
            _same(tok, host)
