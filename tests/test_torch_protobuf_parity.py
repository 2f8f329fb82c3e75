"""The port's protobuf engine (ops/protobuf_device.py) on CPU tensors
byte for byte against the JAX package's engine on the same wire bytes:
every differential case of tests/test_protobuf_device.py and its seeded
fuzz corpora, at the default chunk and at a 3-row chunk.  Both engines
keep what they captured under null rows, so the buffers agree there
too.  (Kept apart from test_torch_protobuf.py: the JAX engine compiles
once per schema and shape.)"""

import numpy as np
import pytest

from spark_rapids_tpu.ops import protobuf_device as jpd
from spark_rapids_tpu_torch.ops import protobuf_device as tpd
from test_torch_protobuf import (DEVICE_CASES, FLAT_FIELDS, NESTED,
                                 REP_FIELDS, columns, fuzz_flat,
                                 fuzz_nested, fuzz_repeated, port_fields)
from torch_port_data import col_parts


def same_engine_bytes(msgs, fields, monkeypatch):
    jc, tc = columns(msgs)
    want = col_parts(jpd.decode_protobuf_to_struct_device(jc, fields))
    tf = port_fields(fields)
    assert col_parts(tpd.decode_protobuf_to_struct_device(tc, tf)) == want
    monkeypatch.setattr(tpd, "DEVICE_ROW_CHUNK", 3)
    assert col_parts(tpd.decode_protobuf_to_struct_device(tc, tf)) == want


@pytest.mark.parametrize("case", sorted(DEVICE_CASES))
def test_engine_bytes_equal_jax(case, monkeypatch):
    msgs, fields = DEVICE_CASES[case]
    same_engine_bytes(msgs, fields, monkeypatch)


@pytest.mark.parametrize("name,make,seed,fields", [
    ("flat", fuzz_flat, 7, FLAT_FIELDS),
    ("nested", fuzz_nested, 41, NESTED),
    ("repeated", fuzz_repeated, 77, REP_FIELDS)])
def test_fuzz_engine_bytes_equal_jax(name, make, seed, fields, monkeypatch):
    same_engine_bytes(make(np.random.default_rng(seed)), fields,
                      monkeypatch)
