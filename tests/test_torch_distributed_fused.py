"""Distributed q5 in the fused engine (the runner's main path: the
map and reduce sides as plan/catalog's compiled stages) with two ranks
in one process over unix sockets, byte-equal to the JAX package's
single-process q5; and the elastic runner on the same two ranks.  Kept
apart from test_torch_distributed.py: each stage compiles with
inductor's C++ backend here (about half a minute)."""

import os
import threading

import numpy as np
import pytest

from spark_rapids_tpu_torch.shuffle import kudo


@pytest.fixture
def crc_on():
    prior = kudo.set_crc_enabled(True)
    yield
    kudo.set_crc_enabled(prior)


def _pair(tmp_path, fn, elastic=False):
    from spark_rapids_tpu_torch.distributed.service import ShuffleService
    addrs = [f"unix:{os.path.join(str(tmp_path), f'f{r}.sock')}"
             for r in range(2)]
    svcs = [ShuffleService(r, 2, addrs, elastic=elastic).start()
            for r in range(2)]
    outs, errs = [None, None], [None, None]

    def work(r):
        try:
            outs[r] = fn(svcs[r])
        except Exception as e:  # noqa: BLE001
            errs[r] = e

    ts = [threading.Thread(target=work, args=(r,)) for r in range(2)]
    try:
        [t.start() for t in ts]
        [t.join(240) for t in ts]
    finally:
        for s in svcs:
            s.stop()
    assert errs == [None, None], errs
    return outs


def test_q5_fused_two_ranks_byte_equal_jax_single(tmp_path, crc_on,
                                                  monkeypatch):
    from spark_rapids_tpu.distributed import runner as JR
    from spark_rapids_tpu_torch.distributed import runner as R
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    params = dict(rows=1024, join_capacity=1 << 12)
    ref = JR.single_q5(dict(params, world=2))
    for fn, elastic in ((R.run_dist_q5, False), (R.run_elastic_q5, True)):
        outs = _pair(tmp_path, lambda s, fn=fn: fn(
            params, transport=s, device="cpu"), elastic)
        for r in range(2):
            for k in ("key", "sales", "rets", "profit"):
                assert outs[r][k].tobytes() == np.asarray(
                    ref[k]).tobytes(), (fn.__name__, r, k)
