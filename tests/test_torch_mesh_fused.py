"""PyTorch port: the fused mesh programs (plan/catalog
``make_q5_multichip_fused`` / ``make_q72_multichip_fused`` over
compiler.fused_pipeline_fn), held against the JAX package's fused
shard_map programs and the port's op-by-op mesh programs on the same
shards, at the sizes of tests/test_stage_fusion.py's TestMeshFused.

What is asserted per rank: ONE graph compiled for the whole pipeline
(the JAX test asserts one XLA program per rank).  The Reduce seam's
all_reduces are functional collectives, which torch.compile traces
into the graph, so the seam does not split it; the program counts its
all_reduces (one per Reduce node) into the rank's mesh stats.  The
R = 2 and R = 4 pools compile at once, on separate processes.
"""

import os

os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

from concurrent.futures import ThreadPoolExecutor  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from jax.sharding import Mesh as JMesh  # noqa: E402

import torch_mesh_ranks as MR  # noqa: E402
from torch_port_data import same_outputs  # noqa: E402
from spark_rapids_tpu.models import tpcds as JT  # noqa: E402
from spark_rapids_tpu.plan import catalog as JC  # noqa: E402
from spark_rapids_tpu_torch.distributed.pool import RankPool  # noqa: E402

RANKS = (2, 4)
STORES = 16
ITEMS = 64
MAX_WEEK = 16
WEEK0 = 11_000 // 7


def q5_args():
    rows = 4096
    d = JT.gen_q5(rows=rows, stores=STORES, days=60)
    cut = rows // 8 * 8
    d = d._replace(r_date=d.r_date[:cut], r_store=d.r_store[:cut],
                   r_amt=d.r_amt[:cut], r_loss=d.r_loss[:cut])
    return [np.asarray(x) for x in d]


def q72_args():
    d = JT.gen_q72(cs_rows=2048, inv_rows=2048, items=ITEMS, days=35)
    return [np.asarray(x) for x in d]


CASES = {
    "q5": (q5_args, dict(stores=STORES, join_capacity=1 << 11),
           lambda m: JC.make_q5_multichip_fused(m, STORES, 1 << 11), 5),
    "q72": (q72_args, dict(items=ITEMS, max_week=MAX_WEEK,
                           join_capacity=1 << 16, week0=WEEK0),
            lambda m: JC.make_q72_multichip_fused(
                m, ITEMS, MAX_WEEK, 1 << 16, week0=WEEK0), 2),
}


def run_pool(n):
    """Every fused case on one n-rank pool: {query: (rank results, JAX
    fused outputs)}."""
    out = {}
    with RankPool(n, device="cpu", timeout_s=240) as pool:
        for name, (make_args, params, jax_fused, _) in CASES.items():
            args = make_args()
            want = jax_fused(JMesh(np.array(jax.devices()[:n]),
                                   ("data",)))(*args)
            got = pool.run(MR.fused_rank, name, args, params,
                           timeout_s=480)
            out[name] = (got, [np.asarray(w) for w in want])
    return out


@pytest.fixture(scope="module")
def results():
    """Every (R, query) case; the R = 2 and R = 4 pools at once."""
    with ThreadPoolExecutor(len(RANKS)) as ex:
        futures = {n: ex.submit(run_pool, n) for n in RANKS}
        return {(n, name): res for n, f in futures.items()
                for name, res in f.result().items()}


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n", RANKS)
def test_fused_mesh_program_equals_jax_and_op_by_op(results, n, name):
    ranks, want = results[(n, name)]
    for fused, op_by_op, _graphs, _reduces in ranks:
        same_outputs(fused, want)
        same_outputs(op_by_op, want)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n", RANKS)
def test_one_graph_per_rank(results, n, name):
    ranks, _ = results[(n, name)]
    reduces = CASES[name][3]
    assert [(graphs, all_reduces) for _f, _o, graphs, all_reduces
            in ranks] == [(1, reduces)] * n
