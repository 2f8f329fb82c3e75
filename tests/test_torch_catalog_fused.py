"""PyTorch port: the catalog's single-stage plans (q3, q9, q67, cube,
q89) in the fused engine — one compiled program per stage — against the
JAX package's fused run and the port's op-by-op walk on the same data,
byte for byte.  A file of its own: each plan compiles cold (seconds
each with inductor's C++ backend), so these share a worker with nothing
heavy."""

import os

os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import pytest  # noqa: E402

from spark_rapids_tpu.models import tpcds as JT  # noqa: E402
from spark_rapids_tpu.plan import catalog as JC  # noqa: E402
from spark_rapids_tpu_torch.models import tpcds as TT  # noqa: E402
from spark_rapids_tpu_torch.plan import catalog as TC  # noqa: E402
from spark_rapids_tpu_torch.plan.compiler import \
    compile_stage  # noqa: E402
from torch_port_data import CATALOG_CASES, same_outputs  # noqa: E402

PLANS = {"q3": lambda: TC.q3_plan(10_957, 3, 8, 2),
         "q9": TC.q9_plan, "q67": lambda: TC.q67_plan(6, 5),
         "cube": lambda: TC.cube_plan(4, 3),
         "q89": lambda: TC.q89_plan(9, 400)}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_fused_matches_reference_and_op_by_op(name, monkeypatch):
    gen, kw, run = CATALOG_CASES[name]
    ref, ours = getattr(JT, gen)(**kw), getattr(TT, gen)(device="cpu", **kw)
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "1")
    want = run(JC, ref)
    stage = compile_stage(PLANS[name]())
    before = stage.compiles
    fused = run(TC, ours)
    same_outputs(fused, want)
    same_outputs(run(TC, ours), want)     # the same program again
    assert stage.compiles - before <= 1
    assert len(stage.compile_seconds) == 1
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    same_outputs(run(TC, ours), fused)
