"""PyTorch port: chip_smoke.py's step 23 (the mesh programs) rehearsed
on the CPU at a small size: M1 through the JVM door's mesh entries with
the entries on the CPU (one gloo rank), M2 on two gloo CPU ranks
(op by op: the fused mesh program has its own tests).  Every check of
the step runs; what the card alone shows (NCCL, gloo over CUDA
tensors) is its `gpu` tests' and the step's own."""

import chip_smoke as C
from spark_rapids_tpu_torch.shim import jni_entry as J
from spark_rapids_tpu_torch.shim import jni_mesh
from spark_rapids_tpu_torch.utils import platform


def test_mesh_phase_rehearsal_on_cpu(monkeypatch):
    monkeypatch.setenv("SPARK_RAPIDS_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("SPARK_RAPIDS_TPU_CPU_DEVICES", raising=False)
    J._INITIALIZED = False
    try:
        m1 = C.mesh_m1("cpu", C.MESH_M1_SMALL)
        m2 = C.mesh_m2("cpu", dict(C.MESH_M2_SMALL, fused=False))
    finally:
        jni_mesh.stop_pools()
        J._INITIALIZED = False
        platform.set_entry_device("cuda")
    assert m1["backend"] == "gloo" and not jni_mesh._POOLS
    # each entry call's rank counted its own row-kernel launches
    assert m1["launches"] == [{"to_rows": 0, "from_rows": 0,
                               "to_rows_var": 0}] * 4
    first, warm = m1["q5"]["ranks"][0], m1["q5"]["warm_ranks"][0]
    assert first["doublings"] >= 1 and warm["doublings"] == 0
    assert first["capacity"] == warm["capacity"]
    assert m2["backend"] == "gloo"
    for r, res in enumerate(m2["ranks"]):
        assert res["rank"] == r
        assert res["exchange"]["all_to_all"] == 3
        assert res["join"]["doublings"] >= 1
        assert res["join"]["capacity"] == m2["ranks"][0]["join"]["capacity"]
        # q5's five partials and the collective retry's agreement
        assert res["q5"]["all_reduce"] == 6
        assert res["launches"] == {"to_rows": 0, "from_rows": 0,
                                   "to_rows_var": 0}
    rows = C.MESH_M2_SMALL["exchange_rows"] * 2
    assert sum(r["exchange"]["rows"] for r in m2["ranks"]) == rows
    assert sum(r["aggregate"]["rows"] for r in m2["ranks"]) == rows
