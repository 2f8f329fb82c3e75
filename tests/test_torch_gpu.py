"""PyTorch port on the card: each CUDA kernel byte for byte against its
plain version (with chip_smoke.py's tables and comparisons), launch
counts, the wrappers' input checks, the flagship step and the JNI-door
entries against the CPU, and the TPC-DS stage path (q5, q72) in both
engines against its CPU run.

Marked `gpu`; each test skips without a CUDA device (decided in the
`cuda` fixture, never at import).  The file imports no JAX, so on a GPU
host without JAX it runs alone:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from chip_smoke import (KERNEL_CASES, VAR_KERNEL_CASES, compare_kernels,
                        compare_var_kernel, make_table, string_host_specs)
from spark_rapids_tpu_torch.columns import dtypes, interop
from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.models import flagship as F
from spark_rapids_tpu_torch.models import tpcds as TT
from spark_rapids_tpu_torch.ops import row_assembly_cuda as RA
from spark_rapids_tpu_torch.ops import row_conversion as RC
from spark_rapids_tpu_torch.plan import catalog as TC
from spark_rapids_tpu_torch.shim import jni_api


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,ncols,nullable_every,dec128_every,view_offset",
    KERNEL_CASES + [(300, 5, 3, 2, 0), (300, 5, 3, 2, 3)])
def test_kernels_match_plain_versions(cuda, rows, ncols, nullable_every,
                                      dec128_every, view_offset):
    t = make_table(rows, ncols, "cuda", seed=rows + ncols,
                   nullable_every=nullable_every, dec128_every=dec128_every,
                   view_offset=view_offset)
    RA.reset_launches()
    assert compare_kernels(t) == (0, 0)
    assert RA.LAUNCHES == {"to_rows": 1, "from_rows": 1, "to_rows_var": 0}


@pytest.mark.gpu
def test_flagship_step_on_card_matches_cpu(cuda):
    got = F.flagship_step(*F.example_inputs(4097, device=cuda))
    want = F.flagship_step(*F.example_inputs(4097, device="cpu"))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.gpu
def test_kernel_wrappers_check_their_inputs(cuda):
    t = make_table(16, 2, "cuda", seed=18)
    starts, voff, _ = RC.compute_layout([c.dtype for c in t.columns])
    strided = torch.zeros(32, dtype=torch.int64, device=cuda)[::2]
    bad = Column(dtypes.INT64, 16, data=strided)
    with pytest.raises(ValueError):
        RA.assemble_rows([bad, t.columns[1]], starts, voff, 16)
    with pytest.raises(ValueError):
        RA.disassemble_rows(torch.zeros(20, dtype=torch.uint8, device=cuda),
                            [dtypes.INT64], [0], 8, 16)


@pytest.mark.gpu
def test_to_rows_takes_columns_off_16_byte_alignment(cuda):
    """A column whose base is aligned to its width but not to 16 bytes (a
    view into a longer buffer) is taken, not refused."""
    t = make_table(37, 9, "cuda", seed=4, nullable_every=2, dec128_every=4,
                   view_offset=1)
    assert any(c.data.data_ptr() % 16 for c in t.columns)
    schema = [c.dtype for c in t.columns]
    starts, voff, _ = RC.compute_layout(schema)
    row_size = RC.row_size_of(schema)
    RA.reset_launches()
    got = RA.assemble_rows(t.columns, starts, voff, row_size)
    assert RA.LAUNCHES["to_rows"] == 1
    want = RA.assemble_rows_plain(t.columns, starts, voff, row_size)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "rows,ncols,first,nullable_every,dec128_every,skew,max_len",
    VAR_KERNEL_CASES + [(0, 12, 0, 3, 0, 0, 32), (513, 4, 6, 2, 3, 9, 32)])
def test_var_kernel_matches_plain_version(cuda, rows, ncols, first,
                                          nullable_every, dec128_every,
                                          skew, max_len):
    t = interop.table_from_host(string_host_specs(
        rows, ncols, seed=rows + ncols, first=first,
        nullable_every=nullable_every, dec128_every=dec128_every,
        skew=skew, max_len=max_len), device=cuda)
    RA.reset_launches()
    assert compare_var_kernel(t) == 0
    assert RA.LAUNCHES["to_rows_var"] == (1 if rows else 0)


@pytest.mark.gpu
def test_jni_door_on_card_matches_cpu(cuda):
    specs = string_host_specs(999, 23, seed=5, dec128_every=7, skew=2)
    kinds = [s[0] for s in specs]
    scales = [0] * len(specs)
    out = {}
    for dev in (cuda, "cpu"):
        hs = [jni_api.REGISTRY.register(c) for c in
              interop.table_from_host(specs, device=dev).columns]
        mm = jni_api.murmur_hash3_32(42, hs[:7])
        xx = jni_api.xx_hash_64(42, hs[:7])
        rows = jni_api.convert_to_rows(hs)
        back = jni_api.convert_from_rows(rows, kinds, scales)
        out[str(dev)] = [jni_api.column_to_host(h)
                         for h in [mm, xx, rows] + back]
        for h in hs + [mm, xx, rows] + back:
            jni_api.release_column(h)
    assert out["cuda"] == out["cpu"]


@pytest.mark.gpu
def test_var_wrapper_checks_its_inputs(cuda):
    t = interop.table_from_host(string_host_specs(16, 7, seed=3), cuda)
    cols = t.columns
    starts, voff, fixed = RC.compute_layout([c.dtype for c in cols])
    offsets, total = RC.var_row_offsets(cols, fixed)
    s = cols[6]
    bad_cols = [
        Column(dtypes.STRING, 16, data=s.data,
               offsets=s.offsets.to(torch.int64)),        # offsets type
        Column(dtypes.STRING, 16, data=s.data,
               offsets=s.offsets[:-1]),                    # offsets shape
        Column(dtypes.STRING, 16, data=s.data.view(torch.int8),
               offsets=s.offsets),                         # chars type
        Column(dtypes.STRING, 16, data=s.data.cpu(),
               offsets=s.offsets),                         # chars device
    ]
    for bad in bad_cols:
        with pytest.raises(ValueError):
            RA.assemble_var_rows(cols[:6] + [bad], starts, voff, fixed,
                                 offsets, total)
    with pytest.raises(ValueError):
        RA.assemble_var_rows(cols, starts, voff, fixed,
                             offsets.to(torch.int64), total)


@pytest.mark.gpu
@pytest.mark.parametrize("fusion", ["1", "0"])
def test_stage_path_on_card_matches_cpu(cuda, fusion, monkeypatch):
    """q5 and q72 at the CPU tests' sizes (tests/test_torch_tpcds.py):
    on the card, fused or op by op, byte-equal to the op-by-op run on the
    CPU."""
    week0 = 11_000 // 7

    def q5(device):
        d = TT.gen_q5(rows=4000, stores=16, days=60, device=device)
        return TC.run_q5(d, 16, 1 << 13)

    def q72(device):
        d = TT.gen_q72(cs_rows=3000, inv_rows=3000, items=64, days=35,
                       device=device)
        return TC.run_q72(d, 64, 16, 1 << 18, week0=week0)

    for query in (q5, q72):
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
        want = query("cpu")
        monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", fusion)
        got = query(cuda)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.device.type == "cuda" and g.dtype == w.dtype
            assert torch.equal(g.cpu(), w)
