"""PyTorch port: the file-backed TPC-DS runners (models/filesource and
the catalog's tpcds_q3_file, tpcds_q7_file, tpcds_q9_file) against the
port's in-memory twins and against the JAX package's file runners in one
SPARK_RAPIDS_TPU_INGEST_DIR: a dataset either package wrote is read by
the other, the files the two write are the same bytes, and the rows are
equal."""

import os

import pytest

pytest.importorskip("pyarrow")

import spark_rapids_tpu.models as JM  # noqa: E402
import spark_rapids_tpu_torch.models as TM  # noqa: E402
from spark_rapids_tpu.models import filesource as JFS  # noqa: E402
from spark_rapids_tpu_torch.io import parquet_reader as PR  # noqa: E402
from spark_rapids_tpu_torch.models import filesource as FS  # noqa: E402

FILE_NAMES = ["tpcds_q3_file", "tpcds_q7_file", "tpcds_q9_file"]
PARAMS = [{"rows": 512, "seed": 3}, {"rows": 3001, "seed": 1}]


@pytest.fixture
def ingest_dir(tmp_path, monkeypatch):
    """One dataset directory for both packages, forgotten afterwards."""
    monkeypatch.setenv("SPARK_RAPIDS_TPU_INGEST_DIR", str(tmp_path))
    monkeypatch.setenv("SPARK_RAPIDS_TPU_STAGE_FUSION", "0")
    FS.reset_dir()
    JFS.reset_dir()
    yield tmp_path
    FS.reset_dir()
    JFS.reset_dir()


def _cpu(params):
    return dict(params, device="cpu")


def test_file_names_are_registered():
    assert set(FILE_NAMES) <= set(TM.catalog_queries())
    assert set(FILE_NAMES) <= set(JM.catalog_queries())


@pytest.mark.parametrize("name", FILE_NAMES)
@pytest.mark.parametrize("params", PARAMS)
def test_file_rows_equal_in_memory_twin(ingest_dir, name, params):
    got = TM.run_catalog_query(name, _cpu(params))
    assert got == TM.run_catalog_query(name[:-len("_file")], _cpu(params))
    stem = name[len("tpcds_"):-len("_file")] + "_r"
    assert any(n.startswith(stem) for n in os.listdir(ingest_dir))


@pytest.mark.parametrize("name", FILE_NAMES)
def test_port_reads_the_files_jax_wrote(ingest_dir, name):
    params = {"rows": 1000, "seed": 5}
    want = JM.run_catalog_query(name, params)
    written = sorted(os.listdir(ingest_dir))
    got = TM.run_catalog_query(name, _cpu(params))
    assert sorted(os.listdir(ingest_dir)) == written   # nothing rewritten
    assert got == want


@pytest.mark.parametrize("name", FILE_NAMES)
def test_jax_reads_the_files_port_wrote(ingest_dir, name):
    params = {"rows": 700, "seed": 6}
    got = TM.run_catalog_query(name, _cpu(params))
    written = sorted(os.listdir(ingest_dir))
    assert JM.run_catalog_query(name, params) == got
    assert sorted(os.listdir(ingest_dir)) == written


def test_both_packages_write_the_same_bytes(tmp_path, monkeypatch):
    """Same seeded data, same pyarrow writer: identical files."""
    dirs = {}
    for pkg, runner, fs in (("port", TM, FS), ("jax", JM, JFS)):
        d = tmp_path / pkg
        monkeypatch.setenv("SPARK_RAPIDS_TPU_INGEST_DIR", str(d))
        fs.reset_dir()
        for name in FILE_NAMES:
            params = {"rows": 600, "seed": 2}
            runner.run_catalog_query(
                name, _cpu(params) if pkg == "port" else params)
        fs.reset_dir()
        dirs[pkg] = d
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"])) and len(names) == 8
    for n in names:
        assert (dirs["port"] / n).read_bytes() == \
            (dirs["jax"] / n).read_bytes(), n


def test_runner_honours_device_and_cancel(ingest_dir):
    import threading
    ev = threading.Event()
    ev.set()
    for name in FILE_NAMES:
        with pytest.raises(TM.QueryCancelled):
            TM.run_catalog_query(name, {"device": "cpu"},
                                 TM.QueryContext(cancel_event=ev))
    assert os.listdir(ingest_dir) == []
    rows = TM.run_catalog_query("tpcds_q9_file",
                                {"rows": 64, "device": "cpu"})
    assert sum(r[0] for r in rows) == 64   # every quantity in a bucket
    stats = {}
    PR.read_table(os.path.join(ingest_dir, "q9_r64_s9_store_sales.parquet"),
                  device="cpu", stats=stats)
    assert stats["rows"] == 64 and stats["columns"] == 3


def test_write_once_per_signature(ingest_dir):
    TM.run_catalog_query("tpcds_q9_file", {"rows": 100, "device": "cpu"})
    path = os.path.join(ingest_dir, "q9_r100_s9_store_sales.parquet")
    mtime = os.stat(path).st_mtime_ns
    FS.reset_dir()
    TM.run_catalog_query("tpcds_q9_file", {"rows": 100, "device": "cpu"})
    assert os.stat(path).st_mtime_ns == mtime


def test_ingest_phase_rehearsal_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's ingest phase on CPU tensors at small sizes: the
    reads against their sources, the JNI door, the file queries against
    their twins and the datetime ops against the CPU prefix."""
    import chip_smoke as C
    monkeypatch.setattr(C, "ingest_dir", lambda: str(tmp_path / "ingest"))
    res = C.ingest_phase(
        "cpu",
        files_kw=dict(rows=1 << 13, str_rows=1 << 12, cut_rows=1 << 11,
                      row_group=1 << 11),
        queries={"tpcds_q3_file": dict(rows=4096, seed=3),
                 "tpcds_q7_file": {}, "tpcds_q9_file": dict(rows=4096)},
        dt_kw=dict(rows=1 << 13, cpu_rows=1 << 11, iters=1))
    files = res["files"]
    assert files["store_sales_dict"]["projected"]["read_mb"] < \
        files["store_sales_dict"]["whole"]["read_mb"]
    assert files["cut_plain_v2"]["whole"]["pages"] >= 6
    assert files["store_sales_snappy"]["whole"]["decompress_ms"] > 0
    assert files["store_sales_dict"]["whole"]["decompress_ms"] == 0
    assert res["jni_door"]["parquet_read_table"]["handles"] == 6
    assert res["queries"]["tpcds_q3_file"]["result_rows"] > 0
    assert res["datetime"]["truncate_ts column"]["ms"] > 0
    assert not (tmp_path / "ingest").exists()
