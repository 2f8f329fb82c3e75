"""File-backed TPC-DS runners: the catalog's storage-to-shuffle path.

The in-memory runners (models/__init__) generate device tensors from a
seed; the ``*_file`` variants here write the SAME seeded data to
parquet ONCE per session per parameter signature, then run every
query file -> ``io/parquet_reader`` -> device columns -> the SAME
cached pipeline (same ``_pipeline`` key, so both variants share one
pipeline).  Because the parquet round trip of int32 / int64 / bool
values is exact, a file-backed query is byte-identical to its
in-memory twin.  The file names and their signatures are the JAX
package's, so a dataset either package wrote in one
``SPARK_RAPIDS_TPU_INGEST_DIR`` is read by the other.  Each runner
reads ``params["device"]`` (default ``"cuda"``) for where the columns
land and the pipeline runs; the files are written with pyarrow.

Layout per query (projection pushdown exercised on every read):

  q3: store_sales(ss_sold_date_sk, ss_item_sk, ss_ext_sales_price),
      date_dim(d_moy, d_year), item(i_brand_id, i_manufact_id)
  q7: store_sales(7 cols), customer_demographics(cd_match),
      promotion(p_match), item(i_item_id)
  q9: store_sales(ss_quantity, ss_ext_list_price, ss_net_profit)

``SPARK_RAPIDS_TPU_INGEST_DIR`` pins the dataset directory (default:
one mkdtemp per process).  The files are written uncompressed, as the
JAX package writes them by default, so both packages write the same
bytes; the reader decodes any codec pyarrow ships.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Dict, Optional

import numpy as np
import torch

_LOCK = threading.Lock()
_DIR: Optional[str] = None
_WRITTEN: Dict[str, bool] = {}


def data_dir() -> str:
    """The session's parquet dataset directory (created on first use;
    ``SPARK_RAPIDS_TPU_INGEST_DIR`` overrides for shared fixtures)."""
    global _DIR
    with _LOCK:
        if _DIR is None:
            _DIR = os.environ.get("SPARK_RAPIDS_TPU_INGEST_DIR") or \
                tempfile.mkdtemp(prefix="srt-ingest-")
        os.makedirs(_DIR, exist_ok=True)
        return _DIR


def reset_dir() -> None:
    """Forget the cached directory + written set (tests repoint the
    env knob between cases)."""
    global _DIR
    with _LOCK:
        _DIR = None
        _WRITTEN.clear()


def _write_once(name: str, build) -> str:
    """Write ``build()`` (a pyarrow Table) to ``<dir>/<name>.parquet``
    exactly once per signature: atomic tmp+rename, so concurrent pool
    threads (or processes sharing INGEST_DIR) race benignly."""
    path = os.path.join(data_dir(), name + ".parquet")
    with _LOCK:
        if _WRITTEN.get(path) or os.path.exists(path):
            _WRITTEN[path] = True
            return path
    import pyarrow.parquet as pq
    table = build()
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    pq.write_table(table, tmp, compression="NONE")
    os.replace(tmp, path)
    with _LOCK:
        _WRITTEN[path] = True
    return path


def _pa_table(cols: Dict[str, np.ndarray]):
    import pyarrow as pa
    return pa.table({k: pa.array(np.asarray(v)) for k, v in cols.items()})


def _host(a) -> np.ndarray:
    return a.cpu().numpy()


def _read(path: str, columns, device):
    from spark_rapids_tpu_torch.io.parquet_reader import read_table
    return read_table(path, columns=list(columns), device=device)


def _bool(col):
    # BOOL8 columns decode as uint8; the in-memory generators hand the
    # pipeline bool tensors, and its torch.where conditions need bool
    return col.data.to(torch.bool)


# ------------------------------------------------------------------ q3


def q3_paths(rows: int, items: int, days: int, brands: int,
             seed: int) -> Dict[str, str]:
    from spark_rapids_tpu_torch.models import tpcds
    sig = f"q3_r{rows}_i{items}_d{days}_b{brands}_s{seed}"
    d = [None]

    def gen():
        if d[0] is None:
            d[0] = tpcds.Q3Data(*map(_host, tpcds.gen_q3(
                rows=rows, items=items, days=days, brands=brands,
                seed=seed, device="cpu")))
        return d[0]

    return {
        "store_sales": _write_once(sig + "_store_sales", lambda: _pa_table({
            "ss_sold_date_sk": gen().s_date,
            "ss_item_sk": gen().s_item,
            "ss_ext_sales_price": gen().s_price})),
        "date_dim": _write_once(sig + "_date_dim", lambda: _pa_table({
            "d_moy": gen().d_moy, "d_year": gen().d_year})),
        "item": _write_once(sig + "_item", lambda: _pa_table({
            "i_brand_id": gen().i_brand,
            "i_manufact_id": gen().i_manufact})),
    }


def run_q3_file(params: dict, ctx):
    from spark_rapids_tpu_torch import models
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    rows = int(params.get("rows", 2048))
    items = int(params.get("items", 128))
    brands = int(params.get("brands", 16))
    manufact = int(params.get("manufact", 3))
    seed = int(params.get("seed", 3))
    device = models._device(params)
    base = 10_957
    paths = q3_paths(rows, items, 730, brands, seed)
    ss = _read(paths["store_sales"],
               ["ss_sold_date_sk", "ss_item_sk", "ss_ext_sales_price"],
               device)
    dd = _read(paths["date_dim"], ["d_moy", "d_year"], device)
    it = _read(paths["item"], ["i_brand_id", "i_manufact_id"], device)
    ctx.check_cancel()
    d = tpcds.Q3Data(ss["ss_sold_date_sk"].data, ss["ss_item_sk"].data,
                     ss["ss_ext_sales_price"].data, dd["d_moy"].data,
                     dd["d_year"].data, it["i_brand_id"].data,
                     it["i_manufact_id"].data)
    # SAME pipeline key as the in-memory runner: one shared executable
    q = models._pipeline(("q3", base, brands, manufact),
                         lambda: tpcds.make_q3(base, years=2,
                                               brands=brands,
                                               manufact=manufact))
    year, brand, sums, total = q(d)
    return models._rows(year, brand, sums) + [[int(total)]]


# ------------------------------------------------------------------ q7


def q7_paths(rows: int, items: int, demos: int, promos: int,
             seed: int) -> Dict[str, str]:
    from spark_rapids_tpu_torch.models import tpcds
    sig = f"q7_r{rows}_i{items}_cd{demos}_p{promos}_s{seed}"
    d = [None]

    def gen():
        if d[0] is None:
            d[0] = tpcds.Q7Data(*map(_host, tpcds.gen_q7(
                rows=rows, items=items, demos=demos, promos=promos,
                seed=seed, device="cpu")))
        return d[0]

    return {
        "store_sales": _write_once(sig + "_store_sales", lambda: _pa_table({
            "ss_item_sk": gen().s_item, "ss_cdemo_sk": gen().s_cdemo,
            "ss_promo_sk": gen().s_promo, "ss_quantity": gen().s_qty,
            "ss_list_price": gen().s_list,
            "ss_coupon_amt": gen().s_coupon,
            "ss_sales_price": gen().s_sales})),
        "customer_demographics": _write_once(sig + "_cd", lambda: _pa_table({
            "cd_match": gen().cd_match})),
        "promotion": _write_once(sig + "_promotion", lambda: _pa_table({
            "p_match": gen().p_match})),
        "item": _write_once(sig + "_item", lambda: _pa_table({
            "i_item_id": gen().item_id})),
    }


def run_q7_file(params: dict, ctx):
    from spark_rapids_tpu_torch import models
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    rows = int(params.get("rows", 2048))
    items = int(params.get("items", 64))
    seed = int(params.get("seed", 7))
    device = models._device(params)
    paths = q7_paths(rows, items, 256, 32, seed)
    ss = _read(paths["store_sales"],
               ["ss_item_sk", "ss_cdemo_sk", "ss_promo_sk",
                "ss_quantity", "ss_list_price", "ss_coupon_amt",
                "ss_sales_price"], device)
    cd = _read(paths["customer_demographics"], ["cd_match"], device)
    pr = _read(paths["promotion"], ["p_match"], device)
    it = _read(paths["item"], ["i_item_id"], device)
    ctx.check_cancel()
    d = tpcds.Q7Data(ss["ss_item_sk"].data, ss["ss_cdemo_sk"].data,
                     ss["ss_promo_sk"].data, ss["ss_quantity"].data,
                     ss["ss_list_price"].data,
                     ss["ss_coupon_amt"].data,
                     ss["ss_sales_price"].data,
                     _bool(cd["cd_match"]), _bool(pr["p_match"]),
                     it["i_item_id"].data)
    q = models._pipeline(("q7", items), lambda: tpcds.make_q7(items))
    return models._rows(*q(d))


# ------------------------------------------------------------------ q9


def q9_path(rows: int, seed: int) -> str:
    from spark_rapids_tpu_torch.models import tpcds
    sig = f"q9_r{rows}_s{seed}"

    def build():
        qty, price, profit = map(_host, tpcds.gen_q9(rows=rows, seed=seed,
                                                     device="cpu"))
        return _pa_table({"ss_quantity": qty,
                          "ss_ext_list_price": price,
                          "ss_net_profit": profit})

    return _write_once(sig + "_store_sales", build)


def run_q9_file(params: dict, ctx):
    from spark_rapids_tpu_torch import models
    from spark_rapids_tpu_torch.models import tpcds
    ctx.check_cancel()
    rows = int(params.get("rows", 4096))
    seed = int(params.get("seed", 9))
    path = q9_path(rows, seed)
    ss = _read(path, ["ss_quantity", "ss_ext_list_price",
                      "ss_net_profit"], models._device(params))
    ctx.check_cancel()
    counts, avg_p, avg_n = tpcds.run_q9(
        ss["ss_quantity"].data, ss["ss_ext_list_price"].data,
        ss["ss_net_profit"].data)
    return models._rows(counts, avg_p, avg_n)
