"""Storage ingest layer: pluggable file IO (``fileio``), parquet
footer parse/prune (``parquet_footer``), the page decoders
(``page_decode``), the columnar reader (``parquet_reader``), and the
zero-copy Arrow C-interface door (``arrow_cabi``).  Host decode is
numpy; the reader and the Arrow door hand columns to ``device``
("cuda" unless the caller asks for the CPU).

The typed failure surface is re-exported here: footers raise
``ParquetFooterException``, pages raise ``ParquetDecodeException``
(registered non-retryable with the retry drivers), Arrow hand-offs
raise ``ArrowIngestException``.
"""

from spark_rapids_tpu_torch.io.parquet_footer import (  # noqa: F401
    ParquetFooterException)


def __getattr__(name):
    # lazy re-exports: keep `import spark_rapids_tpu_torch.io.parquet_footer`
    # as light as the seed (page_decode pulls numpy + the retry driver)
    if name == "ParquetDecodeException":
        from spark_rapids_tpu_torch.io.page_decode import ParquetDecodeException
        return ParquetDecodeException
    if name == "ArrowIngestException":
        from spark_rapids_tpu_torch.io.arrow_cabi import ArrowIngestException
        return ArrowIngestException
    if name == "read_table":
        from spark_rapids_tpu_torch.io.parquet_reader import read_table
        return read_table
    if name == "ingest":
        from spark_rapids_tpu_torch.io.arrow_cabi import ingest
        return ingest
    if name == "read_range":
        from spark_rapids_tpu_torch.io.fileio import read_range
        return read_range
    raise AttributeError(name)
