"""Stateless columnar ops: Spark row hashes (murmur3_32, xxhash64,
hive_hash, nested columns included), JCUDF row conversion, the
fixed-capacity device join probe, the inner join router with its four
engines and the outer/semi/anti transforms, GROUP BY and ORDER BY over
columns and the copying, aggregation and key helpers they stand on; the
Spark string casts (string <-> integer, float, decimal, integers with a
base), parse_url and the assorted string ops (conv, GBK decode,
list_slice, the literal-range regex fast path); get_json_object, the
from_json family and the map ops; the datetime ops (timezone
conversion, calendar rebase, truncate) and the ORC writer-zone
rectification; SHA-2 and CRC32, Spark multiply and round, decimal128
arithmetic (host big-int and device limbs), bin/hex/format_number and
the string -> date/timestamp parsers, CASE WHEN's first-true index,
substring_index, z-order and Hilbert indexes, the bloom filter, HLL++
and histogram sketches, the Iceberg transforms and random UUIDs."""

from spark_rapids_tpu_torch.ops.hash import (  # noqa: F401
    DEFAULT_XXHASH64_SEED,
    hive_hash,
    murmur3_32,
    xxhash64,
)
from spark_rapids_tpu_torch.ops.copying import (  # noqa: F401
    concat_tables,
    gather,
    gather_table,
    slice_table,
    split_table,
)
from spark_rapids_tpu_torch.ops.joins import (  # noqa: F401
    NULL_EQUAL,
    NULL_UNEQUAL,
    filter_join_pairs,
    get_matched_rows,
    hash_inner_join,
    make_anti,
    make_full_outer,
    make_left_outer,
    make_semi,
    sort_merge_inner_join,
)
from spark_rapids_tpu_torch.ops.cast_string import (  # noqa: F401
    float_to_string,
    string_to_float,
    string_to_integer,
)
from spark_rapids_tpu_torch.ops.json_path import (  # noqa: F401
    get_json_object,
    get_json_object_multiple_paths,
)
from spark_rapids_tpu_torch.ops import parse_uri  # noqa: F401
from spark_rapids_tpu_torch.ops.strings_misc import (  # noqa: F401
    convert,
    decode_to_utf8,
    is_convert_overflow,
    list_slice,
    literal_range_pattern,
)
from spark_rapids_tpu_torch.ops import map_utils  # noqa: F401
from spark_rapids_tpu_torch.ops import json_utils  # noqa: F401
from spark_rapids_tpu_torch.ops import datetime_ops  # noqa: F401
from spark_rapids_tpu_torch.ops import orc_timezones  # noqa: F401

from spark_rapids_tpu_torch.ops.sha import (  # noqa: F401
    host_crc32,
    sha224_nulls_preserved,
    sha256_nulls_preserved,
    sha384_nulls_preserved,
    sha512_nulls_preserved,
)
from spark_rapids_tpu_torch.ops.arithmetic import (  # noqa: F401
    HALF_EVEN,
    HALF_UP,
    multiply,
    round_column,
)
from spark_rapids_tpu_torch.ops.aggregation64 import (  # noqa: F401
    assemble64_from_sum,
    extract_chunk32_from_64bit,
)
from spark_rapids_tpu_torch.ops.case_when import (  # noqa: F401
    select_first_true_index,
)
from spark_rapids_tpu_torch.ops.substring_index import substring_index  # noqa: F401
from spark_rapids_tpu_torch.ops.zorder import (  # noqa: F401
    hilbert_index,
    interleave_bits,
)
from spark_rapids_tpu_torch.ops import bloom_filter  # noqa: F401
from spark_rapids_tpu_torch.ops.exceptions import (  # noqa: F401
    CastException,
    ExceptionWithRowIndex,
)
from spark_rapids_tpu_torch.ops.groupby import groupby_aggregate  # noqa: F401
from spark_rapids_tpu_torch.ops import hllpp  # noqa: F401
from spark_rapids_tpu_torch.ops.histogram import (  # noqa: F401
    create_histogram_if_valid,
    percentile_from_histogram,
)
from spark_rapids_tpu_torch.ops import decimal_utils  # noqa: F401
from spark_rapids_tpu_torch.ops import iceberg  # noqa: F401
from spark_rapids_tpu_torch.ops.uuid_gen import random_uuids  # noqa: F401
from spark_rapids_tpu_torch.ops.sorting import order_by, sort_table  # noqa: F401
from spark_rapids_tpu_torch.ops.cast_more import (  # noqa: F401
    bytes_to_hex,
    decimal_to_non_ansi_string,
    format_number,
    long_to_binary_string,
    long_to_hex_string,
    parse_strings_to_date,
    parse_timestamp_strings,
    parse_timestamp_strings_with_format,
)
from spark_rapids_tpu_torch.ops import protobuf  # noqa: F401

# ---------------------------------------------------------------------
# Sidecar instrumentation: every public op entry point gets the
# maybe_inject + op_range bracket AT THE OP LAYER (reference: NVTX
# ranges live in each kernel entry, nvtx_ranges.hpp), so models/, tests
# and the shim all hit the same tracing/fault-injection surface.
from spark_rapids_tpu_torch.utils.tracing import instrument as _instrument

_TRACED = {
    "spark_rapids_tpu_torch.ops.hash": ["murmur3_32", "xxhash64", "hive_hash"],
    "spark_rapids_tpu_torch.ops.sha": [
        "sha224_nulls_preserved", "sha256_nulls_preserved",
        "sha384_nulls_preserved", "sha512_nulls_preserved", "host_crc32"],
    "spark_rapids_tpu_torch.ops.cast_string": [
        "string_to_integer", "string_to_float", "float_to_string"],
    "spark_rapids_tpu_torch.ops.arithmetic": ["multiply", "round_column"],
    "spark_rapids_tpu_torch.ops.aggregation64": [
        "extract_chunk32_from_64bit", "assemble64_from_sum"],
    "spark_rapids_tpu_torch.ops.case_when": ["select_first_true_index"],
    "spark_rapids_tpu_torch.ops.copying": [
        "gather", "gather_table", "slice_table", "split_table",
        "concat_tables"],
    "spark_rapids_tpu_torch.ops.substring_index": ["substring_index"],
    "spark_rapids_tpu_torch.ops.zorder": ["interleave_bits", "hilbert_index"],
    "spark_rapids_tpu_torch.ops.joins": [
        "sort_merge_inner_join", "hash_inner_join", "filter_join_pairs",
        "make_left_outer", "make_full_outer", "make_semi", "make_anti",
        "get_matched_rows"],
    "spark_rapids_tpu_torch.ops.groupby": ["groupby_aggregate"],
    "spark_rapids_tpu_torch.ops.histogram": [
        "create_histogram_if_valid", "percentile_from_histogram"],
    "spark_rapids_tpu_torch.ops.json_path": [
        "get_json_object", "get_json_object_multiple_paths"],
    "spark_rapids_tpu_torch.ops.strings_misc": [
        "convert", "is_convert_overflow", "decode_to_utf8", "list_slice",
        "literal_range_pattern"],
    "spark_rapids_tpu_torch.ops.uuid_gen": ["random_uuids"],
    "spark_rapids_tpu_torch.ops.sorting": ["order_by", "sort_table"],
    "spark_rapids_tpu_torch.ops.row_conversion": [
        "convert_to_rows", "convert_from_rows"],
    "spark_rapids_tpu_torch.ops.cast_more": [
        "long_to_binary_string", "bytes_to_hex", "long_to_hex_string",
        "decimal_to_non_ansi_string", "format_number",
        "parse_strings_to_date", "parse_timestamp_strings",
        "parse_timestamp_strings_with_format"],
}

from spark_rapids_tpu_torch.ops import row_conversion as _rc  # noqa: F401,E402

for _m, _names in _TRACED.items():
    _instrument(_m, _names)
# re-export the wrapped bindings at the package level too
import sys as _sys  # noqa: E402

_pkg = _sys.modules[__name__]
for _m, _names in _TRACED.items():
    for _n in _names:
        if hasattr(_pkg, _n):
            setattr(_pkg, _n, getattr(_sys.modules[_m], _n))
del _sys, _pkg, _m, _names, _n
