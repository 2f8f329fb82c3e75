"""StringUtils catch-all surface (reference StringUtilsJni.cpp --
randomUUIDs export -- plus StringUtils.java).  The scattered string
helpers live in their own modules; this facade mirrors the reference's
single entry class so binding layers have one place to route."""

from __future__ import annotations

from spark_rapids_tpu_torch.ops.strings_misc import (  # noqa: F401
    REPLACE,
    REPORT,
    convert,
    decode_to_utf8,
    is_convert_overflow,
    list_slice,
    literal_range_pattern,
)
from spark_rapids_tpu_torch.ops.substring_index import substring_index  # noqa: F401
from spark_rapids_tpu_torch.ops.uuid_gen import random_uuids  # noqa: F401
