"""Spark parse_url (reference parse_uri.cu/.hpp, ParseURI.java): extract
protocol/host/query/query-by-key/path with java.net.URI validation
semantics — invalid URIs yield null (non-ANSI) or ExceptionWithRowIndex
(ANSI), matching ParseURITest's java.net.URI oracle.

Columns above a size threshold route to the device engine
(ops/parse_uri_device.py, positional tensor ops over the padded char
matrix on the column's device); the per-row _URI parser here is the
semantic oracle and handles the device engine's fallback rows
(non-ASCII, IPv6) plus small columns, returning its column on the input
column's device."""

from __future__ import annotations

import re
from typing import List, Optional, Union

from spark_rapids_tpu_torch.columns.column import Column
from spark_rapids_tpu_torch.ops.exceptions import ExceptionWithRowIndex

_SCHEME_RE = re.compile(r"^[A-Za-z][A-Za-z0-9+.\-]*$")
_HEX = "0123456789abcdefABCDEF"
# RFC 2396 unreserved + punct allowed by java.net.URI per component
_PATH_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
               "0123456789-_.!~*'():@&=+$,;/")
_QUERY_OK = _PATH_OK | set("?[]")  # java allows ? and [] in query/fragment
_USER_OK = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
               "0123456789-_.!~*'():&=+$,;")
_HOSTNAME_RE = re.compile(
    r"^(?:[A-Za-z0-9]|[A-Za-z0-9][A-Za-z0-9\-]*[A-Za-z0-9])"
    r"(?:\.(?:[A-Za-z0-9]|[A-Za-z0-9][A-Za-z0-9\-]*[A-Za-z0-9]))*\.?$")
_IPV4_RE = re.compile(r"^(\d{1,3})\.(\d{1,3})\.(\d{1,3})\.(\d{1,3})$")
_IPV6_CHUNK = re.compile(r"^[0-9A-Fa-f]{1,4}$")


class _Invalid(Exception):
    pass


def _check_escapes(s: str, allowed: set) -> None:
    i = 0
    while i < len(s):
        c = s[i]
        if c == "%":
            if i + 2 >= len(s) + 1 or len(s) - i < 3 or \
                    s[i + 1] not in _HEX or s[i + 2] not in _HEX:
                raise _Invalid()
            i += 3
            continue
        if ord(c) >= 0x80:
            # java.net.URI allows non-US-ASCII "other" chars; C1 controls
            # and unicode spaces are rejected
            if 0x80 <= ord(c) <= 0x9F or c.isspace():
                raise _Invalid()
            i += 1
            continue
        if c not in allowed:
            raise _Invalid()
        i += 1


def _valid_ipv6(h: str) -> bool:
    if not (h.startswith("[") and h.endswith("]")):
        return False
    body = h[1:-1]
    if body.count("::") > 1:
        return False
    if "%" in body:  # scope id
        body = body.split("%", 1)[0]
    parts = body.split(":")
    if "" in parts:
        if "::" not in body:
            return False
        parts = [p for p in parts if p]
        if len(parts) > 7:
            return False
    elif len(parts) != 8 and "." not in parts[-1]:
        return False
    for i, p in enumerate(parts):
        if "." in p:
            if i != len(parts) - 1 or not _IPV4_RE.match(p):
                return False
            if any(int(x) > 255 for x in _IPV4_RE.match(p).groups()):
                return False
        elif p and not _IPV6_CHUNK.match(p):
            return False
    return True


class _URI:
    """Mini java.net.URI: scheme/host/rawQuery/rawPath with validation."""

    def __init__(self, s: str):
        self.scheme: Optional[str] = None
        self.host: Optional[str] = None
        self.raw_query: Optional[str] = None
        self.raw_path: Optional[str] = None
        rest = s
        # fragment
        frag = None
        if "#" in rest:
            rest, frag = rest.split("#", 1)
            _check_escapes(frag, _QUERY_OK)
        # scheme
        m = re.match(r"^([A-Za-z][A-Za-z0-9+.\-]*):", rest)
        if m:
            self.scheme = m.group(1)
            rest = rest[m.end():]
        elif rest.startswith(":"):
            raise _Invalid()
        # query (only for hierarchical URIs)
        if self.scheme is not None and not rest.startswith("/") \
                and not rest.startswith("//"):
            # opaque URI: ssp must be non-empty and not start with /
            if not rest:
                raise _Invalid()
            _check_escapes(rest, _QUERY_OK)
            return
        if "?" in rest:
            rest, q = rest.split("?", 1)
            _check_escapes(q, _QUERY_OK)
            self.raw_query = q
        # authority
        if rest.startswith("//"):
            auth = rest[2:]
            slash = auth.find("/")
            if slash >= 0:
                rest = auth[slash:]
                auth = auth[:slash]
            else:
                rest = ""
            self._parse_authority(auth)
        if rest:
            _check_escapes(rest, _PATH_OK)
        self.raw_path = rest

    def _parse_authority(self, auth: str):
        if not auth:
            return
        host = auth
        if "@" in auth:
            user, host = auth.rsplit("@", 1)
            _check_escapes(user, _USER_OK)
        # port
        if host.startswith("["):
            close = host.find("]")
            if close < 0:
                raise _Invalid()
            hostpart = host[:close + 1]
            portpart = host[close + 1:]
            if portpart and not re.match(r"^:\d*$", portpart):
                raise _Invalid()
            if not _valid_ipv6(hostpart):
                raise _Invalid()
            self.host = hostpart
            return
        portpart = None
        if ":" in host:
            host, portpart = host.rsplit(":", 1)
            if portpart and not portpart.isdigit():
                # server-based parse fails; registry authority: host null
                _check_escapes(host + ":" + portpart, _USER_OK | {"[", "]"})
                return
        m4 = _IPV4_RE.match(host)
        if m4 and all(int(x) <= 255 for x in m4.groups()):
            self.host = host
            return
        if _HOSTNAME_RE.match(host):
            self.host = host
            return
        # registry-based authority: URI valid but host is null; chars must
        # still be legal
        _check_escapes(host, _USER_OK | {"[", "]"})


def match_query_key(query, key):
    """parse_url(..., 'QUERY', key) pair matching: value of the FIRST
    '&'-delimited 'key=value' pair, else None.  THE single definition —
    the host extractor, the device engine's fallback rows, and the
    device materializer (parse_uri_device) all call this, so a
    semantics change lands everywhere at once.  Accepts str or bytes
    queries (key is always str)."""
    if query is None or key is None:
        return None
    if isinstance(query, bytes):
        sep, eq, k = b"&", b"=", key.encode()
    else:
        sep, eq, k = "&", "=", key
    for pair in query.split(sep):
        i = pair.find(eq)
        if i >= 0 and pair[:i] == k:
            return pair[i + 1:]
    return None


def _parse(s: Optional[str]) -> Optional[_URI]:
    if s is None:
        return None
    try:
        return _URI(s)
    except _Invalid:
        return None


def _extract(col: Column, what: str, ansi_mode: bool,
             keys: Optional[List[Optional[str]]] = None,
             scalar_key: Optional[str] = None) -> Column:
    assert col.dtype.is_string
    from spark_rapids_tpu_torch.ops import parse_uri_device as PD
    if PD.use_device(col) and (what != "query_key"
                               or scalar_key is not None):
        return PD.extract_device(col, what, ansi_mode, scalar_key)
    vals = col.to_pylist()
    out: List[Optional[str]] = []
    for i, s in enumerate(vals):
        uri = _parse(s)
        if uri is None:
            if ansi_mode and s is not None:
                raise ExceptionWithRowIndex(i, f"invalid URI: {s!r}")
            out.append(None)
            continue
        if what == "protocol":
            out.append(uri.scheme)
        elif what == "host":
            out.append(uri.host)
        elif what == "query":
            out.append(uri.raw_query)
        elif what == "path":
            out.append(uri.raw_path)
        elif what == "query_key":
            out.append(match_query_key(uri.raw_query, keys[i]))
        else:
            raise ValueError(what)
    return Column.from_strings(out, col.device)


def parse_uri_to_protocol(col: Column, ansi_mode: bool = False) -> Column:
    return _extract(col, "protocol", ansi_mode)


def parse_uri_to_host(col: Column, ansi_mode: bool = False) -> Column:
    return _extract(col, "host", ansi_mode)


def parse_uri_to_query(col: Column, ansi_mode: bool = False) -> Column:
    return _extract(col, "query", ansi_mode)


def parse_uri_to_path(col: Column, ansi_mode: bool = False) -> Column:
    return _extract(col, "path", ansi_mode)


def parse_uri_to_query_with_key(col: Column,
                                key: Union[str, Column],
                                ansi_mode: bool = False) -> Column:
    if isinstance(key, Column):
        keys = key.to_pylist()
        return _extract(col, "query_key", ansi_mode, keys)
    return _extract(col, "query_key", ansi_mode,
                    [key] * col.length, scalar_key=key)
