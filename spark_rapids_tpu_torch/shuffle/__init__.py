"""The kudo shuffle path: the flattened schema, the byte-exact kudo
writer, reader and merger (host), the device split and assemble that
keep every payload byte on the card, the router between them, and the
socket endpoints (socket_io) the distributed transport reads with, and
the ctypes binding of the byte-identical C++ kudo engine (kudo_native)."""
