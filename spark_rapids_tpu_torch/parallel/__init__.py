"""The exchange between ranks, capacity overflow handling and the
table transport.

  exchange.py  build_padded_sends, exchange (the fixed-capacity
               all-to-all over a process group); CapacityExceeded,
               with_capacity_retry; the pluggable table transport
               (InProcessKudoTransport, set_table_transport,
               exchange_tables, allgather_table)
"""
