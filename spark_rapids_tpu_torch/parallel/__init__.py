"""Capacity overflow handling and the table transport.

  exchange.py  CapacityExceeded, with_capacity_retry; the pluggable
               table transport (InProcessKudoTransport,
               set_table_transport, exchange_tables, allgather_table)

The fixed-capacity all-to-all exchange itself comes with ROADMAP
A10(b).
"""
