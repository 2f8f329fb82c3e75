"""Capacity overflow handling for fixed-capacity programs.

  exchange.py  CapacityExceeded, with_capacity_retry

The fixed-capacity all-to-all exchange itself comes with ROADMAP A10.
"""
