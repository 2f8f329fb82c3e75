"""Composed pipelines: the flagship columnar step and the TPC-DS q5/q72
hand pipelines."""
