"""Whole-stage fusion: a small stage IR and its compiler, which runs
everything a query does between shuffle boundaries as one compiled
program or op by op.

  ir.py        typed plan nodes (scan-bind, project/filter exprs,
               hash-join probe, segment/window/rollup aggregates,
               sort, cross-shard reduce, shuffle boundary)
  compiler.py  one evaluator, two engines: a torch.compile'd program
               per stage and row bucket, and the op-by-op walk
  catalog.py   TPC-DS q5 and q72 as stage pipelines (the hand
               pipelines in models/tpcds stay as byte-identity oracles)
"""

from spark_rapids_tpu_torch.plan import catalog, compiler, ir  # noqa: F401
from spark_rapids_tpu_torch.plan.compiler import (  # noqa: F401
    CompiledStage, compile_pipeline, compile_stage, fusion_mode)
