"""Bit helpers, the CUDA build/load machinery, telemetry and the op
layer's sidecars (profiler, fault injector, op brackets)."""
