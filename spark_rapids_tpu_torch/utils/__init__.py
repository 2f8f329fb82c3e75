"""Bit helpers, the CUDA build/load machinery, the g++ build of the native
host libraries with the string rank over one of them (native.py),
telemetry, the op layer's sidecars (profiler, fault injector, op
brackets), resource and precondition helpers (arms.py) and the Spark
platform predicates with the JNI door's device (platform.py)."""
