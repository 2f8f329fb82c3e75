"""Memory runtime: reservation resources, the RmmSpark OOM retry/split
state machine, host-spill table movement and the tiered spill store
(reference SURVEY.md §2.1), and ``native_adaptor``, the ctypes binding
to the C++ state machine (native/spark_resource_adaptor.cpp)."""

from spark_rapids_tpu_torch.memory.exceptions import (  # noqa: F401
    GpuRetryOOM, GpuSplitAndRetryOOM, CpuRetryOOM, CpuSplitAndRetryOOM,
    GpuOOM, OffHeapOOM, CudfException, ThreadRemovedException)
from spark_rapids_tpu_torch.memory.resource import (  # noqa: F401
    MemoryResource, LimitingMemoryResource, AllocationFailed)
from spark_rapids_tpu_torch.memory.spark_resource_adaptor import (
    SparkResourceAdaptor)  # noqa: F401
from spark_rapids_tpu_torch.memory.host_table import HostTable  # noqa: F401
