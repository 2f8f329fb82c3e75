"""The JVM door: a handle registry and the flat handle-based entry points
(`jni_api`) that a JNI or C-FFI binding calls."""

from spark_rapids_tpu_torch.shim.handles import HandleRegistry  # noqa: F401
from spark_rapids_tpu_torch.shim import jni_api  # noqa: F401
