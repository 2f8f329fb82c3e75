"""Arrow-layout Column/Table on torch tensors, and host interop."""
from spark_rapids_tpu_torch.columns.dtypes import DType  # noqa: F401
from spark_rapids_tpu_torch.columns.column import Column  # noqa: F401
from spark_rapids_tpu_torch.columns.table import Table  # noqa: F401
