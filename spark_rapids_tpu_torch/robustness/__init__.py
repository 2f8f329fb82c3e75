"""Robustness runtime: the *catch* side of the OOM story.

The reference stack splits resilience across two processes: the JNI
library supplies the throw side (``SparkResourceAdaptor`` raising
``GpuRetryOOM``/``GpuSplitAndRetryOOM``) while the plugin supplies the
``withRetry``/``withRestoreOnRetry``/split-and-retry drivers that
actually recover.  This package is the plugin half: task-level retry
drivers with checkpoint/restore, bounded attempts + exponential backoff
+ deadline, halving split-and-retry down to a one-element floor, and
forced-OOM polling for compute-only sections.  ``links`` judges the
distributed shuffle's link failures over the same RetryPolicy,
``fleet`` the elastic fleet's membership, speculation and skew, and
``lifeguard`` (``QuarantineBreaker``, ``Watchdog``, heartbeats) the
query server's hung and poison queries.
"""

from spark_rapids_tpu_torch.robustness.lifeguard import (  # noqa: F401
    QuarantineBreaker, Watchdog)
from spark_rapids_tpu_torch.robustness.retry import (  # noqa: F401
    Attempt, RetryExhausted, RetryPolicy, SplitFloorReached,
    check_injected_oom, halve_batch, split_and_retry, with_retry,
    with_retry_no_split)
