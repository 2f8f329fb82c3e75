"""Robustness runtime: the *catch* side of the OOM story.

The reference stack splits resilience across two processes: the JNI
library supplies the throw side (``SparkResourceAdaptor`` raising
``GpuRetryOOM``/``GpuSplitAndRetryOOM``) while the plugin supplies the
``withRetry``/``withRestoreOnRetry``/split-and-retry drivers that
actually recover.  This package is the plugin half: task-level retry
drivers with checkpoint/restore, bounded attempts + exponential backoff
+ deadline, halving split-and-retry down to a one-element floor, and
forced-OOM polling for compute-only sections.  ``links`` judges the
distributed shuffle's link failures over the same RetryPolicy, and
``fleet`` the elastic fleet's membership, speculation and skew.  The
lifeguard (``QuarantineBreaker``, ``Watchdog``) is
ROADMAP A14 step 5(c).
"""

from spark_rapids_tpu_torch.robustness.retry import (  # noqa: F401
    Attempt, RetryExhausted, RetryPolicy, SplitFloorReached,
    check_injected_oom, halve_batch, split_and_retry, with_retry,
    with_retry_no_split)
