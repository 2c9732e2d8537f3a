"""Host-side utility layer.

TPU-native counterpart of the reference's pkg/util: the pieces every
control loop is built from — injectable clocks, wait loops, work queues,
client-side flow control, and the step tracer. The device never sees any
of this; it is the shell around the tensor program.

Copy of kubernetes_tpu/utils/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.utils.clock import Clock, FakeClock, RealClock
from kubernetes_tpu_torch.utils.flowcontrol import Backoff, TokenBucketRateLimiter
from kubernetes_tpu_torch.utils.trace import Trace
from kubernetes_tpu_torch.utils.workqueue import (
    DelayingQueue,
    RateLimitingQueue,
    WorkQueue,
    parallelize,
)

__all__ = [
    "Clock",
    "RealClock",
    "FakeClock",
    "Backoff",
    "TokenBucketRateLimiter",
    "Trace",
    "WorkQueue",
    "DelayingQueue",
    "RateLimitingQueue",
    "parallelize",
]
