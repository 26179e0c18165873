"""Client runtime: the work queues and event recording the port's
controllers use (copies of kubernetes_tpu/client/workqueue.py and
record.py)."""

from .record import EventRecorder  # noqa: F401
from .workqueue import (DelayingQueue,  # noqa: F401
                        ItemExponentialFailureRateLimiter, RateLimitingQueue)
