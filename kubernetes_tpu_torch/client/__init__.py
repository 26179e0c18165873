"""Client runtime: the REST client, the reflector and its RemoteStore,
leader election, and the work queues and event recording the port's
controllers use (copies of kubernetes_tpu/client/rest.py, reflector.py,
leaderelection.py, workqueue.py and record.py)."""

from .leaderelection import LeaderElector  # noqa: F401
from .record import EventRecorder  # noqa: F401
from .reflector import Reflector, RemoteStore  # noqa: F401
from .rest import APIStatusError, RESTClient  # noqa: F401
from .workqueue import (DelayingQueue,  # noqa: F401
                        ItemExponentialFailureRateLimiter, RateLimitingQueue)
