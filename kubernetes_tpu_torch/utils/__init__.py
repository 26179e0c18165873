"""Host-side utilities copied from kubernetes_tpu/utils/."""

from .metrics import (Metrics, Histogram, Counter, Gauge,  # noqa: F401
                      LabeledCounter, LabeledGauge, bounded_label)
