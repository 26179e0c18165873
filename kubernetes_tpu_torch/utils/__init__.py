"""Host-side utilities copied from kubernetes_tpu/utils/."""
