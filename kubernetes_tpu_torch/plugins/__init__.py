"""Host-side plugins copied from kubernetes_tpu/plugins/."""
