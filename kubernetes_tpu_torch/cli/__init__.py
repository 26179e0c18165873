"""The port's command-line entry points: the kube-scheduler
(kube_scheduler.py, a port of kubernetes_tpu/cli/kube_scheduler.py)."""
