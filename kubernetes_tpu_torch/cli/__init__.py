"""The port's command-line entry points: the kube-scheduler
(kube_scheduler.py), kubeadm on the in-memory store (kubeadm.py, with
its kubeconfig.py) and the autopilot's offline tooling (autopilot.py),
ports of the same modules under kubernetes_tpu/cli/."""
