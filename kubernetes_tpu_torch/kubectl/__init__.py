"""The CLI (pkg/kubectl + cmd/kubectl analogue).

`python -m kubernetes_tpu_torch.kubectl --server http://... <verb> ...` — or
embed `Kubectl(client)` programmatically (the CLI is a thin shell over
the same REST client every other component uses).

Copy of kubernetes_tpu/kubectl/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.kubectl.cmd import Kubectl, main

__all__ = ["Kubectl", "main"]
