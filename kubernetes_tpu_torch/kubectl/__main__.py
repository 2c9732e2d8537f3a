"""Copy of kubernetes_tpu/kubectl/__main__.py: only the import package differs."""
from kubernetes_tpu_torch.kubectl.cmd import main

main()
