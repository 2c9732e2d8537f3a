"""Service discovery DNS (cmd/kube-dns + pkg/dns, skydns-based).

Resolves the reference's record shapes from live service/endpoints
watches:
  <svc>.<ns>.svc.<domain>            -> A     cluster IP
  headless <svc>.<ns>.svc.<domain>   -> A*    ready endpoint IPs
  <pod-host>.<svc>.<ns>.svc.<domain> -> A     that endpoint (petset names)
  _<port>._<proto>.<svc>.<ns>.svc... -> SRV   port + target

Copy of kubernetes_tpu/dns/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.dns.server import DNSRecords
from kubernetes_tpu_torch.dns.wire import DNSServer

__all__ = ["DNSRecords", "DNSServer"]
