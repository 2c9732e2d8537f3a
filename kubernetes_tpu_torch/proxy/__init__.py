"""Service dataplane (pkg/proxy analogue).

The reference programs either iptables NAT rules (iptables/proxier.go) or
a userspace round-robin proxy (userspace/proxier.go) from service +
endpoints watches. Here the dataplane is a deterministic RULE TABLE — the
iptables analogue as pure data — plus a userspace-style round-robin load
balancer, both driven by the same config watchers (pkg/proxy/config).

Copy of kubernetes_tpu/proxy/__init__.py: only the import package differs."""

from kubernetes_tpu_torch.proxy.proxier import Proxier, RoundRobinLoadBalancer

__all__ = ["Proxier", "RoundRobinLoadBalancer"]
