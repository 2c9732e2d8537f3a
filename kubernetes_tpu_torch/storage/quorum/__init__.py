"""Quorum consensus control-plane store (the etcd3 cluster analogue).

The reference runs its whole control plane on a raft quorum: every
write is replicated to a majority of etcd members before it is
acknowledged, leader election happens INSIDE the store, and reads can
be made linearizable by confirming leadership first (etcd's ReadIndex).
storage/replicated.py approximated this with a 2-node WAL-shipping
pair and an *external* promotion monitor — which leaves a split-brain
window under partition. This package closes it with a 3+ node
majority-ack consensus store (Raft-shaped):

  * ``RaftLog`` (log.py): durable term/vote + entry log + state
    snapshot, reusing the durable store's length+CRC+TLV record
    framing and torn-tail recovery contract.
  * ``QuorumNode`` (node.py): randomized-timeout leader election with
    persisted votes (pre-vote probes electability before any term
    bump), per-follower next/match replication with
    commit-on-majority-ack, snapshot install for lagging or fresh
    followers, leader-lease linearizable reads (read-index heartbeat
    rounds only on lease miss), and dynamic membership through logged
    config entries.
  * ``QuorumStore`` (store.py): the storage.Interface facade — slots
    in behind the MemoryStore contract so the apiserver, cacher,
    scheduler and kubectl run against it unchanged; any node takes
    client traffic (followers forward writes and barrier reads to the
    leader).
  * ``linearize`` : the Jepsen-lite op-history recorder + checker the
    chaos suite asserts with.

`build_cluster` / `build_store` are the convenience constructors the
hyperkube --store=quorum profile and the bench wire-soak use.

Copy of kubernetes_tpu/storage/quorum/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.storage.quorum.node import (
    NodeConfig,
    NotLeader,
    QuorumNode,
    QuorumUnavailable,
)
from kubernetes_tpu_torch.storage.quorum.store import (
    QuorumStore,
    build_cluster,
)

__all__ = [
    "NodeConfig",
    "NotLeader",
    "QuorumNode",
    "QuorumStore",
    "QuorumUnavailable",
    "build_cluster",
]
