"""Storage / consensus layer (pkg/storage analogue).

The reference persists everything in etcd behind storage.Interface
(pkg/storage/interfaces.go:82-142) and multiplexes watches through an
in-memory watch cache (cacher.go). The contract is preserved exactly
at every durability tier: monotonic resourceVersions,
optimistic-concurrency GuaranteedUpdate, watch streams resumable from
a resourceVersion, and "too old" errors past the compaction horizon
that force clients to relist (reflector.go:281 semantics depend on
all of these). The tiers, least to most durable: `MemoryStore`
(in-process), `durable.FileStore` (WAL + snapshot), `replicated`
(2-node synchronous WAL shipping + external promotion, now with a
promotion fence), and `quorum` (3+ member majority-ack consensus —
the etcd3 cluster analogue: leader election, log replication,
linearizable read-index reads; imported lazily from
`kubernetes_tpu_torch.storage.quorum`, not re-exported here, so the common
single-store path never pays its import).

Copy of kubernetes_tpu/storage/__init__.py: only the import package differs.
"""

from kubernetes_tpu_torch.storage.cacher import Cacher
from kubernetes_tpu_torch.storage.store import (
    DELETE_OBJECT,
    Compacted,
    Conflict,
    KeyExists,
    KeyNotFound,
    MemoryStore,
    StorageError,
    WatchEvent,
    WatchStream,
)

__all__ = [
    "Cacher",
    "DELETE_OBJECT",
    "MemoryStore",
    "WatchEvent",
    "WatchStream",
    "StorageError",
    "KeyNotFound",
    "KeyExists",
    "Conflict",
    "Compacted",
]
