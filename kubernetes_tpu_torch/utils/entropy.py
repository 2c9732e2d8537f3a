"""Buffered kernel entropy, one buffer PER THREAD.

A 4096-byte os.urandom read amortizes the syscall across ~200 tokens,
and thread-locality removes the lock convoy a shared buffer creates
under parallel bulk creates (a dozen apiserver handler threads each
minting uids serialized on one lock measured as ~1/3 of create-storm
CPU). The bytes are still kernel entropy (create.go's rand.String(5)
contract: unpredictable, not RFC-4122); only the syscall count changes.

Fork safety: a fork() clones the parent's unconsumed buffer into the
child (threading.local survives fork on the forking thread), and
without invalidation parent and child would mint IDENTICAL uid /
generateName / trace-id streams — colliding keys across what are
supposed to be independent workers. The child-side invalidation is an
os.register_at_fork generation bump compared against a per-buffer
stamp: calling os.getpid() per mint instead was measured at ~41us PER
CALL under gVisor (a real syscall there, not a vDSO read) — ~23% of
the whole bulk-create path.

Shared by apiserver/registry.py (object uid + generateName suffixes)
and trace/spans.py (trace/span ids: uuid4 per span was ~0.6s of a
30k-pod wire rep, all of it urandom syscalls).

Copy of kubernetes_tpu/utils/entropy.py: only the import package differs.
"""

from __future__ import annotations

import os
import threading as _threading

_RAND_TLS = _threading.local()
_RAND_GEN = 0


def _fork_invalidate_rand() -> None:
    global _RAND_GEN
    _RAND_GEN += 1


os.register_at_fork(after_in_child=_fork_invalidate_rand)


def rand_hex(nbytes: int) -> str:
    """Hex string of `nbytes` of buffered kernel entropy (fork-safe:
    the buffer reseeds in a forked child via an at-fork generation)."""
    tls = _RAND_TLS
    buf = getattr(tls, "buf", None)
    pos = getattr(tls, "pos", 0)
    if buf is None or pos + nbytes > len(buf) or getattr(
            tls, "gen", -1) != _RAND_GEN:
        buf = tls.buf = os.urandom(4096)
        tls.gen = _RAND_GEN
        pos = 0
    out = buf[pos:pos + nbytes]
    tls.pos = pos + nbytes
    return out.hex()
