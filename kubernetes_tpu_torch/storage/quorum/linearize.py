"""Jepsen-lite linearizability checking for the quorum store.

A full Wing&Gong search over an arbitrary history is NP-hard; this
checker exploits what the store itself guarantees to make verification
linear: every committed write carries a globally unique, monotonically
increasing resourceVersion, so the system HANDS US its claimed
serialization order. Checking linearizability then reduces to:

  1. **Write real-time order**: if write A completed (ok) before
     write B was invoked, then rv(A) < rv(B) — the claimed order must
     respect real time.
  2. **Read consistency**: replay all committed writes in rv order
     into a sequential model (a plain ``MemoryStore``); a read that
     returned (value, rv_observed) must match the model state at
     rv_observed for its key.
  3. **Read real-time freshness**: a read must not observe a point
     BEFORE a write that completed before the read was invoked
     (rv_observed >= rv of every such write) — the stale-read anomaly
     a deposed-but-unaware leader would produce.
  4. **Durability**: every acknowledged write's effect must be present
     in the final state (zero lost acknowledged writes).

Indeterminate ops (invoke with no ok/fail — a timeout, or a client
severed by the nemesis) may legally have happened or not: they are
included in the replay only if their rv is known (the system committed
them), and excluded from the real-time edges (their completion time is
unknown).

Ops are recorded with ``HistoryRecorder`` — thread-safe, monotonic
timestamps — by the chaos drivers, and ``check`` returns (ok, errors)
so the suite can assert, not just log.

Copy of kubernetes_tpu/storage/quorum/linearize.py: only the import package differs.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

OK = "ok"
FAIL = "fail"  # definite non-occurrence (e.g. KeyExists, Conflict)
INFO = "info"  # indeterminate (timeout / connection severed)


@dataclass
class Op:
    op_id: int
    process: str  # logical client thread
    kind: str  # "write" | "delete" | "read"
    key: str
    value: Any = None  # written value, or the value a read observed
    rv: Optional[int] = None  # resourceVersion stamped by the store
    t_invoke: float = 0.0
    t_complete: float = 0.0
    status: str = INFO


class HistoryRecorder:
    """Append-only op history; every mutator is lock-protected so
    chaos clients on many threads can share one recorder."""

    def __init__(self):
        self._mu = threading.Lock()
        self._ops: List[Op] = []  # guarded-by: self._mu

    def invoke(self, process: str, kind: str, key: str,
               value: Any = None) -> int:
        with self._mu:
            op_id = len(self._ops)
            self._ops.append(Op(
                op_id=op_id, process=process, kind=kind, key=key,
                value=value, t_invoke=time.monotonic()))
            return op_id

    def ok(self, op_id: int, rv: Optional[int] = None,
           value: Any = None) -> None:
        with self._mu:
            op = self._ops[op_id]
            op.status = OK
            op.rv = rv
            if value is not None:
                op.value = value
            op.t_complete = time.monotonic()

    def fail(self, op_id: int) -> None:
        """The op DEFINITELY did not happen (a clean store error)."""
        with self._mu:
            op = self._ops[op_id]
            op.status = FAIL
            op.t_complete = time.monotonic()

    def info(self, op_id: int) -> None:
        """Outcome unknown (timeout / severed connection)."""
        with self._mu:
            self._ops[op_id].t_complete = time.monotonic()

    def ops(self) -> List[Op]:
        with self._mu:
            return list(self._ops)


@dataclass
class CheckResult:
    ok: bool
    errors: List[str] = field(default_factory=list)
    checked_writes: int = 0
    checked_reads: int = 0

    def __bool__(self) -> bool:
        return self.ok


def check(history: "HistoryRecorder | List[Op]",
          final_state: Optional[Dict[str, Tuple[Any, int]]] = None,
          max_errors: int = 10) -> CheckResult:
    """Verify the recorded history (see module docstring for the four
    checks). `final_state` is {key: (value, rv)} read from the store
    after the run (quiesced) for the zero-lost-acked-writes gate."""
    ops = history.ops() if isinstance(history, HistoryRecorder) else \
        list(history)
    errors: List[str] = []

    def err(msg: str) -> None:
        if len(errors) < max_errors:
            errors.append(msg)

    writes = [o for o in ops if o.kind in ("write", "delete")
              and o.rv is not None]
    writes.sort(key=lambda o: o.rv)
    for a, b in zip(writes, writes[1:]):
        if a.rv == b.rv:
            err(f"two writes share rv {a.rv}: op{a.op_id} and "
                f"op{b.op_id} — duplicate commit")

    # 1. the claimed (rv) order respects real time between COMPLETED
    # writes. A violation is a pair (A, B) with rv(B) < rv(A) where A
    # completed before B was invoked. Sweep in rv order keeping the
    # running max invoke time over the prefix: if any smaller-rv write
    # was invoked AFTER this write completed, the pair inverted — an
    # O(n) scan instead of the quadratic pairwise walk.
    acked = [w for w in writes if w.status == OK]
    prefix_max_invoke = float("-inf")
    prefix_argmax: Optional[Op] = None
    for w in acked:  # already rv-sorted
        if prefix_max_invoke > w.t_complete and \
                prefix_argmax is not None:
            err(f"real-time inversion: write op{prefix_argmax.op_id} "
                f"was invoked after op{w.op_id} completed, yet "
                f"serializes before it (rv {prefix_argmax.rv} < "
                f"rv {w.rv})")
        if w.t_invoke > prefix_max_invoke:
            prefix_max_invoke = w.t_invoke
            prefix_argmax = w

    # 2+3. replay the claimed order; verify each read against the
    # model at its observed rv, and against real-time freshness
    model: Dict[str, Tuple[Any, int]] = {}
    replay = iter(writes)
    cur: Optional[Op] = next(replay, None)
    reads = sorted((o for o in ops if o.kind == "read"
                    and o.status == OK and o.rv is not None),
                   key=lambda o: o.rv)
    n_reads = 0
    for r in reads:
        while cur is not None and cur.rv <= r.rv:
            if cur.kind == "delete":
                model.pop(cur.key, None)
            else:
                model[cur.key] = (cur.value, cur.rv)
            cur = next(replay, None)
        expect = model.get(r.key)
        got = r.value
        if expect is None:
            if got is not None:
                err(f"read op{r.op_id} of {r.key} at rv {r.rv} "
                    f"observed {got!r} but the key does not exist "
                    "at that point")
        elif got != expect[0]:
            err(f"read op{r.op_id} of {r.key} at rv {r.rv} observed "
                f"{got!r}, model holds {expect[0]!r} "
                f"(written at rv {expect[1]})")
        n_reads += 1
    # freshness: a read must not serialize before an already-completed
    # write (per-key; cross-key staleness is legal for a single read)
    for r in reads:
        for w in acked:
            if w.key == r.key and w.t_complete < r.t_invoke and \
                    r.rv < w.rv:
                err(f"stale read: op{r.op_id} of {r.key} observed "
                    f"rv {r.rv} after write op{w.op_id} (rv {w.rv}) "
                    "had already been acknowledged")

    # 4. zero lost acknowledged writes: the final state must reflect
    # every acked write unless a LATER write to the key legally
    # supersedes it. An indeterminate op (timeout — it may have
    # committed without us ever learning its rv) makes "later" states
    # legal, but can never excuse a state OLDER than an acked write.
    if final_state is not None:
        indeterminate: Dict[str, List[Op]] = {}
        for o in ops:
            if o.kind in ("write", "delete") and o.status == INFO \
                    and o.rv is None:
                indeterminate.setdefault(o.key, []).append(o)
        last_write: Dict[str, Op] = {}
        for w in writes:  # rv order: last one wins per key
            last_write[w.key] = w
        for key, w in last_write.items():
            if w.status != OK:
                continue  # indeterminate tail write: either is legal
            got = final_state.get(key)
            maybe = indeterminate.get(key, ())
            # an indeterminate WRITE can explain a newer present
            # value; only an indeterminate DELETE can explain absence
            maybe_w = any(o.kind == "write" for o in maybe)
            maybe_d = any(o.kind == "delete" for o in maybe)
            if w.kind == "delete":
                if got is not None and got[1] <= w.rv:
                    err(f"acked delete op{w.op_id} of {key} "
                        f"(rv {w.rv}) LOST: key still present at "
                        f"rv {got[1]}")
                elif got is not None and not maybe_w:
                    err(f"phantom write to {key}: final rv {got[1]} "
                        f"follows acked delete op{w.op_id} "
                        f"(rv {w.rv}) with no op to explain it")
            else:
                if got is None:
                    if not maybe_d:
                        err(f"acked write op{w.op_id} of {key} "
                            f"(rv {w.rv}) LOST: key absent from "
                            "final state")
                elif got[1] < w.rv:
                    err(f"acked write op{w.op_id} of {key} "
                        f"(rv {w.rv}) LOST: final state is older "
                        f"(rv {got[1]})")
                elif got[1] == w.rv and got[0] != w.value:
                    err(f"acked write op{w.op_id} of {key} "
                        f"(rv {w.rv}) corrupted: wrote {w.value!r}, "
                        f"final state holds {got[0]!r}")
                elif got[1] > w.rv and not maybe_w:
                    err(f"phantom write to {key}: final rv {got[1]} "
                        f"follows acked op{w.op_id} (rv {w.rv}) with "
                        "no op to explain it")

    return CheckResult(ok=not errors, errors=errors,
                       checked_writes=len(writes),
                       checked_reads=n_reads)
