"""Data-race sanitizer: Eraser-style locksets + vector-clock
happens-before over tracked shared objects — TSan-lite for the
threaded control plane.

The GIL hides unsynchronized shared-state access until a bytecode
boundary lands mid-invariant under load; the lock-ORDER sanitizer
(analysis/locks) catches deadlocks but says nothing about the far more
common bug: two threads touching the same attribute with no common
lock and no ordering. This module makes that checkable at runtime:

* ``track(obj)`` (or the ``@shared`` class decorator) retypes a live
  object into an instrumented subclass whose ``__getattribute__`` /
  ``__setattr__`` record every *data-attribute* access: the accessing
  thread, the set of ``TrackedLock``\\ s held (analysis/locks supplies
  the held-set), the thread's vector clock, and a sample stack.  The
  control-plane singletons register themselves when the detector is
  armed: store maps, the cacher ring+snapshot, the transport pool,
  replication state, the scheduler FIFO/cache, the resident mirrors.

* **Happens-before** edges come from lock release→acquire (hooked into
  ``TrackedLock``), ``Thread.start``/``join`` (patched while armed),
  and queue ``put``→``get`` (``note_put``/``note_get`` hooks in
  WorkQueue / DelayingQueue / FIFO / DeltaFIFO) — each sync object
  carries a vector clock joined conservatively, so a legitimate
  cross-thread handoff never reports.

* A **race** is two accesses to the same (object, attribute) from
  different threads, at least one a write, whose locksets do not
  intersect and between which no happens-before edge exists.  The
  finding carries BOTH sample stacks.

The model is attribute-level: rebind-style updates (``self.x = ...``,
``self.x += 1``) are writes; container-interior mutation
(``self._data[k] = v``) appears as a *read* of the attribute — the
static guarded-by lint (analysis/lint) covers declared containers, and
the repo's guarded classes rebind or hold their lock for interior
mutation anyway.

Suppression: a deliberate benign race is annotated at either access
site with ``# race: allow[reason]`` on the access line (or the line
above).  Suppressed findings stay counted in the report, like lint.

Arming mirrors the lock sanitizer: per-test/standalone via

    with races.instrumented(reset=True):
        ... drive components ...
    races.assert_no_races()

and suite-wide via ``KUBERNETES_TPU_RACE_SANITIZER=1`` (conftest wraps
every test).  Objects created before arming stay raw and invisible —
the witness suites build their components inside the armed window.
All ``track``/``note_*`` entry points are single-flag-check no-ops
while disarmed, so the production hot path pays one global read.

Copy of kubernetes_tpu/analysis/races.py: only the import package differs.
"""

from __future__ import annotations

import itertools
import json
import linecache
import os
import re
import sys
import threading
import weakref
from contextlib import contextmanager
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from kubernetes_tpu_torch.analysis import Finding
from kubernetes_tpu_torch.analysis import locks as _locks

#: single global arm flag — every product-code hook checks it first
_armed = False

_THIS_FILE = os.path.abspath(__file__)
_LOCKS_FILE = os.path.abspath(_locks.__file__)

_SUPPRESS_RE = re.compile(r"#\s*race:\s*allow\[([^\]]*)\]")

#: frames kept per sample stack
_STACK_DEPTH = 8

_real_lock = threading.Lock


# -- vector clocks ------------------------------------------------------------

_tid_counter = itertools.count(1)


def _join_into(dst: Dict[int, int], src: Dict[int, int]) -> None:
    for k, v in src.items():
        if dst.get(k, 0) < v:
            dst[k] = v


class _TLS(threading.local):
    """Per-thread detector state: a stable id, the vector clock, and a
    reentrancy depth so detector internals never record themselves."""

    def __init__(self):
        self.depth = 1  # guard while we initialize
        self.tid = next(_tid_counter)
        vc: Dict[int, int] = {self.tid: 1}
        cur = threading.current_thread()
        parent = getattr(cur, "_race_parent_vc", None)
        if parent:
            _join_into(vc, parent)
        self.vc = vc
        # published for Thread.join: the dict is mutated only by this
        # thread and read by joiners only after the thread is dead
        cur._race_vc = vc
        self.depth = 0


_tls = _TLS()

# -- sync-object clocks (locks, queues): release/put publishes, ---------------
# -- acquire/get adopts -------------------------------------------------------

_sync_mu = _real_lock()
_sync_vcs: Dict[int, Dict[int, int]] = {}
_sync_finalized: Set[int] = set()


def _sync_id(obj) -> int:
    """id(obj) with weakref-safe cleanup: the registry must never pin a
    sync object (the cacher feed holds its cacher only weakly — a
    tracked registration that pinned it would leak every discarded
    apiserver's caches)."""
    i = id(obj)
    with _sync_mu:
        if i in _sync_finalized:
            return i
        _sync_finalized.add(i)
    try:
        weakref.finalize(obj, _forget_sync, i)
    except TypeError:
        pass  # non-weakrefable sync objects just persist until reset()
    return i


def _forget_sync(i: int) -> None:
    with _sync_mu:
        _sync_vcs.pop(i, None)
        _sync_finalized.discard(i)


def note_put(channel) -> None:
    """Publish a happens-before edge source: everything this thread did
    so far happens-before any later ``note_get`` on ``channel``.
    Deliberately conservative (any put orders before any later get)."""
    if not _armed:
        return
    st = _tls
    if st.depth:
        return
    st.depth = 1
    try:
        i = _sync_id(channel)
        with _sync_mu:
            cvc = _sync_vcs.get(i)
            if cvc is None:
                cvc = _sync_vcs[i] = {}
            _join_into(cvc, st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1
    finally:
        st.depth = 0


def note_get(channel) -> None:
    """Adopt the channel's published clock: the getter now
    happens-after every prior put."""
    if not _armed:
        return
    st = _tls
    if st.depth:
        return
    st.depth = 1
    try:
        with _sync_mu:
            cvc = _sync_vcs.get(id(channel))
            if cvc:
                _join_into(st.vc, cvc)
    finally:
        st.depth = 0


# lock release == put, lock acquire == get (release→acquire edges)
def _on_lock_release(lock) -> None:
    note_put(lock)


def _on_lock_acquire(lock) -> None:
    note_get(lock)


# -- Thread.start / Thread.join edges ----------------------------------------

_orig_start = threading.Thread.start
_orig_join = threading.Thread.join


def _patched_start(self):
    st = _tls
    if not st.depth:
        self._race_parent_vc = dict(st.vc)
        st.vc[st.tid] = st.vc.get(st.tid, 0) + 1
    return _orig_start(self)


def _patched_join(self, timeout=None):
    r = _orig_join(self, timeout)
    if not self.is_alive():
        final = getattr(self, "_race_vc", None)
        if final is not None:
            # the child is dead: its clock dict is stable now
            _join_into(_tls.vc, final)
    return r


# -- tracked objects ----------------------------------------------------------


class _ObjInfo:
    __slots__ = ("label", "fields")

    def __init__(self, label: str, fields: Set[str]):
        self.label = label
        self.fields = fields


_obj_mu = _real_lock()
_obj_info: Dict[int, _ObjInfo] = {}  # id(tracked obj) -> info

_class_cache: Dict[type, type] = {}


def _forget_obj(i: int) -> None:
    with _obj_mu:
        _obj_info.pop(i, None)


def _traced_class(cls: type) -> type:
    sub = _class_cache.get(cls)
    if sub is not None:
        return sub

    def __getattribute__(self, name):
        v = object.__getattribute__(self, name)
        if _armed:
            info = _obj_info.get(id(self))
            if info is not None and name in info.fields:
                _record(info, name, False)
        return v

    def __setattr__(self, name, value):
        if _armed and not name.startswith("_race"):
            info = _obj_info.get(id(self))
            if info is not None:
                info.fields.add(name)
                _record(info, name, True)
        object.__setattr__(self, name, value)

    def __delattr__(self, name):
        if _armed:
            info = _obj_info.get(id(self))
            if info is not None and name in info.fields:
                _record(info, name, True)
        object.__delattr__(self, name)

    sub = type(cls.__name__, (cls,), {
        "__slots__": (),
        "__getattribute__": __getattribute__,
        "__setattr__": __setattr__,
        "__delattr__": __delattr__,
        "_race_traced_base": cls,
    })
    sub.__qualname__ = cls.__qualname__
    sub.__module__ = cls.__module__
    _class_cache[cls] = sub
    return sub


def track(obj, label: Optional[str] = None):
    """Instrument attribute reads/writes on ``obj``. A no-op (one flag
    check) while the detector is disarmed; registration is weakref-safe
    — tracking never extends the object's lifetime."""
    if not _armed:
        return obj
    cls = type(obj)
    base = getattr(cls, "_race_traced_base", None)
    if base is None:
        try:
            obj.__class__ = _traced_class(cls)
        except TypeError:
            return obj  # C-level layout we cannot retype: stay raw
    i = id(obj)
    with _obj_mu:
        if i in _obj_info:
            return obj
        fields: Set[str] = set()
        d = getattr(obj, "__dict__", None)
        if d:
            fields.update(k for k in d if not k.startswith("_race"))
        _obj_info[i] = _ObjInfo(
            label or (base or cls).__name__, fields)
    try:
        weakref.finalize(obj, _forget_obj, i)
    except TypeError:
        pass
    return obj


def shared(arg):
    """Class decorator: every instance self-registers with ``track``
    at construction (armed windows only; free otherwise).  Usable bare
    (``@shared``) or with a label (``@shared("storage.Store")``)."""
    def wrap(cls, label):
        orig = cls.__init__

        def __init__(self, *a, **k):
            orig(self, *a, **k)
            track(self, label)

        __init__.__name__ = "__init__"
        __init__.__qualname__ = f"{cls.__qualname__}.__init__"
        cls.__init__ = __init__
        return cls

    if isinstance(arg, str):
        return lambda cls: wrap(cls, arg)
    return wrap(arg, arg.__name__)


# -- access recording + race detection ---------------------------------------


class _Access:
    __slots__ = ("tid", "clock", "write", "lockset", "frames", "site",
                 "thread_name")

    def __init__(self, tid: int, clock: int, write: bool,
                 lockset: FrozenSet[int],
                 frames: Tuple[Tuple[str, int, str], ...],
                 thread_name: str):
        self.tid = tid
        self.clock = clock
        self.write = write
        self.lockset = lockset
        self.frames = frames
        self.site = (f"{frames[0][0]}:{frames[0][1]}" if frames
                     else "<unknown>")
        self.thread_name = thread_name


class _Loc:
    """Access history of one (object, attribute): the last read and the
    last write per thread — the Eraser/FastTrack bound."""

    __slots__ = ("reads", "writes")

    def __init__(self):
        self.reads: Dict[int, _Access] = {}
        self.writes: Dict[int, _Access] = {}


_det_mu = _real_lock()
_locations: Dict[Tuple[int, str], _Loc] = {}
_reports: Dict[Tuple[str, str, frozenset], Finding] = {}


def _capture_frames() -> Tuple[Tuple[str, int, str], ...]:
    """The innermost non-detector frames as (file, line, function),
    cheapest-possible (no source formatting until report time)."""
    out = []
    f = sys._getframe(2)
    while f is not None and len(out) < _STACK_DEPTH:
        fn = f.f_code.co_filename
        if fn != _THIS_FILE and fn != _LOCKS_FILE:
            out.append((fn, f.f_lineno, f.f_code.co_name))
        f = f.f_back
    return tuple(out)


def _site_allowed(site_frames) -> Optional[str]:
    """The ``# race: allow[reason]`` annotation at the access line (or
    the line above), if present."""
    if not site_frames:
        return None
    fn, lineno, _name = site_frames[0]
    for ln in (lineno, lineno - 1):
        m = _SUPPRESS_RE.search(linecache.getline(fn, ln))
        if m:
            return m.group(1)
    return None


def _relpath(p: str) -> str:
    try:
        return os.path.relpath(p)
    except ValueError:
        return p


def _format_stack(acc: _Access) -> str:
    lines = []
    for fn, lineno, name in acc.frames:
        lines.append(f"    {_relpath(fn)}:{lineno} in {name}")
        src = linecache.getline(fn, lineno).strip()
        if src:
            lines.append(f"        {src}")
    return "\n".join(lines)


def _report(label: str, attr: str, prior: _Access, cur: _Access) -> None:
    key = (label, attr, frozenset((prior.site, cur.site)))
    if key in _reports:
        return
    reason = _site_allowed(cur.frames) or _site_allowed(prior.frames)
    kind = ("write/write" if prior.write and cur.write
            else "read/write" if cur.write else "write/read")
    msg = (
        f"{kind} race on {label}.{attr}: no common lock, no "
        f"happens-before edge.\n"
        f"  access A ({'write' if prior.write else 'read'}, thread "
        f"{prior.thread_name}, {len(prior.lockset)} lock(s) held):\n"
        f"{_format_stack(prior)}\n"
        f"  access B ({'write' if cur.write else 'read'}, thread "
        f"{cur.thread_name}, {len(cur.lockset)} lock(s) held):\n"
        f"{_format_stack(cur)}"
    )
    if reason:
        msg += f"\n  suppressed: allow[{reason}]"
    _reports[key] = Finding(
        "races", "data-race", f"{label}.{attr} @ {cur.site}", msg,
        suppressed=reason is not None,
    )


def _record(info: _ObjInfo, attr: str, write: bool) -> None:
    st = _tls
    if st.depth:
        return
    st.depth = 1
    try:
        frames = _capture_frames()
        lockset = frozenset(id(h) for h in _locks._tls.held)
        cur = _Access(st.tid, st.vc.get(st.tid, 0), write, lockset,
                      frames, threading.current_thread().name)
        vc = st.vc
        key = (id(info), attr)
        with _det_mu:
            loc = _locations.get(key)
            if loc is None:
                loc = _locations[key] = _Loc()
            # a new WRITE races with prior reads AND writes from other
            # threads; a new READ races with prior writes only
            others = list(loc.writes.values())
            if write:
                others += list(loc.reads.values())
            for prior in others:
                if prior.tid == cur.tid:
                    continue
                if vc.get(prior.tid, 0) >= prior.clock:
                    continue  # happens-before: ordered
                if lockset & prior.lockset:
                    continue  # common lock: mutually excluded
                _report(info.label, attr, prior, cur)
            (loc.writes if write else loc.reads)[cur.tid] = cur
    finally:
        st.depth = 0


# -- arming -------------------------------------------------------------------

_installed = 0
_install_mu = _real_lock()


def install() -> None:
    """Arm the detector: lock creation tracking (analysis/locks), lock
    release→acquire HB hooks, Thread start/join edges, and the
    track()/note_*() entry points."""
    global _installed, _armed
    with _install_mu:
        _installed += 1
        if _installed == 1:
            _locks.install()
            _locks.race_acquire_hook = _on_lock_acquire
            _locks.race_release_hook = _on_lock_release
            threading.Thread.start = _patched_start
            threading.Thread.join = _patched_join
            _armed = True


def uninstall() -> None:
    global _installed, _armed
    with _install_mu:
        _installed = max(0, _installed - 1)
        if _installed == 0:
            _armed = False
            threading.Thread.start = _orig_start
            threading.Thread.join = _orig_join
            _locks.race_acquire_hook = None
            _locks.race_release_hook = None
            _locks.uninstall()


def reset() -> None:
    """Clear access history + findings (per-test isolation). Thread
    vector clocks persist — ordering established earlier stays true."""
    with _det_mu:
        _locations.clear()
        _reports.clear()


@contextmanager
def instrumented(reset: bool = False):
    """Arm the race detector for the duration of the block."""
    if reset:
        globals()["reset"]()
    install()
    try:
        yield sys.modules[__name__]
    finally:
        uninstall()


def findings() -> List[Finding]:
    with _det_mu:
        return list(_reports.values())


def assert_no_races(context: str = "") -> None:
    """Raise AssertionError listing every unsuppressed race observed."""
    found = findings()
    if any(not f.suppressed for f in found):
        from kubernetes_tpu_torch.analysis import render_report

        raise AssertionError(
            render_report(found, f"data races {context}:"))


def dump_jsonl(path: str, append: bool = True) -> int:
    """Write the observed findings as JSON lines (the CI artifact the
    ``--race-report`` CLI flag merges back into the gate report).
    Returns the number of rows written."""
    rows = findings()
    if not rows:
        return 0
    with open(path, "a" if append else "w", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps({
                "pass": r.pass_name, "rule": r.rule, "where": r.where,
                "message": r.message, "suppressed": r.suppressed,
            }) + "\n")
    return len(rows)
