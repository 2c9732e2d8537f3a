"""Optimizing wave profile: device-side constraint packing.

The default (``greedy``) profile is the pod-at-a-time wave driver,
bit-identical to the Go oracle. This subsystem adds an ``optimizing``
profile (``KUBERNETES_TPU_PROFILE=optimizing``) that solves a whole
backlog wave as a joint [pods x nodes] assignment tensor on device —
auction-algorithm rounds with epsilon scaling for large waves, a top-K
beam scan for small ones — and an idle-cycle defragmentation controller
that proposes bounded migrations to un-strand free capacity.

The optimizer never decides validity: every proposed placement is
re-validated host-side against the serial predicates (the same fit
tables and exact resource mirrors the wave replay uses) before anything
binds, and a rejected placement falls back to the greedy scan for that
pod (counted in ``scheduler_optimizer_fallbacks_total``). The greedy
profile stays the default and remains bit-identical to the oracle.

Copy of kubernetes_tpu/scheduler/optimizer/__init__.py: only the import package differs.
"""

from __future__ import annotations

import logging
import os

log = logging.getLogger(__name__)

PROFILE_GREEDY = "greedy"
PROFILE_OPTIMIZING = "optimizing"

_PROFILES = (PROFILE_GREEDY, PROFILE_OPTIMIZING)


def active_profile(override: str = None) -> str:
    """The scheduling profile: an explicit override wins, else
    ``KUBERNETES_TPU_PROFILE`` (default ``greedy``; unknown values warn
    and fall back to greedy so a typo can never silently change
    placement semantics)."""
    raw = override if override is not None else os.environ.get(
        "KUBERNETES_TPU_PROFILE", "")
    raw = (raw or "").strip().lower()
    if not raw:
        return PROFILE_GREEDY
    if raw not in _PROFILES:
        log.warning(
            "unknown KUBERNETES_TPU_PROFILE=%r; using %r "
            "(known: %s)", raw, PROFILE_GREEDY, ", ".join(_PROFILES))
        return PROFILE_GREEDY
    return raw
