"""The wait idioms of the port's utils/wait.py (a copy of the JAX
package's): tests/test_utils.py's TestWait cases, run against the
port's copy."""

import threading

from kubernetes_tpu_torch.utils import FakeClock
from kubernetes_tpu_torch.utils.wait import poll_until, until


class TestWait:
    def test_until_runs_and_stops(self):
        stop = threading.Event()
        count = []

        def body():
            count.append(1)
            if len(count) >= 3:
                stop.set()

        until(body, 0.001, stop)
        assert len(count) >= 3

    def test_until_contains_crash(self):
        stop = threading.Event()
        count = []

        def body():
            count.append(1)
            if len(count) >= 2:
                stop.set()
            raise RuntimeError("boom")

        until(body, 0.001, stop)  # must not raise
        assert len(count) >= 2

    def test_poll_until(self):
        clock = FakeClock()
        state = {"n": 0}

        def cond():
            state["n"] += 1
            return state["n"] >= 3

        assert poll_until(cond, 1.0, 10.0, clock=clock)
        assert not poll_until(lambda: False, 1.0, 3.0, clock=clock)
