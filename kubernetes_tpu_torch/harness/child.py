"""The port's command-line programs as child processes: `hyperkube`
subcommands whose output lines are gathered as they come, and one-shot
`kubectl` runs.

A Child is registered with `harness.procs.supervise` (its interpreter's
exit SIGKILLs it if nothing stopped it first) and leads a session of its
own, so that a signal to the caller's process group does not reach it
twice and the caller can tell its processes from the ones it started.
"""

from __future__ import annotations

import re
import signal
import subprocess
import sys
import threading
import time
from typing import Optional

from kubernetes_tpu_torch.harness.perf import _child_env
from kubernetes_tpu_torch.harness.procs import supervise

HYPERKUBE = [sys.executable, "-m", "kubernetes_tpu_torch.hyperkube"]
KUBECTL = [sys.executable, "-m", "kubernetes_tpu_torch.kubectl"]
#: the first URL a server prints on start
URL = r"http://[0-9.]+:[0-9]+"


def child_env(**extra) -> dict:
    """The harness's environment for a child interpreter (the checkout
    first on PYTHONPATH) with no stack sampler armed unless extra arms
    one."""
    env = _child_env()
    env.pop("KUBERNETES_TPU_PROFILE", None)
    env.update(extra)
    return env


class Child:
    """One child process, its standard output and error gathered as
    lines by a thread."""

    def __init__(self, name: str, argv: list, env: Optional[dict] = None,
                 cwd: Optional[str] = None):
        self.name = name
        self.proc = supervise(subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env or child_env(), cwd=cwd,
            start_new_session=True))
        self.lines: list = []
        self.eof = False
        self._cond = threading.Condition()
        threading.Thread(target=self._read, daemon=True,
                         name=f"out-{name}").start()

    @classmethod
    def hyperkube(cls, name: str, args: list, **kw) -> "Child":
        return cls(name, HYPERKUBE + args, **kw)

    def _read(self):
        for line in self.proc.stdout:
            with self._cond:
                self.lines.append(line.rstrip("\n"))
                self._cond.notify_all()
        with self._cond:
            self.eof = True
            self._cond.notify_all()

    def wait_line(self, pattern: str, timeout: float = 120.0) -> re.Match:
        """The first output line that matches pattern; raises
        AssertionError when the process ends or the time runs out
        first."""
        rx = re.compile(pattern)
        deadline = time.monotonic() + timeout
        with self._cond:
            while True:
                for line in self.lines:
                    m = rx.search(line)
                    if m:
                        return m
                left = deadline - time.monotonic()
                if self.eof or left <= 0:
                    raise AssertionError(
                        f"{self.name}: no line matching {pattern!r} "
                        f"(exit {self.proc.poll()}): "
                        + " | ".join(self.lines[-20:]))
                self._cond.wait(left)

    def output(self) -> str:
        """Every line so far."""
        with self._cond:
            return "\n".join(self.lines)

    def stop(self, sig=signal.SIGTERM, timeout: float = 30.0) -> int:
        """Sends sig, waits, and kills after timeout -> the exit code."""
        if self.proc.poll() is None:
            self.proc.send_signal(sig)
            try:
                self.proc.wait(timeout)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def kubectl(url: str, *args, timeout: float = 120.0) -> str:
    """One `python -m kubernetes_tpu_torch.kubectl -s URL ...` run -> its
    standard output; raises AssertionError on a non-zero exit."""
    proc = subprocess.run(KUBECTL + ["-s", url, *args], capture_output=True,
                          text=True, env=child_env(), timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(f"kubectl {' '.join(args)}: exit "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout
