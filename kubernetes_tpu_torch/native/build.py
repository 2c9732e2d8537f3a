"""On-demand builds of the port's native code into build/torch_kernels/.

Modelled on kubernetes_tpu/native/build.py, with one difference: the
libraries go to the git-ignored build/torch_kernels/ directory at the
repository root, never into the package. Builds are cached by source
mtime and written atomically (compile to a temporary name, then
os.replace), so concurrent builders never load a half-written library.

- ensure_replay(): `cc -O2 -shared` of native/replay.c, the host replay
  engine that models/replay.py loads with ctypes. None when no C
  compiler is present: models/replay then runs its spec replay, as the
  JAX package does.
- build_cuda(stem): `nvcc` of csrc/<stem>.cu for sm_90a into a shared
  library with a plain C interface. Raises when nvcc is missing or the
  build fails: a CUDA kernel has no fallback.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
_WARNED: set[str] = set()

#: nvcc flags of every CUDA kernel: Hopper's sm_90a, and no FMA
#: contraction, so a*b+c rounds twice as the reference's XLA code does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC")


def _stale(src: str, out: str) -> bool:
    try:
        return os.path.getmtime(out) < os.path.getmtime(src)
    except OSError:
        return True


def _compile(cmd_head: list, src: str, out: str) -> subprocess.CompletedProcess:
    """Run `cmd_head -o <tmp> src`, then move tmp onto out atomically."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([*cmd_head, "-o", tmp, src],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode == 0:
            os.replace(tmp, out)
        return proc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _c_compiler() -> str | None:
    for cand in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if cand and shutil.which(cand):
            return cand
    return None


def ensure_replay() -> str | None:
    """Build (if stale or absent) and return the path to _replay.so."""
    src = os.path.join(_PKG_DIR, "native", "replay.c")
    out = os.path.join(BUILD_DIR, "_replay.so")
    if not _stale(src, out):
        return out
    cc = _c_compiler()
    if cc is None:
        _warn_once("no-cc", "no C compiler found; the host replay runs "
                   "the pure-Python spec replay")
        return None
    proc = _compile([cc, "-O2", "-fPIC", "-Wall", "-shared"], src, out)
    if proc.returncode != 0:
        _warn_once("cc-fail", f"building _replay.so failed:\n{proc.stderr}")
        return None
    return out


def _nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                           "CUDA kernels cannot be built")
    return path


def build_cuda(stem: str) -> str:
    """Build csrc/<stem>.cu (if stale or absent) -> path of lib<stem>.so."""
    src = os.path.join(_PKG_DIR, "csrc", f"{stem}.cu")
    out = os.path.join(BUILD_DIR, f"lib{stem}.so")
    if not _stale(src, out):
        return out
    proc = _compile([_nvcc_path(), *NVCC_FLAGS], src, out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return out


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"kubernetes_tpu_torch/native: {msg}", file=sys.stderr)
