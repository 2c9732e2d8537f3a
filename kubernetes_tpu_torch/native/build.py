"""On-demand builds of the port's native code into build/torch_kernels/.

Modelled on kubernetes_tpu/native/build.py, with one difference: the
libraries go to the git-ignored build/torch_kernels/ directory at the
repository root, never into the package. Builds are written atomically
(compile to a temporary name, then os.replace), so concurrent builders
never load a half-written library. The replay library is cached by
source mtime; a CUDA library's name carries a hash of its source, the
csrc/ headers it includes and NVCC_FLAGS, so a change to any of them
builds it anew.

- ensure_replay(): `cc -O2 -shared` of native/replay.c, the host replay
  engine that models/replay.py loads with ctypes. None when no C
  compiler is present: models/replay then runs its spec replay, as the
  JAX package does.
- build_cuda(stem): `nvcc` of csrc/<stem>.cu for sm_90a into a shared
  library with a plain C interface. Raises when nvcc is missing or the
  build fails: a CUDA kernel has no fallback. build_cuda_file(src, name)
  does the same for a source anywhere (an earlier version of a kernel,
  to time against).
- ptxas_report(lib, kernel): registers, spills and shared memory of a
  kernel, as ptxas reported them when the library was built.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import sys
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")
_WARNED: set[str] = set()

#: nvcc flags of every CUDA kernel: Hopper's sm_90a, no FMA contraction
#: (so a*b+c rounds twice, as the oracle does), and ptxas's per-kernel
#: report of registers, spills and shared memory
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v")
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.M)


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


def cuda_build_key(src: str) -> str:
    """Hash of what a CUDA build depends on: NVCC_FLAGS, the source, and
    each header it includes with #include "..." (found beside the source
    or in csrc/, followed recursively)."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    seen, todo = set(), [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as f:
            text = f.read()
        h.update(b"\0" + text)
        for name in _INCLUDE.findall(text.decode(errors="replace")):
            for d in (os.path.dirname(path), os.path.join(_PKG_DIR, "csrc")):
                cand = os.path.join(d, name)
                if os.path.exists(cand):
                    todo.append(os.path.abspath(cand))
                    break
    return h.hexdigest()[:16]


def build_cuda_file(src: str, name: str) -> str:
    """Build the CUDA source src (unless this exact build exists) ->
    path of lib<name>-<key>.so; nvcc's report is kept beside it as
    lib<name>-<key>.log."""
    out = os.path.join(BUILD_DIR, f"lib{name}-{cuda_build_key(src)}.so")
    log = out[:-3] + ".log"
    if os.path.exists(out) and os.path.exists(log):
        return out
    proc = _compile([_nvcc_path(), *NVCC_FLAGS], src, out)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    return out


def build_cuda(stem: str) -> str:
    """Build csrc/<stem>.cu (unless built) -> path of its library."""
    return build_cuda_file(os.path.join(_PKG_DIR, "csrc", f"{stem}.cu"),
                           stem)


def ptxas_report(lib: str, kernel: str) -> dict:
    """-> {"registers", "spill_stores", "spill_loads", "stack", "smem"}
    (ints; bytes except registers) of the kernel whose mangled name
    contains `kernel`, from the build log beside the library lib."""
    with open(lib[:-3] + ".log") as f:
        return parse_ptxas(f.read(), kernel)


def parse_ptxas(log: str, kernel: str) -> dict:
    """ptxas -v output -> the report of ptxas_report for one kernel."""
    out, mine = {}, False
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", line)
        if m:
            mine = kernel in m.group(1)
            continue
        if not mine:
            continue
        for key, pat in (("stack", r"(\d+) bytes stack frame"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("registers", r"Used (\d+) registers"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, line)
            if m:
                out[key] = int(m.group(1))
    return out


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"kubernetes_tpu_torch/native: {msg}", file=sys.stderr)
