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
- ensure_kquantity(), ensure_ktlv(): the CPython extensions of
  native/_kquantity.c (the quantity parser's fast path, api/resource.py)
  and native/_ktlv.c (the TLV wire codec's, runtime/tlv.py), built with
  the interpreter's headers and loaded as kubernetes_tpu_torch.native.
  _kquantity and ._ktlv. A library's name carries a hash of its source
  and of the interpreter. None when they cannot be built or loaded:
  their callers run the pure-Python codecs, as in the JAX package.
- build_cuda(stem): `nvcc` of csrc/<stem>.cu for sm_90a into a shared
  library with a plain C interface. Raises when nvcc is missing or the
  build fails: a CUDA kernel has no fallback. build_cuda_file(src, name)
  does the same for a source anywhere (an earlier version of a kernel,
  to time against).
- ptxas_report(lib, kernel): registers, spills and shared memory of a
  kernel, as ptxas reported them when the library was built.
- sass_counts(lib, kernel): a kernel's static SASS instructions, in all
  and of a few kinds (shuffles, barriers, loads, stores), from
  `cuobjdump -sass`; None where cuobjdump is not found.
"""

from __future__ import annotations

import hashlib
import importlib.machinery
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import sysconfig
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


def _ensure_ext(stem: str) -> str | None:
    """Build native/<stem>.c as a CPython extension (unless this exact
    build exists) and load it as kubernetes_tpu_torch.native.<stem>. ->
    its path, or None when it cannot be built or loaded."""
    name = f"kubernetes_tpu_torch.native.{stem}"
    mod = sys.modules.get(name)
    if mod is not None:
        return mod.__file__
    inc = sysconfig.get_paths().get("include")
    cc = _c_compiler()
    if not inc or not os.path.exists(os.path.join(inc, "Python.h")) \
            or cc is None:
        return None
    src = os.path.join(_PKG_DIR, "native", f"{stem}.c")
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + sys.version.encode()
                             + suffix.encode() + inc.encode())
    out = os.path.join(BUILD_DIR, f"{stem}-{key.hexdigest()[:16]}{suffix}")
    if not os.path.exists(out):
        proc = _compile([cc, "-O2", "-fPIC", "-Wall", "-shared", f"-I{inc}"],
                        src, out)
        if proc.returncode != 0:
            _warn_once(f"cc-fail-{stem}",
                       f"building {stem} failed:\n{proc.stderr}")
            return None
    try:
        loader = importlib.machinery.ExtensionFileLoader(name, out)
        spec = importlib.util.spec_from_file_location(name, out,
                                                      loader=loader)
        mod = importlib.util.module_from_spec(spec)
        loader.exec_module(mod)
    except Exception as exc:
        _warn_once(f"load-{stem}", f"loading {out} raised {exc!r}")
        return None
    sys.modules[name] = mod
    setattr(sys.modules["kubernetes_tpu_torch.native"], stem, mod)
    return out


def ensure_kquantity() -> str | None:
    return _ensure_ext("_kquantity")


def ensure_ktlv() -> str | None:
    return _ensure_ext("_ktlv")


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


#: the SASS opcodes sass_counts counts apart
SASS_KINDS = ("SHFL", "BAR", "LDG", "STG", "LDS", "STS", "VOTE")
_SASS: dict[str, str] = {}
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[0-9T]+\s+)?"
                      r"([A-Z][A-Z0-9_]*)")


def sass_counts(lib: str, kernel: str) -> dict | None:
    """-> parse_sass of `cuobjdump -sass lib` for the kernel whose mangled
    name contains `kernel`, or None where cuobjdump is not found (the
    disassembly is kept per library)."""
    if lib not in _SASS:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                         "cuobjdump")
        if not os.path.exists(tool):
            return None
        _SASS[lib] = subprocess.run([tool, "-sass", lib], capture_output=True,
                                    text=True, timeout=120).stdout
    return parse_sass(_SASS[lib], kernel)


def parse_sass(text: str, kernel: str) -> dict:
    """cuobjdump -sass output -> {"instructions": the kernel's static
    instructions but NOP, and one count for each of SASS_KINDS}; {} when
    no function's name contains `kernel`."""
    out, mine = {}, False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if mine:
                break
            mine = kernel in m.group(1)
            if mine:
                out = dict.fromkeys(("instructions", *SASS_KINDS), 0)
            continue
        m = _SASS_OP.search(line) if mine else None
        if m and m.group(1) != "NOP":
            out["instructions"] += 1
            if m.group(1) in SASS_KINDS:
                out[m.group(1)] += 1
    return out


def _warn_once(key: str, msg: str) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        print(f"kubernetes_tpu_torch/native: {msg}", file=sys.stderr)
