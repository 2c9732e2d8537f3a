"""AST lint: repo-specific static rules over the whole port.

Four rule families:

* **Program-scope rules** apply only inside the device programs'
  functions: the device functions of each program that
  analysis/programs.build_programs registers (PROGRAM_SEEDS), closed
  over name-resolvable calls in the hot packages (``models/``, ``ops/``,
  ``snapshot/``, ``parallel/``, ``scheduler/optimizer/ops/``):

    - ``host-sync``       .item() / .tolist() / .cpu() / .numpy() /
                          torch.cuda.synchronize() / np.asarray inside a
                          program — each reads device data on the host
                          (a sync per dispatch, or per scan step)
    - ``traced-impure``   wall-clock reads, print/open, and the global
                          RNG (torch.rand* without generator=, random.*,
                          np.random.*) inside a program

  The collect functions, where a dispatch's one device-to-host copy
  happens (models/probe.py WaveProbe.probe, probe_fused_collect,
  probe_group; models/batch.py schedule), are not seeds:
  analysis/program_audit counts those transfers.

* **Package-wide rules** apply everywhere under ``kubernetes_tpu_torch/``:

    - ``bare-except``       ``except:`` swallows KeyboardInterrupt and
                            SystemExit; name the exception
    - ``mutable-default``   mutable default argument values
    - ``nondaemon-thread``  a non-daemon Thread with no ``.join`` in its
                            module outlives shutdown and wedges exit
    - ``metric-outside-registry``  Counter/Gauge/Histogram constructed
                            outside metrics/metrics.py bypass the
                            duplicate-name registry

* **Scoped rules** apply to named consensus-critical modules only:

    - ``wall-clock-deadline``  ``time.time()`` feeding timeout / lease /
                            deadline arithmetic in ``storage/quorum/``,
                            ``client/transport.py``, or
                            ``apiserver/flowcontrol.py`` — NTP steps
                            the wall clock; election timers and leases
                            must use ``time.monotonic()``

* **Concurrency rules** (the static companion of analysis/races):
  ``guarded-by`` and ``unguarded-shared-write``, as in the JAX package.

Suppression: append ``# lint: allow[rule]`` (comma-separate several
rule ids) on the offending line or the line directly above it.
Suppressed findings still appear in the report, marked, so allowance
drift stays visible.

Deviation from kubernetes_tpu/analysis/lint.py <module>: the JAX
traced-scope family (seeded by jax.jit / vmap / lax.scan / shard_map
call sites) becomes the program-scope family above, seeded by the
registered programs' device functions (the port has no tracing entry
point to find them by); its host-sync rule reads .cpu()/.numpy()/
.tolist() and torch.cuda.synchronize where the JAX one reads
block_until_ready and jax.device_get, and its impurity rule reads
torch's global RNG. The package-wide, scoped and concurrency rules, the
suppression syntax and the report are the JAX lint's, their functions
verbatim copies (tests/test_torch_isolation.py FUNCTION_COPIES).
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Set, Tuple

from kubernetes_tpu_torch.analysis import Finding

#: packages whose program scopes get the host-sync/impurity rules
HOT_PREFIXES = (
    "kubernetes_tpu_torch.models",
    "kubernetes_tpu_torch.ops",
    "kubernetes_tpu_torch.snapshot",
    "kubernetes_tpu_torch.parallel",
    "kubernetes_tpu_torch.scheduler.optimizer.ops",
)

#: the device functions of each program analysis/programs.build_programs
#: registers, by program name: the program scope's seeds. The collect
#: functions (the one device-to-host copy a dispatch) are not seeds;
#: analysis/program_audit counts their transfers.
PROGRAM_SEEDS: Dict[str, Tuple[Tuple[str, str], ...]] = {
    "scan": (("models.batch", "_scan_fn"),),
    "probe": (("models.probe", "_probe_fn"),),
    "probe_pallas": (("models.probe", "_probe_fn"),),
    "probe_quant_int8": (("models.probe", "_probe_fn"),),
    "probe_quant_int16": (("models.probe", "_probe_fn"),),
    "probe_fused_same": (("models.probe", "probe_fused_dispatch"),
                         ("models.wave", "_apply_fn")),
    "group_probe_G8": (("models.probe", "_group_probe_fn"),),
    "group_probe_G16": (("models.probe", "_group_probe_fn"),),
    "group_probe_G32": (("models.probe", "_group_probe_fn"),),
    "apply_group": (("models.wave", "_apply_group_fn"),),
    "apply": (("models.wave", "_apply_fn"),),
    "zreplay": (("models.zreplay", "dispatch"),
                ("models.wave", "_apply_fn")),
    "zreplay_group": (("models.zreplay", "dispatch_group"),
                      ("models.wave", "_apply_fn"),
                      ("models.wave", "_apply_group_fn")),
    "victim_score": (("ops.preempt_kernel", "victim_score"),),
    "assign_auction": (("scheduler.optimizer.ops.assign_kernel",
                        "auction_assign"),),
    "assign_beam": (("scheduler.optimizer.ops.assign_kernel",
                     "beam_assign"),),
    "mesh_scan": (("parallel.mesh", "_mesh_scan_fn"),),
    "mesh_probe": (("parallel.mesh", "_mesh_probe_fn"),),
    "mesh_group_probe": (("parallel.mesh", "_mesh_group_probe_fn"),),
    "mesh_apply": (("parallel.mesh", "_mesh_apply_fn"),),
    "mesh_apply_group": (("parallel.mesh", "_mesh_apply_group_fn"),),
    "resident_scatter": (("parallel.resident_kernel", "scatter_shipment"),),
}
_PKG = "kubernetes_tpu_torch"

_SUPPRESS_RE = re.compile(r"#\s*lint:\s*allow\[([A-Za-z0-9_,\- ]+)\]")
_GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][\w.]*)")

#: container-mutator method names that count as WRITES to the receiver
#: field for the guarded-by / thread-escape checks
_MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "clear", "add", "discard", "update",
    "setdefault", "sort", "reverse",
}
#: function-form mutators: fn(self.field, ...) mutates arg 0
_MUTATOR_FUNCS = {"heappush", "heappop", "heapify", "heapreplace"}

_METRIC_CLASSES = {"Counter", "Gauge", "GaugeVec", "Histogram",
                   "HistogramVec"}
_METRIC_HOME = "kubernetes_tpu_torch.metrics.metrics"

#: tensor methods that read a device value on the host
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_NP_SYNC_FUNCS = {"asarray", "array", "ascontiguousarray"}
_TIME_FUNCS = {"time", "monotonic", "perf_counter", "sleep",
               "process_time", "time_ns", "monotonic_ns",
               "perf_counter_ns"}
#: torch's global-RNG draws (impure unless given a generator=)
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "bernoulli", "multinomial",
              "normal", "poisson"}


def _dotted(node: ast.AST) -> Optional[str]:
    """'a.b.c' for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


class _Module:
    """One parsed module: alias maps, function table, seeds, edges."""

    def __init__(self, relpath: str, modname: str, text: str):
        self.relpath = relpath
        self.modname = modname
        self.text = text
        self.tree = ast.parse(text, filename=relpath)
        self.lines = text.splitlines()
        # line -> set of allowed rule ids (same line or one above)
        self.allow: Dict[int, Set[str]] = {}
        # line -> guard name declared by a `# guarded-by: self._lock`
        # trailing comment (looked up at the line or the line above)
        self.guard_at: Dict[int, str] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")}
                self.allow.setdefault(i, set()).update(rules)
                self.allow.setdefault(i + 1, set()).update(rules)
            g = _GUARDED_RE.search(line)
            if g:
                self.guard_at[i] = g.group(1)
        # import resolution
        self.mod_alias: Dict[str, str] = {}  # local name -> module path
        self.from_funcs: Dict[str, Tuple[str, str]] = {}  # name -> (mod, fn)
        self.np_aliases: Set[str] = set()
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    local = a.asname or a.name.split(".")[0]
                    self.mod_alias[local] = a.name if a.asname else \
                        a.name.split(".")[0]
                    if a.name == "numpy":
                        self.np_aliases.add(local)
            elif isinstance(node, ast.ImportFrom) and node.module:
                src = node.module
                if node.level:  # relative import: resolve in-package
                    base = self.modname.split(".")
                    src = ".".join(base[: len(base) - node.level]
                                   + ([src] if src else []))
                for a in node.names:
                    local = a.asname or a.name
                    target = f"{src}.{a.name}"
                    if target == "numpy":
                        self.np_aliases.add(local)
                    # a from-import may bind a submodule OR a function;
                    # record both interpretations, resolution prefers
                    # the function table
                    self.mod_alias.setdefault(local, target)
                    self.from_funcs[local] = (src, a.name)
        # function table: bare name -> nodes (over-approximate)
        self.funcs: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs.setdefault(node.name, []).append(node)
        # `body = functools.partial(F, ...)` bindings: a name later fed
        # to jit/scan/shard_map resolves through to F
        self.partials: Dict[str, List[ast.AST]] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                callee = _dotted(node.value.func) or ""
                if callee.split(".")[-1] == "partial" and node.value.args:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            self.partials.setdefault(t.id, []).extend(
                                _callable_refs(node.value.args[0])
                            )

    def suppressed(self, rule: str, line: int) -> bool:
        return rule in self.allow.get(line, ())


def _callable_refs(node: ast.AST) -> List[ast.AST]:
    """Candidate function references inside an argument expression:
    names, attributes, and functools.partial targets."""
    out: List[ast.AST] = []
    if isinstance(node, (ast.Name, ast.Attribute)):
        out.append(node)
    elif isinstance(node, ast.Call):
        callee = _dotted(node.func) or ""
        if callee.split(".")[-1] == "partial" and node.args:
            out.extend(_callable_refs(node.args[0]))
    elif isinstance(node, ast.Lambda):
        out.append(node)
    return out


def _build_modules(sources: Dict[str, str]
                   ) -> Tuple[Dict[str, _Module], List[Finding]]:
    mods: Dict[str, _Module] = {}
    broken: List[Finding] = []
    for relpath, text in sources.items():
        modname = relpath[:-3].replace(os.sep, ".").replace("/", ".")
        if modname.endswith(".__init__"):
            modname = modname[: -len(".__init__")]
        try:
            mods[modname] = _Module(relpath, modname, text)
        except SyntaxError as e:  # a broken file is its own finding
            broken.append(Finding(
                "lint", "syntax-error",
                f"{relpath}:{e.lineno or 0}",
                f"file does not parse: {e.msg}",
            ))
    return mods, broken


def _resolve_ref(mod: _Module, ref: ast.AST,
                 mods: Dict[str, _Module],
                 depth: int = 0) -> List[Tuple[str, str]]:
    """(module, funcname) candidates a Name/Attribute reference denotes."""
    out: List[Tuple[str, str]] = []
    if depth > 4:  # partial-of-partial chains bottom out fast
        return out
    if isinstance(ref, ast.Name):
        if ref.id in mod.funcs:
            out.append((mod.modname, ref.id))
        elif ref.id in mod.from_funcs:
            src, fn = mod.from_funcs[ref.id]
            if src in mods:
                out.append((src, fn))
        for bound in mod.partials.get(ref.id, ()):
            out.extend(_resolve_ref(mod, bound, mods, depth + 1))
    elif isinstance(ref, ast.Attribute):
        base = ref.value
        if isinstance(base, ast.Name):
            if base.id == "self" and ref.attr in mod.funcs:
                out.append((mod.modname, ref.attr))
            else:
                target = mod.mod_alias.get(base.id)
                if target in mods:
                    out.append((target, ref.attr))
    return out


def _program_functions(mods: Dict[str, _Module],
                       seeds) -> Set[Tuple[str, str]]:
    """Fixed point of: seeded by the registered programs' device
    functions, closed under name-resolvable calls and nested defs. A
    kernel wrapper's plain version (*_plain) is left out: it runs only
    on CPU tensors, by the port's rule."""
    scope: Set[Tuple[str, str]] = set()
    work: List[Tuple[str, str]] = []

    def mark(key: Tuple[str, str]) -> None:
        if key[0] in mods and key[1] in mods[key[0]].funcs \
                and key not in scope and not key[1].endswith("_plain"):
            scope.add(key)
            work.append(key)

    for fns in seeds.values():
        for mod, fn in fns:
            mark((f"{_PKG}.{mod}", fn))

    while work:
        modname, fname = work.pop()
        mod = mods[modname]
        for fnode in mod.funcs.get(fname, ()):
            for inner in ast.walk(fnode):
                if isinstance(inner,
                              (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and inner is not fnode:
                    mark((modname, inner.name))
                elif isinstance(inner, ast.Call):
                    for key in _resolve_ref(mod, inner.func, mods):
                        mark(key)
    return scope


# -- rule bodies --------------------------------------------------------------


def _has_thread_join(tree: ast.AST) -> bool:
    """Any ``x.join(...)`` call that could plausibly be a Thread.join —
    string-literal joins (", ".join) and path joins (os.path.join,
    posixpath.join) are excluded, so a module full of path handling
    doesn't silently satisfy the nondaemon-thread rule."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"):
            continue
        recv = node.func.value
        if isinstance(recv, ast.Constant):
            continue  # ", ".join(...)
        dotted = _dotted(recv) or ""
        if dotted.split(".")[-1] in ("path", "posixpath", "ntpath"):
            continue  # os.path.join(...)
        return True
    return False


def _check_program_body(mod: _Module, fnode: ast.AST,
                        findings: List[Finding]) -> None:
    def add(rule: str, line: int, msg: str) -> None:
        findings.append(Finding(
            "lint", rule, f"{mod.relpath}:{line}", msg,
            suppressed=mod.suppressed(rule, line),
        ))

    for node in ast.walk(fnode):
        if not isinstance(node, ast.Call):
            continue
        line = node.lineno
        callee = node.func
        dotted = _dotted(callee) or ""
        parts = dotted.split(".")
        if isinstance(callee, ast.Attribute) \
                and callee.attr in _HOST_SYNC_ATTRS:
            add("host-sync", line,
                f".{callee.attr}() reads device data on the host in a "
                "program scope (a sync per dispatch)")
        elif len(parts) == 2 and parts[0] in mod.np_aliases \
                and parts[1] in _NP_SYNC_FUNCS:
            add("host-sync", line,
                f"{dotted}() materializes on the host in a program scope")
        elif dotted in ("torch.cuda.synchronize",
                        "torch.cuda.current_stream().synchronize"):
            add("host-sync", line,
                f"{dotted}() waits for the card in a program scope")
        elif len(parts) == 2 and parts[0] == "time" \
                and parts[1] in _TIME_FUNCS:
            add("traced-impure", line,
                f"{dotted}() reads the wall clock inside a device "
                "program")
        elif len(parts) >= 2 and "random" in parts[:-1] and (
                parts[0] in mod.np_aliases or parts[0] == "random"):
            add("traced-impure", line,
                f"{dotted}() — the host's global RNG inside a device "
                "program")
        elif dotted == "random" or (len(parts) == 2
                                    and parts[0] == "random"):
            add("traced-impure", line,
                f"{dotted}() — the host's global RNG inside a device "
                "program")
        elif len(parts) == 2 and parts[0] == "torch" \
                and parts[1] in _TORCH_RNG \
                and not any(k.arg == "generator" for k in node.keywords):
            add("traced-impure", line,
                f"{dotted}() draws from torch's global RNG in a device "
                "program (pass a seeded generator=)")
        elif isinstance(callee, ast.Name) and callee.id == "print":
            add("traced-impure", line,
                "print() in a device program runs on the host per "
                "dispatch")
        elif isinstance(callee, ast.Name) and callee.id == "open":
            add("traced-impure", line,
                "file I/O in a device program runs on the host per "
                "dispatch")


def _check_module_wide(mod: _Module, findings: List[Finding]) -> None:
    def add(rule: str, line: int, msg: str) -> None:
        findings.append(Finding(
            "lint", rule, f"{mod.relpath}:{line}", msg,
            suppressed=mod.suppressed(rule, line),
        ))

    module_has_join = _has_thread_join(mod.tree)
    is_metric_home = mod.modname == _METRIC_HOME

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            add("bare-except", node.lineno,
                "bare `except:` also swallows KeyboardInterrupt/"
                "SystemExit; catch Exception (or narrower)")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for default in list(node.args.defaults) + [
                d for d in node.args.kw_defaults if d is not None
            ]:
                mutable = isinstance(default,
                                     (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and isinstance(default.func, ast.Name)
                    and default.func.id in ("list", "dict", "set")
                )
                if mutable:
                    add("mutable-default", default.lineno,
                        f"mutable default argument in {node.name}() is "
                        "shared across calls")
        elif isinstance(node, ast.Call):
            dotted = _dotted(node.func) or ""
            parts = dotted.split(".")
            if parts[-1] == "Thread" and (
                parts[0] == "threading" or (
                    len(parts) == 1
                    and mod.from_funcs.get("Thread", ("",))[0]
                    == "threading")
            ):
                # an explicit daemon= of ANY value is a deliberate
                # choice; the rule is about forgetting the kwarg
                has_daemon = any(
                    kw.arg == "daemon" for kw in node.keywords
                )
                if not has_daemon and not module_has_join:
                    add("nondaemon-thread", node.lineno,
                        "non-daemon Thread with no .join() in this "
                        "module can wedge interpreter shutdown")
            elif parts[-1] in _METRIC_CLASSES and not is_metric_home:
                src = ""
                if len(parts) == 1:
                    src = mod.from_funcs.get(parts[0], ("",))[0]
                elif len(parts) == 2:
                    src = mod.mod_alias.get(parts[0], "")
                if src.startswith("kubernetes_tpu_torch.metrics") or \
                        src == "kubernetes_tpu_torch.metrics":
                    add("metric-outside-registry", node.lineno,
                        f"{parts[-1]} constructed outside "
                        "metrics/metrics.py bypasses the central "
                        "registry (duplicate-name protection, /metrics "
                        "exposition)")


# -- wall-clock-deadline: monotonic-only timing in consensus paths -----------

#: modules where EVERY timeout / lease / deadline computation must use
#: the monotonic clock: election timers, leader leases, request
#: deadlines, and flow-control queue timing all break when NTP steps
#: the wall clock (a lease that "expires" early splits the brain; one
#: that expires late serves stale reads)
_WALL_CLOCK_SCOPE = (
    "kubernetes_tpu_torch/storage/quorum/",
    "kubernetes_tpu_torch/client/transport.py",
    "kubernetes_tpu_torch/apiserver/flowcontrol.py",
)

_DEADLINE_NAME_RE = re.compile(
    r"deadline|expir|timeout|lease|until|cutoff", re.IGNORECASE)


def _wall_clock_in_scope(relpath: str) -> bool:
    return relpath.startswith(_WALL_CLOCK_SCOPE[0]) or \
        relpath in _WALL_CLOCK_SCOPE[1:]


def _is_wall_time_call(mod: _Module, node: ast.Call) -> bool:
    dotted = _dotted(node.func) or ""
    parts = dotted.split(".")
    if len(parts) == 1:  # from time import time [as alias]
        return mod.from_funcs.get(parts[0], ("", ""))[:2] == \
            ("time", "time")
    return parts[-1] == "time" and (
        mod.mod_alias.get(parts[0], "") == "time"
        or ".".join(parts[:-1]) == "time")


def _check_wall_clock(mod: _Module, findings: List[Finding]) -> None:
    """Flag ``time.time()`` feeding timeout/lease/deadline arithmetic
    in the consensus-critical modules. Arithmetic participation (any
    enclosing BinOp/AugAssign/Compare in the same statement), binding
    to a deadline-ish name, or passing as a deadline-ish keyword all
    count; a bare wall-clock read used for logging does not."""
    parent: Dict[int, ast.AST] = {}
    for n in ast.walk(mod.tree):
        for child in ast.iter_child_nodes(n):
            parent[id(child)] = n

    def deadline_target(stmt: ast.AST) -> bool:
        targets: List[ast.AST] = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            targets = [stmt.target]
        for t in targets:
            name = _dotted(t) or ""
            if _DEADLINE_NAME_RE.search(name):
                return True
        return False

    for node in ast.walk(mod.tree):
        if not (isinstance(node, ast.Call)
                and _is_wall_time_call(mod, node)):
            continue
        reason = None
        cur: ast.AST = node
        while cur is not None and not isinstance(cur, ast.stmt):
            up = parent.get(id(cur))
            if isinstance(up, (ast.BinOp, ast.Compare, ast.AugAssign)):
                reason = "in deadline arithmetic"
                break
            if isinstance(up, ast.keyword) and up.arg and \
                    _DEADLINE_NAME_RE.search(up.arg):
                reason = f"passed as {up.arg}="
                break
            cur = up
        if reason is None:
            stmt = cur
            while stmt is not None and not isinstance(stmt, ast.stmt):
                stmt = parent.get(id(stmt))
            if stmt is not None and deadline_target(stmt):
                reason = "bound to a deadline-valued name"
        if reason is not None:
            findings.append(Finding(
                "lint", "wall-clock-deadline",
                f"{mod.relpath}:{node.lineno}",
                f"wall-clock time.time() {reason}: NTP steps break "
                "election timers and leases here — use "
                "time.monotonic()",
                suppressed=mod.suppressed("wall-clock-deadline",
                                          node.lineno),
            ))


# -- concurrency rules: guarded-by + thread-escape ----------------------------


def _self_field(node: ast.AST) -> Optional[str]:
    """'x' when `node` is the attribute `self.x`."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _write_fields(node: ast.AST) -> List[str]:
    """Fields of ``self`` this single node writes: attribute rebinds,
    subscript stores (``self.x[k] = v``), deletes, container-mutator
    method calls, and heapq function-form mutators."""
    out: List[str] = []

    def tgt(t: ast.AST) -> None:
        f = _self_field(t)
        if f is not None:
            out.append(f)
            return
        if isinstance(t, ast.Subscript):
            f = _self_field(t.value)
            if f is not None:
                out.append(f)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                tgt(e)
        elif isinstance(t, ast.Starred):
            tgt(t.value)

    if isinstance(node, ast.Assign):
        for t in node.targets:
            tgt(t)
    elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
        tgt(node.target)
    elif isinstance(node, ast.Delete):
        for t in node.targets:
            tgt(t)
    elif isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATOR_METHODS:
            f = _self_field(fn.value)
            if f is not None:
                out.append(f)
        else:
            d = _dotted(fn) or ""
            if d.split(".")[-1] in _MUTATOR_FUNCS and node.args:
                f = _self_field(node.args[0])
                if f is not None:
                    out.append(f)
    return out


class _GuardSets:
    """Union-find over guard names so a Condition constructed over a
    lock (`self._cond = threading.Condition(self._lock)`) satisfies
    the lock's annotation and vice versa."""

    def __init__(self):
        self._parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        p = self._parent.get(x, x)
        if p == x:
            return x
        root = self.find(p)
        self._parent[x] = root
        return root

    def union(self, a: str, b: str) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self._parent[ra] = rb


def _check_class_concurrency(mod: _Module, cls: ast.ClassDef,
                             findings: List[Finding]) -> None:
    def add(rule: str, line: int, msg: str) -> None:
        findings.append(Finding(
            "lint", rule, f"{mod.relpath}:{line}", msg,
            suppressed=mod.suppressed(rule, line),
        ))

    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    aliases = _GuardSets()
    escapes = False
    for m in methods:
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                callee = _dotted(node.value.func) or ""
                if callee.split(".")[-1] == "Condition" \
                        and node.value.args:
                    src = _self_field(node.value.args[0])
                    for t in node.targets:
                        dst = _self_field(t)
                        if src and dst:
                            aliases.union(f"self.{dst}", f"self.{src}")
            if isinstance(node, ast.Call):
                d = _dotted(node.func) or ""
                if d.split(".")[-1] == "Thread" and any(
                        kw.arg == "target" for kw in node.keywords):
                    escapes = True
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr == "submit":
                    escapes = True

    def guard_annotation(line: int) -> Optional[str]:
        return mod.guard_at.get(line) or mod.guard_at.get(line - 1)

    # field -> canonical declared guard (declared at an __init__-time
    # attribute assignment carrying the trailing annotation)
    guards: Dict[str, str] = {}
    for m in methods:
        for node in ast.walk(m):
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                g = guard_annotation(node.lineno)
                if g is None:
                    continue
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    f = _self_field(t)
                    if f is not None:
                        guards[f] = aliases.find(g)

    locked_writes: Dict[str, List[int]] = {}
    unlocked_writes: Dict[str, List[int]] = {}

    def record(field: str, line: int, held: frozenset) -> None:
        declared = guards.get(field)
        if declared is not None:
            if declared not in held:
                add("guarded-by", line,
                    f"{cls.name}.{field} is declared `# guarded-by: "
                    f"{declared}` but this write holds "
                    f"{sorted(held) or 'no lock'} — take the lock or "
                    "annotate the declaration site")
            return
        (locked_writes if held else unlocked_writes).setdefault(
            field, []).append(line)

    def visit(node: ast.AST, held: frozenset) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            got = set(held)
            for item in node.items:
                d = _dotted(item.context_expr)
                if d and d.startswith("self."):
                    got.add(aliases.find(d))
                visit(item.context_expr, held)
            for b in node.body:
                visit(b, frozenset(got))
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # a nested def runs later: assume nothing is held unless
            # its own def line carries a guard annotation
            g = guard_annotation(node.lineno)
            inner = frozenset({aliases.find(g)} if g else ())
            for b in node.body:
                visit(b, inner)
            return
        if isinstance(node, ast.Lambda):
            return
        for field in _write_fields(node):
            record(field, node.lineno, held)
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for m in methods:
        if m.name in ("__init__", "__new__") or m.name.endswith("_locked"):
            continue  # construction is single-threaded; *_locked helpers
            # run under the caller's guard by convention
        g = guard_annotation(m.lineno)
        entry = frozenset({aliases.find(g)} if g else ())
        for b in m.body:
            visit(b, entry)

    if escapes:
        for field, lines in unlocked_writes.items():
            if field not in locked_writes:
                continue  # consistently unguarded: likely thread-local
            for line in lines:
                add("unguarded-shared-write", line,
                    f"{cls.name}.{field} is written under a lock at "
                    f"line(s) {locked_writes[field][:3]} but written "
                    "bare here, and this class hands itself to a "
                    "thread — guard the write, or declare the field "
                    "`# guarded-by:` to make the contract checkable")


def _check_concurrency(mod: _Module, findings: List[Finding]) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            _check_class_concurrency(mod, node, findings)


# -- entry points -------------------------------------------------------------


def lint_sources(sources: Dict[str, str],
                 seeds=None) -> List[Finding]:
    """Lint a dict of {relative path: source text} as one package view
    (the testable seam: seeded-violation fixtures come through here).
    seeds: program name -> ((module under the package, function), ...),
    PROGRAM_SEEDS by default."""
    mods, findings = _build_modules(sources)
    scope = _program_functions(
        mods, PROGRAM_SEEDS if seeds is None else seeds)
    for mod in mods.values():
        _check_module_wide(mod, findings)
        _check_concurrency(mod, findings)
        if _wall_clock_in_scope(mod.relpath):
            _check_wall_clock(mod, findings)
        if mod.modname.startswith(HOT_PREFIXES):
            seen: Set[int] = set()
            for modname, fname in scope:
                if modname != mod.modname:
                    continue
                for fnode in mod.funcs.get(fname, ()):
                    if id(fnode) in seen:
                        continue
                    seen.add(id(fnode))
                    _check_program_body(mod, fnode, findings)
    findings.sort(key=lambda f: f.where)
    return findings


def lint_tree(root: Optional[str] = None) -> List[Finding]:
    """Lint every module of the installed package tree."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.path.dirname(root)  # repo root holding kubernetes_tpu_torch/
    sources: Dict[str, str] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            full = os.path.join(dirpath, fn)
            rel = os.path.relpath(full, base)
            with open(full, "r", encoding="utf-8") as f:
                sources[rel] = f.read()
    return lint_sources(sources)
