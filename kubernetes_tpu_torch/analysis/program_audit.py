"""Program auditor: machine-checked transfer, sync and dtype contracts.

Traces every registered device program (analysis/programs) without a
card: the registry is built and each program's dispatch and collect run
under torch's FakeTensorMode on fake CUDA tensors (cuda:0, and the
mesh's shards on cuda:0..cuda:3), with a TorchDispatchMode recording
every aten op. A fake tensor holds no data, so nothing runs on a
device; every kernel wrapper's ctypes launch is swapped for the
wrapper's own output allocation (its `_outputs`), recorded as one
`kernel:<name>` event, and reaching a kernel library while tracing
fails the trace. On a card (chip_smoke.py phase 15) the same programs
run for real under the same recorder, their dispatch under
torch.cuda.set_sync_debug_mode("error").

Rules (the JAX auditor's ids where the meaning carries over):

* ``host-sync`` — an aten._local_scalar_dense of a device tensor
  (.item(), int(t), bool(t), .tolist()) inside a program's dispatch: a
  device round trip per dispatch (or per scan step).
* ``transfer-contract`` — the program's host-bound output leaves (those
  after the carry) must equal ``expected_host_leaves``, and the
  device-to-host copies (aten._to_copy / copy_ from a device into host
  memory) its dispatch and collect make must equal ``host_copies`` (one
  a host-bound leaf unless declared).
* ``dynamic-shape`` — an op whose output shape depends on the data
  (nonzero, a boolean-mask index, unique, masked_select): under fake
  tensors it cannot be traced, on CUDA it is an implicit sync.
* ``f64-upcast`` — a float64 value produced by arithmetic in a program
  not registered allow_f64; ops/priorities.py and ops/interpod.py are
  reference-exact float64 by contract, as in the JAX package.
* ``denylisted-primitive`` — an integer mm/bmm/matmul/addmm/mv/dot: CUDA
  has no integer matmul (ops/priorities.py _matvec exists for it).
* ``donation-contract`` — each leaf of a donated argument (a resident
  carry or table) comes back in the same storage.
* ``sharding-drift`` — placement: each shard's arguments and carry lie
  on the shard's device, a node-axis field holding the shard's slice of
  the node axis on the axis carry_specs()/static_specs() name, a
  replicated one the whole table.
* ``scatter-contract`` — only the declared scatter forms: an overwrite
  index_put_ / index_copy_ / scatter_ is a finding unless declared.
* ``dtype-contract`` — declared-narrow tables arrive narrow, and no
  node-axis int8/int16 is widened to int32/int64 by a copy except to
  feed an index (the widened value reaching only index operands and
  comparisons, through views and index arithmetic). An accumulation
  dtype (sum(dtype=...)) is not a copy.
* ``mesh-unavailable`` — the mesh programs were asked for and none was
  built; ``trace-failure`` — a program failed to trace.

Deviation from kubernetes_tpu/analysis/jaxpr_audit.py <module>: there is
no jaxpr, so this module is the port's counterpart of the JAX auditor
under another name (program_audit). It traces torch programs on fake
CUDA tensors through a TorchDispatchMode instead of walking
jax.make_jaxpr, counts device-to-host copies as well as host-bound
leaves, checks donation as storage identity (torch updates in place;
nothing is aliased by a compiler), sharding as per-shard placement, and
host callbacks become host syncs.
"""

from __future__ import annotations

import contextlib
import importlib
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from kubernetes_tpu_torch.analysis import Finding
from kubernetes_tpu_torch.analysis.programs import (
    COMMUTATIVE_FORMS,
    ProgramSpec,
    Sharded,
    build_programs,
    leaves,
)

#: ops whose output shape depends on the data
DYNAMIC_OPS = {"nonzero", "argwhere", "masked_select", "unique",
               "_unique", "_unique2", "unique_dim", "unique_consecutive"}

#: integer matrix products CUDA cannot run
INT_MATMUL_OPS = {"mm", "bmm", "addmm", "addbmm", "baddbmm", "dot",
                  "vdot", "mv", "addmv", "matmul", "_int_mm"}

#: ops that merely MOVE float64 data (the f64-upcast rule fires on
#: f64-producing arithmetic only)
F64_MOVEMENT_OPS = {
    "_to_copy", "copy_", "copy", "clone", "view", "_unsafe_view",
    "reshape", "expand", "unsqueeze", "squeeze", "permute", "transpose",
    "t", "slice", "select", "index", "index_select", "gather", "cat",
    "stack", "where", "empty", "zeros", "full", "zeros_like",
    "empty_like", "full_like", "detach", "alias", "lift_fresh",
    "lift_fresh_copy", "_local_scalar_dense", "scalar_tensor", "fill_",
    "masked_fill", "masked_fill_", "index_put", "index_put_", "flip",
}

#: source files whose f64 arithmetic is reference-exact BY CONTRACT
ALLOWED_F64_SOURCES = (
    "kubernetes_tpu_torch/ops/priorities.py",
    "kubernetes_tpu_torch/ops/interpod.py",
)

#: (op, positions holding an index operand) for the dtype contract's
#: index-feed exemption
_INDEX_OPERANDS = {
    "index": (1,), "index_put": (1,), "index_put_": (1,),
    "_index_put_impl_": (1,), "index_select": (2,), "gather": (2,),
    "scatter": (2,), "scatter_": (2,), "scatter_add": (2,),
    "scatter_add_": (2,), "scatter_reduce": (2,), "scatter_reduce_": (2,),
    "index_add": (2,), "index_add_": (2,), "index_copy": (2,),
    "index_copy_": (2,), "index_fill": (2,), "index_fill_": (2,),
    "take": (1,), "embedding": (1,),
}
#: comparisons consume an index value into a bool guard; the *_like
#: factories read only its shape
_INDEX_GUARDS = {"eq", "ne", "lt", "le", "gt", "ge", "ones_like",
                 "zeros_like", "empty_like", "full_like"}
#: ops an index value flows THROUGH on its way to an index operand
_INDEX_PLUMBING = {
    "view", "_unsafe_view", "reshape", "expand", "unsqueeze", "squeeze",
    "permute", "transpose", "t", "slice", "select", "clone",
    "contiguous", "clamp", "clamp_min", "clamp_max", "add", "sub", "mul",
    "remainder", "where", "cat", "stack", "detach", "alias", "_to_copy",
}
_NARROW_INTS = (torch.int8, torch.int16)
_WIDE_INTS = (torch.int32, torch.int64)

#: the kernel wrappers: module, launch attribute, kernel name, and the
#: arguments of the launch -> those of the module's _outputs
KERNELS = (
    ("kubernetes_tpu_torch.ops.probe_kernel", "_launch", "probe_kernel",
     lambda J, alloc, usage, pv, *_a, **_k: (J, alloc, usage, pv)),
    ("kubernetes_tpu_torch.ops.probe_kernel", "_launch_bf16",
     "probe_kernel_bf16",
     lambda J, alloc, usage, pv, *_a, **_k: (J, alloc, usage, pv)),
    ("kubernetes_tpu_torch.ops.zreplay_kernel", "_launch", "zreplay_kernel",
     lambda nodes, scalars, _w, **k: (nodes, scalars, k["K"],
                                      k["k_real"])),
    ("kubernetes_tpu_torch.ops.preempt_kernel", "_launch", "preempt_kernel",
     lambda *a, **_k: a[:5]),
    ("kubernetes_tpu_torch.scheduler.optimizer.ops.assign_kernel",
     "_launch_auction", "assign_auction", lambda *a, **_k: a[:8]),
    ("kubernetes_tpu_torch.scheduler.optimizer.ops.assign_kernel",
     "_launch_beam", "assign_beam", lambda *a, **_k: a[:6]),
    ("kubernetes_tpu_torch.parallel.resident_kernel", "_launch",
     "resident_scatter", lambda buf, table, *_a, **_k: (buf, table)),
)


class KernelReached(AssertionError):
    """A kernel library was reached while tracing on fake tensors: its
    launch would hand null pointers to real device code."""


def _fake_tensor_types():
    from torch._subclasses.fake_tensor import FakeTensor

    return FakeTensor


def _tensors_in(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors_in(v)]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors_in(v)]
    return []


def _norm(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _caller() -> str:
    """file:line of the innermost frame of the port outside analysis/."""
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if "kubernetes_tpu_torch/" in name and "/analysis/" not in name:
            return f"{name.split('kubernetes_tpu_torch/')[-1]}:{f.f_lineno}"
        f = f.f_back
    return "?"


def _f64_provenance_ok() -> bool:
    f = sys._getframe(1)
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        if name.endswith(ALLOWED_F64_SOURCES):
            return True
        f = f.f_back
    return False


@dataclass
class ProgramTrace:
    """What one dispatch + collect of a program did."""

    name: str
    ops: int = 0
    d2h: int = 0
    h2d: int = 0
    host_leaves: int = 0
    kernels: Dict[str, int] = field(default_factory=dict)
    #: (rule, where, message) events found while tracing
    events: List[tuple] = field(default_factory=list)
    scatters: set = field(default_factory=set)
    #: (where, shape, (from, to)) of each flagged narrow-table widening
    widened: List[tuple] = field(default_factory=list)
    out: Any = None


class _Recorder(TorchDispatchMode):
    """Records every aten op of a program's dispatch and collect."""

    def __init__(self, trace: ProgramTrace, spec: ProgramSpec):
        super().__init__()
        self.trace = trace
        self.spec = spec
        self.phase = "dispatch"
        self.pretend: Optional[torch.device] = None
        self.node_dims = set()
        self._tracked: Dict[int, tuple] = {}  # id -> (tensor, event idx)
        # [where, shape, dtypes, a non-index use, any use]
        self._widen: List[list] = []

    def _on_device(self, t) -> bool:
        if not isinstance(t, torch.Tensor):
            return False
        return t.device.type == "cuda" or (
            self.pretend is not None and isinstance(
                t, _fake_tensor_types()))

    def _event(self, rule: str, msg: str) -> None:
        self.trace.events.append((rule, self.phase, f"{_caller()}: {msg}"))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        self.trace.ops += 1
        fake = any(isinstance(t, _fake_tensor_types())
                   for t in _tensors_in(args))
        self._note_uses(name, args)
        if name == "_local_scalar_dense" and self._on_device(args[0]):
            self.trace.d2h += 1
            if self.phase == "dispatch":
                self._event("host-sync", "a device value read on the "
                            "host (.item(), int(), bool(), .tolist())")
            if fake:
                return self._placeholder_scalar(args[0])
        if name == "_local_scalar_dense" and fake:
            return self._placeholder_scalar(args[0])
        if name in DYNAMIC_OPS or self._bool_index(name, args):
            if self._on_device(args[0]):
                self._event("dynamic-shape", f"{name} has a data-dependent "
                            "output shape (an implicit sync on CUDA)")
            if fake:
                return self._placeholder_dynamic(func, name, args, kwargs)
        out = func(*args, **kwargs)
        self._note_transfer(name, args, kwargs, out)
        self._note_out(name, args, out)
        return out

    # -- fake-tensor stand-ins -----------------------------------------------

    @staticmethod
    def _placeholder_scalar(t):
        if t.dtype == torch.bool:
            return False
        return 0.0 if t.dtype.is_floating_point else 0

    @staticmethod
    def _bool_index(name, args) -> bool:
        if name not in ("index", "index_put", "index_put_",
                        "_index_put_impl_"):
            return False
        return any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in (args[1] or ()))

    @staticmethod
    def _placeholder_dynamic(func, name, args, kwargs):
        """An empty result of the op's rank: the trace goes on past the
        finding, as if no element were selected."""
        t = args[0]
        dev = t.device
        if name in ("nonzero", "argwhere"):
            return torch.empty((0, t.dim()), dtype=torch.int64, device=dev)
        if name == "masked_select":
            return torch.empty((0,), dtype=t.dtype, device=dev)
        if name in ("index", "index_put", "index_put_", "_index_put_impl_"):
            idx = []
            for i in args[1]:
                if isinstance(i, torch.Tensor) and i.dtype == torch.bool:
                    idx.extend([torch.empty((0,), dtype=torch.int64,
                                            device=i.device)] * i.dim())
                else:
                    idx.append(i)
            return func(t, idx, *args[2:], **kwargs)
        raise _TraceStop(f"{name} has a data-dependent output shape")

    # -- transfers, f64, matmul, scatter, widening ---------------------------

    def _note_transfer(self, name, args, kwargs, out) -> None:
        if name in ("_to_copy", "copy") and isinstance(out, torch.Tensor):
            src, dst = args[0], out
        elif name == "copy_":
            src, dst = args[1], args[0]
        else:
            return
        if not isinstance(src, torch.Tensor):
            return
        if self._on_device(src) and dst.device.type == "cpu" \
                and self.pretend is None:
            self.trace.d2h += 1
        elif src.device.type == "cpu" and self._on_device(dst) \
                and self.pretend is None:
            self.trace.h2d += 1
            if self.phase == "dispatch" and not (
                    kwargs.get("non_blocking")
                    or (name == "copy_" and len(args) > 2 and args[2])):
                self._event("host-sync", "a host-to-device copy from "
                            "pageable memory (the host waits for it)")

    def _note_out(self, name, args, out) -> None:
        spec = self.spec
        outs = _tensors_in(out)
        if not spec.allow_f64 and name not in F64_MOVEMENT_OPS and any(
                t.dtype in (torch.float64, torch.complex128) for t in outs) \
                and not _f64_provenance_ok():
            self._event("f64-upcast", f"{name} produces float64")
        if name in INT_MATMUL_OPS and any(
                not (t.dtype.is_floating_point or t.dtype.is_complex)
                for t in _tensors_in(args)):
            self._event("denylisted-primitive",
                        f"integer {name}: CUDA has no integer matmul "
                        "(use a multiply and a sum, ops/priorities "
                        "_matvec)")
        form = self._scatter_form(name, args)
        if form is not None:
            self.trace.scatters.add(form)
        if name == "_to_copy" and self.node_dims and outs:
            src = args[0]
            if (isinstance(src, torch.Tensor) and src.dtype in _NARROW_INTS
                    and outs[0].dtype in _WIDE_INTS and src.dim()
                    and src.shape[0] in self.node_dims):
                self._widen.append([_caller(), tuple(src.shape),
                                    (src.dtype, outs[0].dtype), False,
                                    False])
                self._track(outs[0], len(self._widen) - 1)
                return
        if name in _INDEX_PLUMBING:
            for i in self._tracked_in(args):
                for t in outs:
                    self._track(t, i)

    @staticmethod
    def _scatter_form(name, args):
        base = name.rstrip("_")
        if base in ("index_add", "index_copy", "scatter_add", "scatter",
                    "index_fill"):
            return (base + "_", int(args[1]))
        if base == "scatter_reduce":
            return (f"scatter_reduce_{args[4]}", int(args[1]))
        if name in ("index_put", "index_put_", "_index_put_impl_"):
            acc = bool(args[3]) if len(args) > 3 else False
            dims = tuple(i for i, ix in enumerate(args[1]) if ix is not None)
            return ("index_put_acc" if acc else "index_put_", dims)
        if base == "masked_scatter":
            return ("masked_scatter_", None)
        return None

    def _track(self, t, i) -> None:
        self._tracked[id(t)] = (t, i)

    def _tracked_in(self, args) -> set:
        return {self._tracked[id(t)][1] for t in _tensors_in(args)
                if id(t) in self._tracked}

    def _note_uses(self, name, args) -> None:
        if not self._tracked:
            return
        index_pos = _INDEX_OPERANDS.get(name, ())
        for pos, a in enumerate(args):
            for t in _tensors_in(a):
                ent = self._tracked.get(id(t))
                if ent is None:
                    continue
                self._widen[ent[1]][4] = True
                if (pos in index_pos or name in _INDEX_GUARDS
                        or name in _INDEX_PLUMBING):
                    continue
                self._widen[ent[1]][3] = True

    def widen_findings(self) -> List[tuple]:
        """The widenings whose value reached a non-index use, or none."""
        return [w[:3] for w in self._widen if w[3] or not w[4]]


class _TraceStop(Exception):
    """The trace cannot go on (a finding has been recorded)."""


class _CudaShim(TorchFunctionMode):
    """What a CPU-only torch cannot do for fake CUDA tensors: Python
    bindings that open a CUDA device guard (indexing, nonzero, int())
    are retried with the fake tensors presenting as CPU tensors, and
    .numpy() of a fake host tensor returns zeros of its shape."""

    def __init__(self, recorder_ref):
        super().__init__()
        self._recorder = recorder_ref

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        FakeTensor = _fake_tensor_types()
        if func in (torch.Tensor.numpy, torch.Tensor.__array__) \
                and isinstance(args[0], FakeTensor):
            t = args[0]
            return np.zeros(tuple(t.shape), dtype=_np_dtype(t.dtype))
        try:
            return func(*args, **kwargs)
        except RuntimeError as e:
            # a CPU-only torch has no CUDA guard; a CUDA build's guard
            # refuses a fake shard's device the machine does not have
            if not _GUARD_ERRORS.search(str(e)):
                raise
        # a bare "cuda" asks the guard for the current device: cuda:0
        args, kwargs = _indexed_devices(args), _indexed_devices(kwargs)
        fakes = [t for t in _tensors_in((args, kwargs))
                 if isinstance(t, FakeTensor) and t.fake_device.type == "cuda"]
        if not fakes:
            return func(*args, **kwargs)
        saved = [(t, t.fake_device) for t in fakes]
        rec = self._recorder()
        prev = rec.pretend if rec is not None else None
        if rec is not None:
            rec.pretend = saved[0][1]
        for t, _d in saved:
            t.fake_device = torch.device("cpu")
        try:
            out = func(*args, **kwargs)
        finally:
            for t, d in saved:
                t.fake_device = d
            if rec is not None:
                rec.pretend = prev
        for o in _tensors_in(out):
            if isinstance(o, FakeTensor) and o.fake_device.type == "cpu":
                o.fake_device = saved[0][1]
        return out


#: the errors of a CUDA device guard opened for a fake tensor
_GUARD_ERRORS = re.compile(
    r"not linked with support for cuda|invalid device ordinal|CUDA error|"
    r"no CUDA GPUs are available|no CUDA-capable device|"
    r"Torch not compiled with CUDA", re.IGNORECASE)


def _indexed_devices(obj):
    """obj with each bare CUDA device ("cuda", torch.device("cuda"))
    replaced by cuda:0."""
    if isinstance(obj, str) and obj == "cuda":
        return torch.device("cuda", 0)
    if isinstance(obj, torch.device) and obj.type == "cuda" \
            and obj.index is None:
        return torch.device("cuda", 0)
    if isinstance(obj, dict):
        return {k: _indexed_devices(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)) and not isinstance(obj, torch.Size):
        return type(obj)(_indexed_devices(v) for v in obj)
    return obj


_NP_DTYPES = {
    torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
    torch.int16: np.int16, torch.int32: np.int32, torch.int64: np.int64,
    torch.float16: np.float16, torch.bfloat16: np.float32,
    torch.float32: np.float32, torch.float64: np.float64,
}


def _np_dtype(dt: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch dtype (bfloat16: float32)."""
    return np.dtype(_NP_DTYPES[dt])


class _StubEvent:
    """torch.cuda.Event for fake tensors: nothing to record or wait on."""

    def __init__(self, *a, **k):
        pass

    def record(self, *a, **k):
        pass

    def synchronize(self):
        pass

    def query(self):
        return True


@contextlib.contextmanager
def kernels_swapped(trace_ref):
    """Each kernel wrapper's launch -> its _outputs, recorded as one
    kernel:<name> event on the current trace; each module's library
    loader raises KernelReached."""
    saved = []

    def fake_launch(mod, name, adapt):
        def launch(*a, **k):
            tr = trace_ref()
            if tr is not None:
                tr.kernels[name] = tr.kernels.get(name, 0) + 1
            return mod._outputs(*adapt(*a, **k))
        return launch

    def refuse(modname):
        def lib(*_a, **_k):
            raise KernelReached(f"{modname}: a kernel library was reached "
                                "while tracing on fake tensors")
        return lib

    try:
        for modname, attr, name, adapt in KERNELS:
            mod = importlib.import_module(modname)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, fake_launch(mod, name, adapt))
            if not any(m is mod and a == "_lib" for m, a, _f in saved):
                saved.append((mod, "_lib", mod._lib))
                mod._lib = refuse(modname)
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


class FakeRegistry:
    """The registry built on fake CUDA tensors, with the modes that
    trace it."""

    def __init__(self, include_mesh: bool = True):
        from torch._subclasses.fake_tensor import FakeTensorMode

        self.mode = FakeTensorMode(allow_non_fake_inputs=True)
        self.current: Optional[_Recorder] = None
        self.trace: Optional[ProgramTrace] = None
        with self.active():
            self.specs = build_programs(include_mesh=include_mesh,
                                        device="cuda:0")

    @contextlib.contextmanager
    def active(self):
        saved_event = torch.cuda.Event
        torch.cuda.Event = _StubEvent
        try:
            with self.mode, _CudaShim(lambda: self.current), \
                    kernels_swapped(lambda: self.trace):
                yield
        finally:
            torch.cuda.Event = saved_event

    def trace_program(self, spec: ProgramSpec) -> ProgramTrace:
        trace = ProgramTrace(spec.name)
        rec = _Recorder(trace, spec)
        rec.node_dims = _narrow_node_dims(spec)
        self.current, self.trace = rec, trace
        try:
            with self.active():
                run_program(spec, trace, rec)
        finally:
            self.current = self.trace = None
        trace.widened = rec.widen_findings()
        return trace


def run_program(spec: ProgramSpec, trace: ProgramTrace, rec: _Recorder,
                arm=None) -> None:
    """One dispatch of spec under the recorder, then its collect; arm:
    a context manager entered around the dispatch alone (the card's
    sync debug mode)."""
    try:
        with rec:
            rec.phase = "dispatch"
            with (arm() if arm is not None else contextlib.nullcontext()):
                out = spec.fn(*spec.args)
            trace.out = out
            trace.host_leaves = len(leaves(out)) - spec.carry_out_leaves
            rec.phase = "collect"
            spec.run_collect(out)
    except _TraceStop as e:
        trace.events.append(("dynamic-shape", rec.phase, str(e)))


def _narrow_node_dims(spec: ProgramSpec) -> set:
    if not spec.narrow_dtypes:
        return set()
    decl = dict(spec.narrow_dtypes)
    dims = set()
    for arg in spec.args:
        if isinstance(arg, dict):
            for k, t in arg.items():
                if k in decl and isinstance(t, torch.Tensor) and t.dim():
                    dims.add(t.shape[0])
    return dims


# -- rules over a trace -------------------------------------------------------


def _event_findings(spec: ProgramSpec, trace: ProgramTrace) -> List[Finding]:
    findings, seen = [], set()
    for rule, phase, msg in trace.events:
        if rule == "host-sync" and phase != "dispatch":
            continue
        key = (rule, msg)
        if key in seen:
            continue
        seen.add(key)
        findings.append(Finding("programs", rule, spec.name,
                                f"{msg} ({phase})"))
    return findings


def _transfer_findings(spec: ProgramSpec,
                       trace: ProgramTrace) -> List[Finding]:
    if spec.expected_host_leaves is None:
        return []
    findings = []
    if trace.host_leaves != spec.expected_host_leaves:
        findings.append(Finding(
            "programs", "transfer-contract", spec.name,
            f"{trace.host_leaves} host-bound output leaf(s) per dispatch, "
            f"contract says {spec.expected_host_leaves} — an extra "
            "device->host output crept into the wave hot path",
        ))
    copies = (spec.host_copies if spec.host_copies is not None
              else spec.expected_host_leaves)
    if trace.d2h != copies:
        findings.append(Finding(
            "programs", "transfer-contract", spec.name,
            f"{trace.d2h} device-to-host copies per dispatch, contract "
            f"says {copies}",
        ))
    return findings


def _donated_tensors(arg) -> List[torch.Tensor]:
    out = []
    for leaf in leaves(arg):
        out.extend(leaf if isinstance(leaf, Sharded) else [leaf])
    return [t for t in out if isinstance(t, torch.Tensor)]


def _donation_findings(spec: ProgramSpec,
                       trace: ProgramTrace) -> List[Finding]:
    if not spec.donate_argnums:
        return []
    donated = [t for i in spec.donate_argnums
               for t in _donated_tensors(spec.args[i])]
    expected = (spec.donated_leaves if spec.donated_leaves is not None
                else len(donated))
    back = {_storage(t)
            for t in _donated_tensors(leaves(trace.out)[
                :spec.carry_out_leaves])}
    aliased = sum(_storage(t) in back for t in donated)
    if aliased != expected:
        return [Finding(
            "programs", "donation-contract", spec.name,
            f"{aliased} donated tensor(s) come back in their storage, "
            f"contract says {expected} — a resident buffer is copied "
            "instead of updated in place",
        )]
    return []


def _placement_findings(spec: ProgramSpec) -> List[Finding]:
    pl = spec.placement
    if pl is None:
        return []
    devices = [_norm(d) for d in pl.devices]
    bad: List[str] = []

    def check(label, shards, axis):
        if len(shards) != len(devices):
            bad.append(f"{label}: {len(shards)} shard tensor(s) for "
                       f"{len(devices)} shards")
            return
        for s, t in enumerate(shards):
            if not isinstance(t, torch.Tensor):
                continue
            if _norm(t.device) != devices[s]:
                bad.append(f"{label} shard {s} lies on {t.device}, "
                           f"the placement says {devices[s]}")
            elif axis is not None and (t.dim() <= axis
                                       or t.shape[axis] != pl.n_per_shard):
                bad.append(f"{label} shard {s} has shape {tuple(t.shape)}, "
                           f"the placement says {pl.n_per_shard} nodes "
                           f"on axis {axis}")
            elif axis is None and tuple(t.shape) != tuple(shards[0].shape):
                bad.append(f"{label} shard {s} has shape {tuple(t.shape)} "
                           f"where the table is replicated "
                           f"({tuple(shards[0].shape)})")

    for i, (arg, decl) in enumerate(zip(spec.args, pl.args)):
        if decl is None:
            continue
        if isinstance(decl, dict):
            for f, axis in decl.items():
                if arg and f in arg[0]:
                    check(f"arg{i}[{f}]", [d[f] for d in arg], axis)
        elif isinstance(decl, tuple):
            for j, (leaf, axis) in enumerate(zip(arg, decl)):
                check(f"arg{i}[{j}]", list(leaf), axis)
        else:
            check(f"arg{i}", list(arg), decl)
    return [Finding("programs", "sharding-drift", spec.name,
                    f"{b} — an O(nodes) reshard would ride every dispatch")
            for b in bad]


def _out_placement_findings(spec: ProgramSpec,
                            trace: ProgramTrace) -> List[Finding]:
    if spec.placement is None:
        return []
    devices = [_norm(d) for d in spec.placement.devices]
    found = []
    for j, leaf in enumerate(leaves(trace.out)):
        if not isinstance(leaf, Sharded):
            continue
        for s, t in enumerate(leaf):
            if s < len(devices) and _norm(t.device) != devices[s]:
                found.append(Finding(
                    "programs", "sharding-drift", spec.name,
                    f"out[{j}] shard {s} lies on {t.device}, the "
                    f"placement says {devices[s]}"))
    return found


def _scatter_findings(spec: ProgramSpec,
                      trace: ProgramTrace) -> List[Finding]:
    if spec.scatter_allowed is None:
        return []
    allowed = {(f, d) for f, d in spec.scatter_allowed}
    findings = []
    for form in sorted(trace.scatters, key=repr):
        if form in allowed:
            continue
        kind = ("commutative" if form[0] in COMMUTATIVE_FORMS
                else "overwrite")
        findings.append(Finding(
            "programs", "scatter-contract", spec.name,
            f"{kind} {form[0]} on dims {form[1]} is not among this "
            f"program's declared scatter forms {sorted(allowed, key=repr)}"
            " — prove it commutative/collision-free and declare it",
        ))
    return findings


def _dtype_findings(spec: ProgramSpec,
                    trace: ProgramTrace) -> List[Finding]:
    if not spec.narrow_dtypes:
        return []
    decl = {name: np.dtype(dt) for name, dt in spec.narrow_dtypes}
    findings = []
    for arg in spec.args:
        if not isinstance(arg, dict):
            continue
        for name, want in decl.items():
            t = arg.get(name)
            if isinstance(t, torch.Tensor) and _np_dtype(t.dtype) != want:
                findings.append(Finding(
                    "programs", "dtype-contract", spec.name,
                    f"input table {name!r} arrives as {t.dtype}, declared "
                    f"narrow placement is {want} — the driver stopped "
                    "placing the quantized copy",
                ))
    for where, shape, (src, dst) in trace.widened:
        findings.append(Finding(
            "programs", "dtype-contract", spec.name,
            f"{where}: {src}->{dst} widening of a node-axis table (shape "
            f"{shape}) inside a quantized program — consume it via "
            "quant.narrow_eq/narrow_matvec instead",
        ))
    return findings


def audit_trace(spec: ProgramSpec, trace: ProgramTrace) -> List[Finding]:
    """The rules over one program's trace."""
    findings = _event_findings(spec, trace)
    findings.extend(_transfer_findings(spec, trace))
    findings.extend(_donation_findings(spec, trace))
    findings.extend(_placement_findings(spec))
    findings.extend(_out_placement_findings(spec, trace))
    findings.extend(_scatter_findings(spec, trace))
    findings.extend(_dtype_findings(spec, trace))
    return findings


def audit_program(registry: "FakeRegistry",
                  spec: ProgramSpec) -> List[Finding]:
    try:
        trace = registry.trace_program(spec)
    except KernelReached as e:
        return [Finding("programs", "trace-failure", spec.name, str(e))]
    return audit_trace(spec, trace)


_REGISTRY_CACHE: dict = {}  # include_mesh -> FakeRegistry


def registered_programs(include_mesh: bool = True) -> "FakeRegistry":
    reg = _REGISTRY_CACHE.get(include_mesh)
    if reg is None:
        reg = FakeRegistry(include_mesh=include_mesh)
        _REGISTRY_CACHE[include_mesh] = reg
    return reg


def audit_all(include_mesh: bool = True) -> List[Finding]:
    """Trace + audit every registered program (the CI pass body)."""
    reg = registered_programs(include_mesh=include_mesh)
    findings: List[Finding] = []
    if include_mesh and not any(s.name.startswith("mesh_")
                                for s in reg.specs):
        findings.append(Finding(
            "programs", "mesh-unavailable", "programs",
            "the mesh programs were not built; pass --no-mesh to accept "
            "the reduced coverage explicitly",
        ))
    for spec in reg.specs:
        findings.extend(audit_program(reg, spec))
    return findings


# -- on a card ----------------------------------------------------------------


def launch_counts() -> Dict[str, int]:
    """Each kernel's launches so far, by the KERNELS names, from the
    wrappers' own counters (LAUNCHES_BY_SHAPE)."""
    from kubernetes_tpu_torch.ops import preempt_kernel as K6
    from kubernetes_tpu_torch.ops import probe_kernel as K1
    from kubernetes_tpu_torch.ops import zreplay_kernel as K3
    from kubernetes_tpu_torch.parallel import resident_kernel as K8
    from kubernetes_tpu_torch.scheduler.optimizer.ops import (
        assign_kernel as K7,
    )

    def total(mod, pick=lambda _k: True):
        return sum(n for k, n in mod.LAUNCHES_BY_SHAPE.items() if pick(k))

    return {
        "probe_kernel": total(K1, lambda k: k[2] == "i64"),
        "probe_kernel_bf16": total(K1, lambda k: k[2] == "bf16"),
        "zreplay_kernel": total(K3),
        "preempt_kernel": total(K6),
        "assign_auction": total(K7, lambda k: k[0] == "auction"),
        "assign_beam": total(K7, lambda k: k[0] == "beam"),
        "resident_scatter": total(K8),
    }


@contextlib.contextmanager
def sync_errors():
    """torch.cuda.set_sync_debug_mode("error") for the block: any call
    that synchronizes the host with the card raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def measure_program(spec: ProgramSpec) -> ProgramTrace:
    """One real dispatch + collect of spec on the card: its dispatch
    under sync_errors (a synchronizing call raises), the recorder
    counting its device-to-host copies, and its kernel launches from
    the wrappers' counters."""
    trace = ProgramTrace(spec.name)
    rec = _Recorder(trace, spec)
    rec.node_dims = _narrow_node_dims(spec)
    before = launch_counts()
    run_program(spec, trace, rec, arm=sync_errors)
    torch.cuda.synchronize()
    after = launch_counts()
    trace.kernels = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
    trace.widened = rec.widen_findings()
    return trace
