"""Non-executable tag-length-value binary codec over the dataclass schema.

The reference's binary wire is protobuf: a schema'd, data-only format
whose marshallers are generated from the API types
(pkg/runtime/serializer/protobuf/protobuf.go:17-33). The analogue here
is generated the same way — from the dataclass field lists — but at
import time instead of build time: every registered dataclass encodes as
a class-table reference plus its field values in declaration order, so
there is no per-field name on the wire and no reflective field walk on
the hot path.

Unlike its round-2 predecessor (a pickle envelope), this wire is safe
for untrusted callers: decoding can only ever produce registered API
dataclasses, dicts, lists, and scalars — there is no opcode that calls
arbitrary code — and all counts are validated against the remaining
input before any allocation.

Wire grammar (all varints unsigned LEB128; ints zigzag-encoded):

    value  := NONE | TRUE | FALSE
            | INT  <zigzag varint>
            | FLOAT <8 bytes little-endian IEEE754>
            | STR  <len> <utf-8 bytes>
            | BYTES <len> <bytes>
            | LIST <n> value*n
            | DICT <n> (value value)*n
            | OBJDEF <class-id> <len> <class-name utf-8> <nfields> value*nfields
            | OBJ    <class-id> value*nfields          (class-id seen before)

A class's fields travel in dataclass declaration order; the decoder
builds instances with object.__new__ + __dict__ (no __init__ /
__set_state__ hooks run). OBJDEF's nfields must equal the local class's
field count — a mismatch is a schema-drift decode error, not a silent
misalignment.

Copy of kubernetes_tpu/runtime/tlv.py: only the import package differs.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional, Tuple

NONE, TRUE, FALSE, INT, FLOAT, STR, BYTES, LIST, DICT, OBJDEF, OBJ = range(11)

_F64 = struct.Struct("<d")
MAX_DEPTH = 64


class TLVError(Exception):
    """Malformed or unsafe wire input."""


# -- registry -----------------------------------------------------------------

_BY_NAME: Dict[str, type] = {}
_FIELDS: Dict[type, Tuple[str, ...]] = {}
# name -> (cls, ftup) for STATIC registry hits, shared with the C
# decoder so repeat OBJDEFs skip the Python callback (~35us/object of
# pure name-resolution on the watch hot path). Every successful
# resolution is of a registered class (the dynamic factory registers
# what it synthesizes), so a hit is always current; register() clears
# the cache to keep replace=True rebinds honest.
_RESOLVE_CACHE: Dict[str, tuple] = {}

# Optional factory for unknown class names (set by the third-party
# resource layer): fn(name, nfields) -> registered class or None. Lets a
# fresh process recover persisted dynamic kinds whose classes are
# synthesized at runtime. The factory only fires inside an explicit
# allow_dynamic() scope (durable-store recovery — a TRUSTED decode
# context); untrusted wire input can never register classes.
import contextlib as _contextlib
import threading as _threading

_DYNAMIC_FACTORY = None
_DYNAMIC_OK = _threading.local()


def set_dynamic_factory(fn) -> None:
    global _DYNAMIC_FACTORY
    _DYNAMIC_FACTORY = fn


@_contextlib.contextmanager
def allow_dynamic():
    """Enable the unknown-class factory for decodes on this thread."""
    prev = getattr(_DYNAMIC_OK, "on", False)
    _DYNAMIC_OK.on = True
    try:
        yield
    finally:
        _DYNAMIC_OK.on = prev


def register(cls: type, replace: bool = False) -> None:
    """Allow cls on the wire. Names must be unique across the registry
    (replace=True rebinds a name — the dynamic third-party kinds
    synthesize a fresh class per install)."""
    if not dataclasses.is_dataclass(cls):
        raise TypeError(f"{cls!r} is not a dataclass")
    name = cls.__name__
    cur = _BY_NAME.get(name)
    if cur is not None and cur is not cls and not replace:
        raise ValueError(f"wire name {name!r} already registered to {cur!r}")
    _BY_NAME[name] = cls
    _FIELDS[cls] = tuple(f.name for f in dataclasses.fields(cls))
    _RESOLVE_CACHE.clear()


def _ensure_registry() -> None:
    if _BY_NAME:
        return
    import kubernetes_tpu_torch.api.types as T

    for v in vars(T).values():
        if isinstance(v, type) and dataclasses.is_dataclass(v):
            register(v)


def fields_of(cls: type) -> Tuple[str, ...]:
    ftup = _FIELDS.get(cls)
    if ftup is None:
        _ensure_registry()
        ftup = _FIELDS.get(cls)
        if ftup is None:
            # late registration for project-internal dataclasses that
            # ride the wire (encode side only — decode still requires
            # an explicit register() on the receiving end)
            register(cls)
            ftup = _FIELDS[cls]
    return ftup


# -- encode -------------------------------------------------------------------


def _w_varint(out: bytearray, n: int) -> None:
    while n > 0x7F:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)


def _encode(v: Any, out: bytearray, ctab: Dict[type, int],
            depth: int) -> None:
    # ordered by wire frequency: str and None dominate API objects
    tv = type(v)
    if tv is str:
        b = v.encode("utf-8")
        k = len(b)
        if k < 0x80:  # inlined varint fast path
            out.append(STR)
            out.append(k)
        else:
            out.append(STR)
            _w_varint(out, k)
        out += b
        return
    if v is None:
        out.append(NONE)
        return
    if depth > MAX_DEPTH:
        raise TLVError("object graph too deep to encode")
    if tv is dict:
        out.append(DICT)
        _w_varint(out, len(v))
        d1 = depth + 1
        for k, item in v.items():
            _encode(k, out, ctab, d1)
            _encode(item, out, ctab, d1)
    elif tv is list or tv is tuple:
        out.append(LIST)
        _w_varint(out, len(v))
        d1 = depth + 1
        for item in v:
            _encode(item, out, ctab, d1)
    elif tv is bool:
        out.append(TRUE if v else FALSE)
    elif tv is int:
        out.append(INT)
        _w_varint(out, (v << 1) if v >= 0 else ((-v) << 1) - 1)
    elif tv is float:
        out.append(FLOAT)
        out += _F64.pack(v)
    elif tv is bytes:
        out.append(BYTES)
        _w_varint(out, len(v))
        out += v
    elif dataclasses.is_dataclass(v) and not isinstance(v, type):
        cid = ctab.get(tv)
        if cid is None:
            ftup = fields_of(tv)
            cid = len(ctab)
            ctab[tv] = cid
            out.append(OBJDEF)
            _w_varint(out, cid)
            nb = tv.__name__.encode("utf-8")
            _w_varint(out, len(nb))
            out += nb
            _w_varint(out, len(ftup))
        else:
            ftup = _FIELDS[tv]
            out.append(OBJ)
            _w_varint(out, cid)
        d = v.__dict__
        d1 = depth + 1
        for fname in ftup:
            _encode(d.get(fname), out, ctab, d1)
    elif isinstance(v, bool):
        out.append(TRUE if v else FALSE)
    elif isinstance(v, int):  # numpy-ish ints land here
        out.append(INT)
        n = int(v)
        _w_varint(out, (n << 1) if n >= 0 else ((-n) << 1) - 1)
    elif isinstance(v, float):
        out.append(FLOAT)
        out += _F64.pack(float(v))
    else:
        raise TLVError(f"type {tv.__name__} is not wire-encodable")


def _py_dumps(payload: Any) -> bytes:
    out = bytearray()
    _encode(payload, out, {}, 0)
    return bytes(out)


def dumps(payload: Any) -> bytes:
    if _ktlv is not None:
        try:
            return _ktlv.dumps(payload)
        except _ktlv.Fallback:
            pass  # >64-bit ints, numeric subclasses, slotted classes
    return _py_dumps(payload)


# -- decode -------------------------------------------------------------------


def loads(data: bytes) -> Any:
    if _ktlv is not None:
        try:
            return _ktlv.loads(data)
        except _ktlv.Fallback:
            pass  # e.g. >64-bit INT payloads: python path decides
    return _py_loads(data)


def _py_loads(data: bytes) -> Any:
    """Decode one value. Implemented as one closure over a position
    cursor with inlined varint/length fast paths — the method-call
    version ran ~3x slower, and decode sits on the watch hot path."""
    b = data
    nb = len(b)
    i = 0
    ctab: List[Tuple[type, Tuple[str, ...]]] = []
    new = object.__new__
    unpack_f64 = _F64.unpack_from

    def varint() -> int:
        nonlocal i
        shift = 0
        out = 0
        while True:
            if i >= nb:
                raise TLVError("truncated varint")
            c = b[i]
            i += 1
            out |= (c & 0x7F) << shift
            if not c & 0x80:
                return out
            shift += 7
            if shift > 126:
                raise TLVError("varint too long")

    def dec(depth: int) -> Any:
        nonlocal i
        if i >= nb:
            raise TLVError("truncated value")
        tag = b[i]
        i += 1
        if tag == STR:
            if i >= nb:
                raise TLVError("truncated varint")
            k = b[i]
            if k < 0x80:
                i += 1
            else:
                k = varint()
            j = i + k
            if j > nb:
                raise TLVError("truncated payload")
            s = b[i:j].decode("utf-8")
            i = j
            return s
        if tag == NONE:
            return None
        if depth > MAX_DEPTH:
            raise TLVError("object graph too deep to decode")
        if tag == DICT:
            k = varint()
            if 2 * k > nb - i:
                raise TLVError("dict length exceeds input")
            d1 = depth + 1
            return {dec(d1): dec(d1) for _ in range(k)}
        if tag == LIST:
            k = varint()
            if k > nb - i:  # every element is >= 1 byte
                raise TLVError("list length exceeds input")
            d1 = depth + 1
            return [dec(d1) for _ in range(k)]
        if tag == OBJ:
            cid = varint()
            if cid >= len(ctab):
                raise TLVError("reference to undefined class id")
            cls, ftup = ctab[cid]
            obj = new(cls)
            d1 = depth + 1
            obj.__dict__.update({f: dec(d1) for f in ftup})
            return obj
        if tag == TRUE:
            return True
        if tag == FALSE:
            return False
        if tag == INT:
            z = varint()
            return (z >> 1) if not z & 1 else -((z + 1) >> 1)
        if tag == FLOAT:
            if nb - i < 8:
                raise TLVError("truncated payload")
            f = unpack_f64(b, i)[0]
            i += 8
            return f
        if tag == BYTES:
            k = varint()
            j = i + k
            if j > nb:
                raise TLVError("truncated payload")
            out = b[i:j]
            i = j
            return out
        if tag == OBJDEF:
            cid = varint()
            if cid != len(ctab):
                raise TLVError("non-sequential class definition")
            k = varint()
            j = i + k
            if j > nb:
                raise TLVError("truncated payload")
            name = b[i:j].decode("utf-8")
            i = j
            nf = varint()
            cls, ftup = _resolve_class(name, nf)
            ctab.append((cls, ftup))
            obj = new(cls)
            d1 = depth + 1
            obj.__dict__.update({f: dec(d1) for f in ftup})
            return obj
        raise TLVError(f"unknown tag {tag}")

    try:
        out = dec(0)
    except TLVError:
        raise
    except Exception as e:
        # hostile input can also surface as UnicodeDecodeError (bad
        # utf-8 in STR/OBJDEF names) or TypeError (unhashable dict
        # key); every malformed-input failure must be TLVError so
        # callers' 400 handling holds
        raise TLVError(f"malformed input: {e}") from e
    if i != nb:
        raise TLVError(f"{nb - i} trailing bytes after value")
    return out


# -- native fast path ---------------------------------------------------------
#
# The C extension (native/_ktlv.c) implements the identical grammar and
# raises _ktlv.Fallback for anything it cannot reproduce bit-for-bit, in
# which case the Python codec above handles the whole payload.  The
# registry and the dynamic-class gate stay in Python: BOTH decoders call
# _resolve_class for every OBJDEF, so allow_dynamic() scoping and
# schema-drift checks behave identically on both paths.


def _resolve_class(name: str, nf: int):
    _ensure_registry()
    cls = _BY_NAME.get(name)
    if (cls is None and _DYNAMIC_FACTORY is not None
            and getattr(_DYNAMIC_OK, "on", False)):
        cls = _DYNAMIC_FACTORY(name, nf)
    if cls is None:
        raise TLVError(f"unknown wire class {name!r}")
    ftup = _FIELDS[cls]
    if nf != len(ftup):
        raise TLVError(
            f"schema drift for {name}: peer has {nf} fields, "
            f"local has {len(ftup)}"
        )
    _RESOLVE_CACHE[name] = (cls, ftup)
    return cls, ftup


def _load_native():
    try:
        from kubernetes_tpu_torch.native import build as _build
        if _build.ensure_ktlv() is None:
            return None
        from kubernetes_tpu_torch.native import _ktlv as mod  # type: ignore
    except Exception:
        return None
    mod.setup(TLVError, _FIELDS, fields_of, _resolve_class,
              _RESOLVE_CACHE, _BY_NAME)
    return mod


_ktlv = _load_native()
