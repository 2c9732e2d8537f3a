/* Native fast path for the TLV wire codec (runtime/tlv.py).
 *
 * Same wire grammar as the Python codec (see runtime/tlv.py header for
 * the grammar); this is a drop-in accelerator, not a second authority.
 * Anything the C path cannot reproduce bit-for-bit — >64-bit ints,
 * numeric subclasses, slotted dataclasses, dynamic third-party class
 * resolution — raises the module's `Fallback` exception and the Python
 * codec handles the whole payload instead.  Malformed input raises the
 * shared TLVError so callers' 400 handling is identical on both paths.
 *
 * Reference analogue: the generated protobuf marshallers of
 * pkg/runtime/serializer/protobuf/protobuf.go:17-33 — schema-driven
 * binary encode/decode kept off the reflective slow path.
 *
 * Built as a CPython extension (no pybind11 in this image — plain C
 * API, same pattern as _kquantity.c).
 *
 * Copy of kubernetes_tpu/native/_ktlv.c, unchanged; native/build.py of
 * this package builds it.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

enum {
    T_NONE, T_TRUE, T_FALSE, T_INT, T_FLOAT, T_STR, T_BYTES,
    T_LIST, T_DICT, T_OBJDEF, T_OBJ
};
#define MAX_DEPTH 64

/* set by setup() from runtime/tlv.py */
static PyObject *g_tlverror;   /* TLVError class */
static PyObject *g_fields;     /* _FIELDS: dict type -> tuple[str, ...] */
static PyObject *g_fields_of;  /* fields_of(cls) -> tuple (late-registers) */
static PyObject *g_resolve;    /* _resolve_class(name, nf) -> (cls, ftup) */
static PyObject *g_rcache;     /* _RESOLVE_CACHE: name -> (cls, ftup). A hit
                                * counts only when _BY_NAME still maps the
                                * name to the same class (registry mutations
                                * — replace=True, the third-party fresh-
                                * process path — must never be served a
                                * stale resolution) and the field count
                                * matches; then it equals a g_resolve
                                * success without the Python call */
static PyObject *g_by_name;    /* _BY_NAME: name -> cls (the registry) */
static PyObject *g_fallback;   /* Fallback exception class (module-owned) */

static int err_tlv(const char *msg) {
    PyErr_SetString(g_tlverror, msg);
    return -1;
}

static int err_fallback(void) {
    PyErr_SetString(g_fallback, "punt to python codec");
    return -1;
}

/* ---- growable output buffer ---------------------------------------- */

typedef struct {
    char *buf;
    Py_ssize_t len, cap;
} Buf;

static int buf_grow(Buf *w, Py_ssize_t need) {
    Py_ssize_t cap = w->cap ? w->cap : 256;
    while (cap - w->len < need) cap *= 2;
    char *nb = PyMem_Realloc(w->buf, cap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    w->buf = nb;
    w->cap = cap;
    return 0;
}

static inline int buf_byte(Buf *w, unsigned char c) {
    if (w->cap - w->len < 1 && buf_grow(w, 1) < 0) return -1;
    w->buf[w->len++] = (char)c;
    return 0;
}

static inline int buf_bytes(Buf *w, const char *p, Py_ssize_t n) {
    if (w->cap - w->len < n && buf_grow(w, n) < 0) return -1;
    memcpy(w->buf + w->len, p, (size_t)n);
    w->len += n;
    return 0;
}

static inline int buf_varint(Buf *w, uint64_t n) {
    if (w->cap - w->len < 10 && buf_grow(w, 10) < 0) return -1;
    while (n > 0x7F) {
        w->buf[w->len++] = (char)((n & 0x7F) | 0x80);
        n >>= 7;
    }
    w->buf[w->len++] = (char)n;
    return 0;
}

/* ---- encode -------------------------------------------------------- */

/* strict=1: tuples raise Fallback instead of encoding as LIST.  The
 * store's deep-copy path needs round-trip fidelity (pickle keeps
 * tuples, so the fast path must not silently listify what the
 * fallback would preserve); the wire path keeps tuple->LIST. */
static int enc(Buf *w, PyObject *v, PyObject *ctab, int depth, int strict);

static int enc_obj(Buf *w, PyObject *v, PyObject *ctab, int depth,
                   int strict) {
    PyTypeObject *tp = Py_TYPE(v);
    PyObject *cid = PyDict_GetItemWithError(ctab, (PyObject *)tp);
    PyObject *ftup;
    if (!cid && PyErr_Occurred()) return -1;
    if (cid) {
        ftup = PyDict_GetItemWithError(g_fields, (PyObject *)tp);
        if (!ftup) return PyErr_Occurred() ? -1 : err_fallback();
        if (buf_byte(w, T_OBJ) < 0) return -1;
        if (buf_varint(w, (uint64_t)PyLong_AsUnsignedLongLong(cid)) < 0)
            return -1;
    } else {
        ftup = PyDict_GetItemWithError(g_fields, (PyObject *)tp);
        if (!ftup) {
            if (PyErr_Occurred()) return -1;
            /* late registration through the Python authority */
            ftup = PyObject_CallFunctionObjArgs(
                g_fields_of, (PyObject *)tp, NULL);
            if (!ftup) return -1; /* TypeError etc. propagates */
            Py_DECREF(ftup);     /* owned copy lives in g_fields now */
            ftup = PyDict_GetItemWithError(g_fields, (PyObject *)tp);
            if (!ftup) return PyErr_Occurred() ? -1 : err_fallback();
        }
        Py_ssize_t ncid = PyDict_Size(ctab);
        PyObject *cido = PyLong_FromSsize_t(ncid);
        if (!cido) return -1;
        if (PyDict_SetItem(ctab, (PyObject *)tp, cido) < 0) {
            Py_DECREF(cido);
            return -1;
        }
        Py_DECREF(cido);
        if (buf_byte(w, T_OBJDEF) < 0) return -1;
        if (buf_varint(w, (uint64_t)ncid) < 0) return -1;
        /* the wire carries __name__ exactly (cold path: once per class
         * per payload) */
        PyObject *nm = PyObject_GetAttrString((PyObject *)tp, "__name__");
        if (!nm) return -1;
        Py_ssize_t nl;
        const char *name = PyUnicode_AsUTF8AndSize(nm, &nl);
        if (!name) { Py_DECREF(nm); return -1; }
        if (buf_varint(w, (uint64_t)nl) < 0 ||
            buf_bytes(w, name, nl) < 0) {
            Py_DECREF(nm);
            return -1;
        }
        Py_DECREF(nm);
        if (buf_varint(w, (uint64_t)PyTuple_GET_SIZE(ftup)) < 0) return -1;
    }
    if (!PyTuple_CheckExact(ftup)) return err_fallback();
    PyObject *dict = PyObject_GenericGetDict(v, NULL);
    if (!dict) {
        PyErr_Clear();
        return err_fallback(); /* slotted dataclass: python path decides */
    }
    Py_ssize_t nf = PyTuple_GET_SIZE(ftup);
    for (Py_ssize_t k = 0; k < nf; k++) {
        PyObject *fv = PyDict_GetItemWithError(
            dict, PyTuple_GET_ITEM(ftup, k));
        if (!fv && PyErr_Occurred()) { Py_DECREF(dict); return -1; }
        if (enc(w, fv ? fv : Py_None, ctab, depth + 1, strict) < 0) {
            Py_DECREF(dict);
            return -1;
        }
    }
    Py_DECREF(dict);
    return 0;
}

static int enc(Buf *w, PyObject *v, PyObject *ctab, int depth, int strict) {
    /* ordered by wire frequency: str and None dominate API objects */
    if (PyUnicode_CheckExact(v)) {
        Py_ssize_t k;
        const char *u = PyUnicode_AsUTF8AndSize(v, &k);
        if (!u) return -1;
        if (buf_byte(w, T_STR) < 0) return -1;
        if (buf_varint(w, (uint64_t)k) < 0) return -1;
        return buf_bytes(w, u, k);
    }
    if (v == Py_None) return buf_byte(w, T_NONE);
    if (depth > MAX_DEPTH) return err_tlv("object graph too deep to encode");
    if (PyDict_CheckExact(v)) {
        if (buf_byte(w, T_DICT) < 0) return -1;
        if (buf_varint(w, (uint64_t)PyDict_GET_SIZE(v)) < 0) return -1;
        PyObject *key, *val;
        Py_ssize_t pos = 0;
        while (PyDict_Next(v, &pos, &key, &val)) {
            if (enc(w, key, ctab, depth + 1, strict) < 0) return -1;
            if (enc(w, val, ctab, depth + 1, strict) < 0) return -1;
        }
        return 0;
    }
    if (PyList_CheckExact(v)) {
        Py_ssize_t n = PyList_GET_SIZE(v);
        if (buf_byte(w, T_LIST) < 0) return -1;
        if (buf_varint(w, (uint64_t)n) < 0) return -1;
        for (Py_ssize_t k = 0; k < n; k++)
            if (enc(w, PyList_GET_ITEM(v, k), ctab, depth + 1, strict) < 0)
                return -1;
        return 0;
    }
    if (PyTuple_CheckExact(v)) {
        if (strict) return err_fallback(); /* pickle keeps tuples */
        Py_ssize_t n = PyTuple_GET_SIZE(v);
        if (buf_byte(w, T_LIST) < 0) return -1;
        if (buf_varint(w, (uint64_t)n) < 0) return -1;
        for (Py_ssize_t k = 0; k < n; k++)
            if (enc(w, PyTuple_GET_ITEM(v, k), ctab, depth + 1, strict) < 0)
                return -1;
        return 0;
    }
    if (v == Py_True) return buf_byte(w, T_TRUE);
    if (v == Py_False) return buf_byte(w, T_FALSE);
    if (PyLong_CheckExact(v)) {
        int overflow = 0;
        long long n = PyLong_AsLongLongAndOverflow(v, &overflow);
        if (overflow) return err_fallback(); /* >64-bit: python path */
        if (n == -1 && PyErr_Occurred()) return -1;
        uint64_t z = ((uint64_t)n << 1) ^ (uint64_t)(n >> 63); /* zigzag */
        if (buf_byte(w, T_INT) < 0) return -1;
        return buf_varint(w, z);
    }
    if (PyFloat_CheckExact(v)) {
        double d = PyFloat_AS_DOUBLE(v);
        uint64_t bits;
        memcpy(&bits, &d, 8);
        unsigned char le[8];
        for (int k = 0; k < 8; k++) le[k] = (unsigned char)(bits >> (8 * k));
        if (buf_byte(w, T_FLOAT) < 0) return -1;
        return buf_bytes(w, (const char *)le, 8);
    }
    if (PyBytes_CheckExact(v)) {
        Py_ssize_t n = PyBytes_GET_SIZE(v);
        if (buf_byte(w, T_BYTES) < 0) return -1;
        if (buf_varint(w, (uint64_t)n) < 0) return -1;
        return buf_bytes(w, PyBytes_AS_STRING(v), n);
    }
    /* dataclass instance?  (type carries __dataclass_fields__; a class
     * object itself — Py_TYPE == type — never does) */
    if (PyDict_GetItemWithError(g_fields, (PyObject *)Py_TYPE(v)) ||
        (!PyErr_Occurred() &&
         PyObject_HasAttrString((PyObject *)Py_TYPE(v),
                                "__dataclass_fields__")))
        return enc_obj(w, v, ctab, depth, strict);
    if (PyErr_Occurred()) return -1;
    /* subclasses of bool/int/float, numpy scalars, and genuinely
     * un-encodable types: let the Python authority decide */
    return err_fallback();
}

static int check_setup(void) {
    if (g_tlverror && g_fields && g_fields_of && g_resolve && g_rcache &&
        g_by_name)
        return 0;
    PyErr_SetString(PyExc_RuntimeError, "_ktlv.setup() not called");
    return -1;
}

static PyObject *dumps_common(PyObject *arg, int strict) {
    if (check_setup() < 0) return NULL;
    Buf w = {0};
    PyObject *ctab = PyDict_New();
    if (!ctab) return NULL;
    if (enc(&w, arg, ctab, 0, strict) < 0) {
        Py_DECREF(ctab);
        PyMem_Free(w.buf);
        return NULL;
    }
    Py_DECREF(ctab);
    PyObject *out = PyBytes_FromStringAndSize(w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
}

static PyObject *ktlv_dumps(PyObject *self, PyObject *arg) {
    return dumps_common(arg, 0);
}

static PyObject *ktlv_dumps_strict(PyObject *self, PyObject *arg) {
    return dumps_common(arg, 1);
}

/* ---- decode -------------------------------------------------------- */

typedef struct {
    const unsigned char *b;
    Py_ssize_t i, nb;
    PyObject *ctab; /* list of (cls, ftup) */
} Rd;

/* returns 0 ok, -1 error.  >64-bit varints raise Fallback (the Python
 * decoder supports up to 126-bit ints; lengths that large are errors
 * either way, so only INT payloads genuinely reach the fallback). */
static int rd_varint(Rd *r, uint64_t *out) {
    uint64_t acc = 0;
    int shift = 0;
    for (;;) {
        if (r->i >= r->nb) return err_tlv("truncated varint");
        unsigned char c = r->b[r->i++];
        if (shift >= 64 || (shift == 63 && (c & 0x7E)))
            return err_fallback();
        acc |= (uint64_t)(c & 0x7F) << shift;
        if (!(c & 0x80)) { *out = acc; return 0; }
        shift += 7;
    }
}

static PyObject *dec(Rd *r, int depth) {
    if (r->i >= r->nb) { err_tlv("truncated value"); return NULL; }
    unsigned char tag = r->b[r->i++];
    switch (tag) {
    case T_STR: {
        uint64_t k;
        if (rd_varint(r, &k) < 0) return NULL;
        if (k > (uint64_t)(r->nb - r->i)) {
            err_tlv("truncated payload");
            return NULL;
        }
        PyObject *s = PyUnicode_DecodeUTF8(
            (const char *)r->b + r->i, (Py_ssize_t)k, NULL);
        if (s) r->i += (Py_ssize_t)k;
        return s; /* UnicodeDecodeError wrapped by caller */
    }
    case T_NONE:
        Py_RETURN_NONE;
    default:
        break;
    }
    if (depth > MAX_DEPTH) {
        err_tlv("object graph too deep to decode");
        return NULL;
    }
    switch (tag) {
    case T_TRUE:
        Py_RETURN_TRUE;
    case T_FALSE:
        Py_RETURN_FALSE;
    case T_INT: {
        uint64_t z;
        if (rd_varint(r, &z) < 0) return NULL;
        /* un-zigzag; INT64_MIN round-trips via the unsigned form */
        int64_t n = (int64_t)(z >> 1) ^ -(int64_t)(z & 1);
        return PyLong_FromLongLong(n);
    }
    case T_FLOAT: {
        if (r->nb - r->i < 8) { err_tlv("truncated payload"); return NULL; }
        uint64_t bits = 0;
        for (int k = 0; k < 8; k++)
            bits |= (uint64_t)r->b[r->i + k] << (8 * k);
        r->i += 8;
        double d;
        memcpy(&d, &bits, 8);
        return PyFloat_FromDouble(d);
    }
    case T_BYTES: {
        uint64_t k;
        if (rd_varint(r, &k) < 0) return NULL;
        if (k > (uint64_t)(r->nb - r->i)) {
            err_tlv("truncated payload");
            return NULL;
        }
        PyObject *out = PyBytes_FromStringAndSize(
            (const char *)r->b + r->i, (Py_ssize_t)k);
        if (out) r->i += (Py_ssize_t)k;
        return out;
    }
    case T_LIST: {
        uint64_t k;
        if (rd_varint(r, &k) < 0) return NULL;
        if (k > (uint64_t)(r->nb - r->i)) { /* every element >= 1 byte */
            err_tlv("list length exceeds input");
            return NULL;
        }
        PyObject *lst = PyList_New((Py_ssize_t)k);
        if (!lst) return NULL;
        for (Py_ssize_t j = 0; j < (Py_ssize_t)k; j++) {
            PyObject *item = dec(r, depth + 1);
            if (!item) { Py_DECREF(lst); return NULL; }
            PyList_SET_ITEM(lst, j, item);
        }
        return lst;
    }
    case T_DICT: {
        uint64_t k;
        if (rd_varint(r, &k) < 0) return NULL;
        if (2 * k > (uint64_t)(r->nb - r->i)) {
            err_tlv("dict length exceeds input");
            return NULL;
        }
        PyObject *d = PyDict_New();
        if (!d) return NULL;
        for (uint64_t j = 0; j < k; j++) {
            PyObject *key = dec(r, depth + 1);
            if (!key) { Py_DECREF(d); return NULL; }
            PyObject *val = dec(r, depth + 1);
            if (!val) { Py_DECREF(key); Py_DECREF(d); return NULL; }
            int rc = PyDict_SetItem(d, key, val);
            Py_DECREF(key);
            Py_DECREF(val);
            if (rc < 0) { Py_DECREF(d); return NULL; } /* unhashable key */
        }
        return d;
    }
    case T_OBJ:
    case T_OBJDEF: {
        PyObject *cls, *ftup;
        if (tag == T_OBJ) {
            uint64_t cid;
            if (rd_varint(r, &cid) < 0) return NULL;
            if (cid >= (uint64_t)PyList_GET_SIZE(r->ctab)) {
                err_tlv("reference to undefined class id");
                return NULL;
            }
            PyObject *pair = PyList_GET_ITEM(r->ctab, (Py_ssize_t)cid);
            cls = PyTuple_GET_ITEM(pair, 0);
            ftup = PyTuple_GET_ITEM(pair, 1);
        } else {
            uint64_t cid, k, nf;
            if (rd_varint(r, &cid) < 0) return NULL;
            if (cid != (uint64_t)PyList_GET_SIZE(r->ctab)) {
                err_tlv("non-sequential class definition");
                return NULL;
            }
            if (rd_varint(r, &k) < 0) return NULL;
            if (k > (uint64_t)(r->nb - r->i)) {
                err_tlv("truncated payload");
                return NULL;
            }
            PyObject *name = PyUnicode_DecodeUTF8(
                (const char *)r->b + r->i, (Py_ssize_t)k, NULL);
            if (!name) return NULL;
            r->i += (Py_ssize_t)k;
            if (rd_varint(r, &nf) < 0) { Py_DECREF(name); return NULL; }
            /* fast path: a still-current cache hit with the expected
             * field count is exactly what g_resolve would return */
            PyObject *pair = PyDict_GetItemWithError(g_rcache, name);
            if (pair != NULL && PyTuple_CheckExact(pair) &&
                PyTuple_GET_SIZE(pair) == 2 &&
                PyDict_GetItemWithError(g_by_name, name) ==
                    PyTuple_GET_ITEM(pair, 0) &&
                PyTuple_CheckExact(PyTuple_GET_ITEM(pair, 1)) &&
                (uint64_t)PyTuple_GET_SIZE(PyTuple_GET_ITEM(pair, 1)) == nf) {
                Py_INCREF(pair);
            } else {
                if (pair == NULL && PyErr_Occurred()) {
                    Py_DECREF(name);
                    return NULL;
                }
                /* class lookup incl. _ensure_registry + schema-drift
                 * check + gated dynamic factory lives in Python (it
                 * also populates g_rcache on success) */
                pair = PyObject_CallFunction(
                    g_resolve, "OK", name, (unsigned long long)nf);
            }
            Py_DECREF(name);
            if (!pair) return NULL;
            if (!PyTuple_CheckExact(pair) || PyTuple_GET_SIZE(pair) != 2) {
                Py_DECREF(pair);
                err_fallback();
                return NULL;
            }
            if (PyList_Append(r->ctab, pair) < 0) {
                Py_DECREF(pair);
                return NULL;
            }
            cls = PyTuple_GET_ITEM(pair, 0);
            ftup = PyTuple_GET_ITEM(pair, 1);
            Py_DECREF(pair); /* ctab holds the reference now */
        }
        PyTypeObject *tp = (PyTypeObject *)cls;
        if (!PyType_Check(cls) || tp->tp_alloc == NULL) {
            err_fallback();
            return NULL;
        }
        PyObject *obj = tp->tp_alloc(tp, 0); /* == object.__new__(cls) */
        if (!obj) return NULL;
        PyObject *dict = PyObject_GenericGetDict(obj, NULL);
        if (!dict) {
            PyErr_Clear();
            Py_DECREF(obj);
            err_fallback(); /* slotted class: python path decides */
            return NULL;
        }
        Py_ssize_t nfl = PyTuple_GET_SIZE(ftup);
        for (Py_ssize_t j = 0; j < nfl; j++) {
            PyObject *val = dec(r, depth + 1);
            if (!val) { Py_DECREF(dict); Py_DECREF(obj); return NULL; }
            int rc = PyDict_SetItem(
                dict, PyTuple_GET_ITEM(ftup, j), val);
            Py_DECREF(val);
            if (rc < 0) { Py_DECREF(dict); Py_DECREF(obj); return NULL; }
        }
        Py_DECREF(dict);
        return obj;
    }
    default: {
        char msg[64];
        snprintf(msg, sizeof msg, "unknown tag %u", (unsigned)tag);
        err_tlv(msg);
        return NULL;
    }
    }
}

static PyObject *ktlv_loads(PyObject *self, PyObject *arg) {
    if (check_setup() < 0) return NULL;
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    Rd r = {(const unsigned char *)view.buf, 0, view.len, NULL};
    r.ctab = PyList_New(0);
    if (!r.ctab) { PyBuffer_Release(&view); return NULL; }
    PyObject *out = dec(&r, 0);
    Py_DECREF(r.ctab);
    if (out && r.i != r.nb) {
        Py_DECREF(out);
        out = NULL;
        char msg[64];
        snprintf(msg, sizeof msg, "%zd trailing bytes after value",
                 r.nb - r.i);
        PyErr_SetString(g_tlverror, msg);
    }
    PyBuffer_Release(&view);
    if (!out && !PyErr_ExceptionMatches(g_tlverror) &&
        !PyErr_ExceptionMatches(g_fallback)) {
        /* hostile input surfacing as UnicodeDecodeError etc. must be
         * TLVError so callers' 400 handling holds (tlv.py loads tail) */
        PyObject *t, *v, *tb;
        PyErr_Fetch(&t, &v, &tb);
        PyErr_NormalizeException(&t, &v, &tb);
        PyObject *msg = PyObject_Str(v);
        PyErr_Format(g_tlverror, "malformed input: %U",
                     msg ? msg : Py_None);
        Py_XDECREF(msg);
        Py_XDECREF(t);
        Py_XDECREF(v);
        Py_XDECREF(tb);
    }
    return out;
}

/* ---- module -------------------------------------------------------- */

static PyObject *ktlv_setup(PyObject *self, PyObject *args) {
    PyObject *err, *fields, *fields_of, *resolve, *rcache, *by_name;
    if (!PyArg_ParseTuple(args, "OOOOO!O!", &err, &fields, &fields_of,
                          &resolve, &PyDict_Type, &rcache,
                          &PyDict_Type, &by_name))
        return NULL;
    Py_XINCREF(err);
    Py_XINCREF(fields);
    Py_XINCREF(fields_of);
    Py_XINCREF(resolve);
    Py_XINCREF(rcache);
    Py_XINCREF(by_name);
    Py_XDECREF(g_tlverror);
    Py_XDECREF(g_fields);
    Py_XDECREF(g_fields_of);
    Py_XDECREF(g_resolve);
    Py_XDECREF(g_rcache);
    Py_XDECREF(g_by_name);
    g_tlverror = err;
    g_fields = fields;
    g_fields_of = fields_of;
    g_resolve = resolve;
    g_rcache = rcache;
    g_by_name = by_name;
    Py_RETURN_NONE;
}

static PyMethodDef ktlv_methods[] = {
    {"setup", ktlv_setup, METH_VARARGS,
     "setup(TLVError, fields_dict, fields_of, resolve_class, "
     "resolve_cache, by_name)"},
    {"dumps", ktlv_dumps, METH_O, "encode one value to TLV bytes"},
    {"dumps_strict", ktlv_dumps_strict, METH_O,
     "encode, raising Fallback on tuples (round-trip fidelity paths)"},
    {"loads", ktlv_loads, METH_O, "decode one TLV value"},
    {NULL, NULL, 0, NULL}
};

static struct PyModuleDef ktlv_module = {
    PyModuleDef_HEAD_INIT, "_ktlv",
    "native TLV wire codec fast path", -1, ktlv_methods
};

PyMODINIT_FUNC PyInit__ktlv(void) {
    PyObject *m = PyModule_Create(&ktlv_module);
    if (!m) return NULL;
    g_fallback = PyErr_NewException("_ktlv.Fallback", NULL, NULL);
    if (!g_fallback || PyModule_AddObject(m, "Fallback", g_fallback) < 0) {
        Py_XDECREF(g_fallback);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(g_fallback); /* module-global use after AddObject steals */
    return m;
}
