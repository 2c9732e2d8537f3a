/* Native quantity parser (the host-side hot loop of snapshot encoding).
 *
 * Parses the reference's canonical quantity forms
 * (pkg/api/resource/quantity.go): decimal numbers with optional decimal
 * SI suffixes (n u m k M G T P E) or binary suffixes (Ki..Ei), and
 * returns an exact rational as a (numerator, denominator) pair of Python
 * ints. Scientific notation and anything unusual returns None so the
 * Python parser (api/resource.py) stays the semantic authority; this is
 * purely a fast path for the overwhelmingly common forms.
 *
 * Built as a CPython extension (no pybind11 in this image — plain C API
 * per the build environment notes).
 *
 * Copy of kubernetes_tpu/native/_kquantity.c, unchanged; native/build.py of
 * this package builds it.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

/* returns 0 on handled, -1 on "let Python do it" */
static int parse_core(const char *s, Py_ssize_t len,
                      int64_t *num, int64_t *den) {
    if (len == 0 || len > 24) return -1;
    const char *p = s;
    const char *end = s + len;
    int neg = 0;
    if (*p == '+' || *p == '-') {
        neg = (*p == '-');
        p++;
    }
    /* integer part */
    int64_t mant = 0;
    int digits = 0, frac_digits = 0;
    while (p < end && *p >= '0' && *p <= '9') {
        if (mant > (INT64_MAX - 9) / 10) return -1; /* overflow: punt */
        mant = mant * 10 + (*p - '0');
        digits++; p++;
    }
    if (p < end && *p == '.') {
        p++;
        while (p < end && *p >= '0' && *p <= '9') {
            if (mant > (INT64_MAX - 9) / 10) return -1;
            if (frac_digits >= 15) return -1;
            mant = mant * 10 + (*p - '0');
            digits++; frac_digits++; p++;
        }
    }
    if (digits == 0) return -1;
    if (p < end && (*p == 'e' || *p == 'E')) return -1; /* scientific: punt */

    int64_t mult_num = 1, mult_den = 1;
    if (p < end) {
        Py_ssize_t rem = end - p;
        if (rem == 1) {
            switch (*p) {
            case 'n': mult_den = 1000000000LL; break;
            case 'u': mult_den = 1000000LL; break;
            case 'm': mult_den = 1000LL; break;
            case 'k': mult_num = 1000LL; break;
            case 'M': mult_num = 1000000LL; break;
            case 'G': mult_num = 1000000000LL; break;
            case 'T': mult_num = 1000000000000LL; break;
            case 'P': mult_num = 1000000000000000LL; break;
            case 'E': mult_num = 1000000000000000000LL; break;
            default: return -1;
            }
            p++;
        } else if (rem == 2 && p[1] == 'i') {
            switch (p[0]) {
            case 'K': mult_num = 1LL << 10; break;
            case 'M': mult_num = 1LL << 20; break;
            case 'G': mult_num = 1LL << 30; break;
            case 'T': mult_num = 1LL << 40; break;
            case 'P': mult_num = 1LL << 50; break;
            case 'E': mult_num = 1LL << 60; break;
            default: return -1;
            }
            p += 2;
        } else {
            return -1;
        }
    }
    if (p != end) return -1;

    /* value = mant / 10^frac_digits * mult_num / mult_den */
    int64_t d = mult_den;
    for (int i = 0; i < frac_digits; i++) {
        if (d > INT64_MAX / 10) return -1;
        d *= 10;
    }
    /* mant * mult_num may overflow: check */
    if (mult_num != 1 && mant != 0 && mant > INT64_MAX / mult_num) return -1;
    int64_t n = mant * mult_num;
    if (neg) n = -n;
    *num = n;
    *den = d;
    return 0;
}

static PyObject *kq_parse(PyObject *self, PyObject *arg) {
    if (!PyUnicode_Check(arg)) Py_RETURN_NONE;
    Py_ssize_t len;
    const char *s = PyUnicode_AsUTF8AndSize(arg, &len);
    if (s == NULL) return NULL;
    int64_t num, den;
    if (parse_core(s, len, &num, &den) != 0) Py_RETURN_NONE;
    return Py_BuildValue("(LL)", (long long)num, (long long)den);
}

static PyMethodDef kq_methods[] = {
    {"parse", kq_parse, METH_O,
     "parse(s) -> (numerator, denominator) or None when unhandled"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef kq_module = {
    PyModuleDef_HEAD_INIT, "_kquantity",
    "native resource-quantity fast path", -1, kq_methods,
};

PyMODINIT_FUNC PyInit__kquantity(void) {
    return PyModule_Create(&kq_module);
}
