/* Fast trace sink: the binary tracer's per-event hot path in C.
 *
 * Rebuild of the reference's profiling record path (reference:
 * parsec/profiling.c — parsec_profiling_trace_flags writes one
 * fixed-size record into a per-thread buffer with no allocation and
 * takes its own timestamp; tests/profiling-standalone/sp-perf.c is the
 * overhead harness).  ctypes costs ~1us per crossing, which is the
 * whole tracer budget, so this is a real CPython extension: one
 * METH_FASTCALL per event (~0.1-0.2us), timestamp taken in C with
 * CLOCK_MONOTONIC — the same clock CPython's time.perf_counter reads on
 * Linux, so C-stamped and Python-stamped events merge on one timeline.
 *
 * Single-writer discipline per sink (one sink per execution stream,
 * calls made under the GIL); drain() returns the records as tuples and
 * resets the buffer.
 *
 * The port's copy of the JAX package's pinsext.c.  Its one deliberate
 * difference: the module and its type carry a name of their own
 * (parsec_tpu_torch_pinsext), so both packages' extensions load in one
 * process.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <time.h>

typedef struct {
    int32_t key;
    int32_t flags;
    int64_t tp;
    int64_t eid;
    int64_t oid;
    double ts;
} pe_t;

typedef struct {
    PyObject_HEAD
    pe_t *buf;
    Py_ssize_t len, cap;
} SinkObject;

static inline double now_monotonic(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + (double)t.tv_nsec * 1e-9;
}

static int sink_grow(SinkObject *s) {
    Py_ssize_t ncap = s->cap ? s->cap * 2 : 4096;
    pe_t *nb = (pe_t *)realloc(s->buf, (size_t)ncap * sizeof(pe_t));
    if (!nb) {
        PyErr_NoMemory();
        return -1;
    }
    s->buf = nb;
    s->cap = ncap;
    return 0;
}

/* event(key, flags, taskpool_id, event_id, object_id) — timestamp taken
 * here, in C, at call time. */
static PyObject *sink_event(PyObject *self_, PyObject *const *args,
                            Py_ssize_t nargs) {
    SinkObject *s = (SinkObject *)self_;
    if (nargs != 5) {
        PyErr_SetString(PyExc_TypeError,
                        "event(key, flags, tp, eid, oid)");
        return NULL;
    }
    long long k = PyLong_AsLongLong(args[0]);
    long long f = PyLong_AsLongLong(args[1]);
    long long tp = PyLong_AsLongLong(args[2]);
    long long e = PyLong_AsLongLong(args[3]);
    long long o = PyLong_AsLongLong(args[4]);
    if (PyErr_Occurred())
        return NULL;
    if (s->len >= s->cap && sink_grow(s) < 0)
        return NULL;
    pe_t *ev = &s->buf[s->len++];
    ev->key = (int32_t)k;
    ev->flags = (int32_t)f;
    ev->tp = tp;
    ev->eid = e;
    ev->oid = o;
    ev->ts = now_monotonic();
    Py_RETURN_NONE;
}

/* event_at(key, flags, tp, eid, oid, ts) — caller-supplied timestamp. */
static PyObject *sink_event_at(PyObject *self_, PyObject *const *args,
                               Py_ssize_t nargs) {
    SinkObject *s = (SinkObject *)self_;
    if (nargs != 6) {
        PyErr_SetString(PyExc_TypeError,
                        "event_at(key, flags, tp, eid, oid, ts)");
        return NULL;
    }
    long long k = PyLong_AsLongLong(args[0]);
    long long f = PyLong_AsLongLong(args[1]);
    long long tp = PyLong_AsLongLong(args[2]);
    long long e = PyLong_AsLongLong(args[3]);
    long long o = PyLong_AsLongLong(args[4]);
    double ts = PyFloat_AsDouble(args[5]);
    if (PyErr_Occurred())
        return NULL;
    if (s->len >= s->cap && sink_grow(s) < 0)
        return NULL;
    pe_t *ev = &s->buf[s->len++];
    ev->key = (int32_t)k;
    ev->flags = (int32_t)f;
    ev->tp = tp;
    ev->eid = e;
    ev->oid = o;
    ev->ts = ts;
    Py_RETURN_NONE;
}

/* interval(key, tp, eid, oid, ts_begin, fstart, fend) — append BOTH
 * edges of one task interval in a single crossing: the START record
 * carries the caller-captured begin timestamp (a perf_counter() read,
 * same CLOCK_MONOTONIC timeline), the END record is stamped here in C.
 * One C call per task instead of two: the begin/end pairing moves
 * C-side. */
static PyObject *sink_interval(PyObject *self_, PyObject *const *args,
                               Py_ssize_t nargs) {
    SinkObject *s = (SinkObject *)self_;
    if (nargs != 7) {
        PyErr_SetString(PyExc_TypeError,
                        "interval(key, tp, eid, oid, ts_begin, fstart, "
                        "fend)");
        return NULL;
    }
    long long k = PyLong_AsLongLong(args[0]);
    long long tp = PyLong_AsLongLong(args[1]);
    long long e = PyLong_AsLongLong(args[2]);
    long long o = PyLong_AsLongLong(args[3]);
    double t0 = PyFloat_AsDouble(args[4]);
    long long fs = PyLong_AsLongLong(args[5]);
    long long fe = PyLong_AsLongLong(args[6]);
    if (PyErr_Occurred())
        return NULL;
    while (s->len + 2 > s->cap) {
        if (sink_grow(s) < 0)
            return NULL;
    }
    pe_t *ev = &s->buf[s->len];
    ev[0].key = (int32_t)k;
    ev[0].flags = (int32_t)fs;
    ev[0].tp = tp;
    ev[0].eid = e;
    ev[0].oid = o;
    ev[0].ts = t0;
    ev[1].key = (int32_t)k;
    ev[1].flags = (int32_t)fe;
    ev[1].tp = tp;
    ev[1].eid = e;
    ev[1].oid = o;
    ev[1].ts = now_monotonic();
    s->len += 2;
    Py_RETURN_NONE;
}

static PyObject *sink_drain(PyObject *self_, PyObject *noargs) {
    (void)noargs;
    SinkObject *s = (SinkObject *)self_;
    PyObject *out = PyList_New(s->len);
    if (!out)
        return NULL;
    for (Py_ssize_t i = 0; i < s->len; i++) {
        pe_t *ev = &s->buf[i];
        PyObject *t = Py_BuildValue(
            "(iiLLLd)", (int)ev->key, (int)ev->flags,
            (long long)ev->tp, (long long)ev->eid, (long long)ev->oid,
            ev->ts);
        if (!t) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, t);
    }
    s->len = 0;
    return out;
}

static Py_ssize_t sink_length(PyObject *self_) {
    return ((SinkObject *)self_)->len;
}

static void sink_dealloc(PyObject *self_) {
    SinkObject *s = (SinkObject *)self_;
    free(s->buf);
    Py_TYPE(self_)->tp_free(self_);
}

static PyObject *sink_new(PyTypeObject *type, PyObject *args,
                          PyObject *kwds) {
    (void)args;
    (void)kwds;
    SinkObject *s = (SinkObject *)type->tp_alloc(type, 0);
    if (s) {
        s->buf = NULL;
        s->len = 0;
        s->cap = 0;
    }
    return (PyObject *)s;
}

static PyMethodDef sink_methods[] = {
    {"event", (PyCFunction)(void (*)(void))sink_event, METH_FASTCALL,
     "append one record, timestamped in C"},
    {"event_at", (PyCFunction)(void (*)(void))sink_event_at,
     METH_FASTCALL, "append one record with a caller timestamp"},
    {"interval", (PyCFunction)(void (*)(void))sink_interval,
     METH_FASTCALL,
     "append a START (caller ts) + END (C ts) pair in one crossing"},
    {"drain", (PyCFunction)sink_drain, METH_NOARGS,
     "return all records as tuples and reset"},
    {NULL, NULL, 0, NULL}};

static PySequenceMethods sink_as_sequence = {
    .sq_length = sink_length,
};

static PyTypeObject SinkType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "parsec_tpu_torch_pinsext.TraceSink",
    .tp_basicsize = sizeof(SinkObject),
    .tp_dealloc = sink_dealloc,
    .tp_as_sequence = &sink_as_sequence,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = sink_methods,
    .tp_new = sink_new,
};

static PyObject *mod_now(PyObject *self_, PyObject *noargs) {
    (void)self_;
    (void)noargs;
    return PyFloat_FromDouble(now_monotonic());
}

static PyMethodDef mod_methods[] = {
    {"now", mod_now, METH_NOARGS, "CLOCK_MONOTONIC seconds"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef pinsext_module = {
    PyModuleDef_HEAD_INIT, "parsec_tpu_torch_pinsext",
    "C trace sink for the binary tracer hot path", -1, mod_methods,
    NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit_parsec_tpu_torch_pinsext(void) {
    PyObject *m;
    if (PyType_Ready(&SinkType) < 0)
        return NULL;
    m = PyModule_Create(&pinsext_module);
    if (!m)
        return NULL;
    Py_INCREF(&SinkType);
    if (PyModule_AddObject(m, "TraceSink", (PyObject *)&SinkType) < 0) {
        Py_DECREF(&SinkType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
