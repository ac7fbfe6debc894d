/* Native comm framing: the per-peer incremental frame parser and the
 * gather-write part assembly in C.
 *
 * The event-loop transport (comm/engine.py EventLoopCE) and the
 * shared-memory ring transport (comm/shm.py) both speak the same
 * byte-stream frame format: a 16-byte header (!IQI: tag, pickle
 * length, out-of-band buffer count), the pickle body, then per-buffer
 * length (!Q) + raw buffer.  The Python state machine costs several
 * function calls and slice copies per frame; here one ``feed()``
 * crossing consumes a whole read() worth of bytes and returns the
 * completed frames, and ``bulk_target``/``bulk_commit`` expose the
 * in-progress large payload buffer so the transport can recv_into it
 * directly (the zero-copy out-of-band path keeps working).
 *
 * Single-consumer discipline per parser (one parser per peer
 * connection/ring, driven by the comm loop thread under the GIL).
 *
 * The port's copy of the JAX package's commext.c.  Its one deliberate
 * difference: the module and its type carry a name of their own
 * (parsec_tpu_torch_commext), so both packages' extensions load in one
 * process.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#define HDR_SIZE 16     /* !IQI */
#define BLEN_SIZE 8     /* !Q   */
#define MAX_NBUFS 4096
/* below this, copying through feed() beats a dedicated recv_into */
#define BULK_MIN 65536

enum { ST_HDR, ST_BODY, ST_BLEN, ST_BUF };

typedef struct {
    PyObject_HEAD
    int stage;
    Py_ssize_t want, got;
    unsigned char small[HDR_SIZE];
    PyObject *target;       /* bytearray being filled (BODY/BUF) */
    uint32_t tag;
    uint64_t ln;
    uint32_t nbufs;
    PyObject *body;         /* completed body bytearray or NULL */
    PyObject *oob;          /* list of completed oob bytearrays */
    uint64_t max_frame;
    /* stats: frames completed through this parser */
    uint64_t frames;
} FPObject;

static inline uint32_t be32(const unsigned char *p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
           ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

static inline uint64_t be64(const unsigned char *p) {
    return ((uint64_t)be32(p) << 32) | (uint64_t)be32(p + 4);
}

static inline void put_be32(unsigned char *p, uint32_t v) {
    p[0] = (unsigned char)(v >> 24);
    p[1] = (unsigned char)(v >> 16);
    p[2] = (unsigned char)(v >> 8);
    p[3] = (unsigned char)v;
}

static inline void put_be64(unsigned char *p, uint64_t v) {
    put_be32(p, (uint32_t)(v >> 32));
    put_be32(p + 4, (uint32_t)v);
}

static void fp_expect_hdr(FPObject *f) {
    f->stage = ST_HDR;
    f->want = HDR_SIZE;
    f->got = 0;
    Py_CLEAR(f->target);
}

/* one stage filled: advance the machine; completed frames append to
 * ``out``.  Returns 0, or -1 with an exception set (corruption). */
static int fp_advance(FPObject *f, PyObject *out) {
    switch (f->stage) {
    case ST_HDR: {
        f->tag = be32(f->small);
        f->ln = be64(f->small + 4);
        f->nbufs = be32(f->small + 12);
        if (f->ln > f->max_frame || f->nbufs > MAX_NBUFS) {
            PyErr_Format(PyExc_ValueError,
                         "frame length %llu/%u bufs exceeds the bound "
                         "(tag=%u)", (unsigned long long)f->ln, f->nbufs,
                         f->tag);
            return -1;
        }
        Py_CLEAR(f->body);
        Py_CLEAR(f->oob);
        f->oob = PyList_New(0);
        if (!f->oob)
            return -1;
        if (f->ln) {
            f->target = PyByteArray_FromStringAndSize(NULL,
                                                      (Py_ssize_t)f->ln);
            if (!f->target)
                return -1;
            f->stage = ST_BODY;
            f->want = (Py_ssize_t)f->ln;
            f->got = 0;
            return 0;
        }
        break;    /* fall through to next_buf */
    }
    case ST_BODY:
        f->body = f->target;
        f->target = NULL;
        break;
    case ST_BLEN: {
        uint64_t bln = be64(f->small);
        if (bln > f->max_frame) {
            PyErr_Format(PyExc_ValueError,
                         "oob buffer length %llu (tag=%u)",
                         (unsigned long long)bln, f->tag);
            return -1;
        }
        f->target = PyByteArray_FromStringAndSize(NULL, (Py_ssize_t)bln);
        if (!f->target)
            return -1;
        if (bln) {
            f->stage = ST_BUF;
            f->want = (Py_ssize_t)bln;
            f->got = 0;
            return 0;
        }
        /* zero-length buffer: complete immediately */
        if (PyList_Append(f->oob, f->target) < 0)
            return -1;
        Py_CLEAR(f->target);
        break;
    }
    case ST_BUF:
        if (PyList_Append(f->oob, f->target) < 0)
            return -1;
        Py_CLEAR(f->target);
        break;
    }
    /* next_buf */
    if ((uint32_t)PyList_GET_SIZE(f->oob) < f->nbufs) {
        f->stage = ST_BLEN;
        f->want = BLEN_SIZE;
        f->got = 0;
        return 0;
    }
    /* frame complete */
    {
        PyObject *body = f->body ? f->body : Py_None;
        PyObject *tup = Py_BuildValue("(IOO)", f->tag, body, f->oob);
        if (!tup)
            return -1;
        int rc = PyList_Append(out, tup);
        Py_DECREF(tup);
        if (rc < 0)
            return -1;
        Py_CLEAR(f->body);
        Py_CLEAR(f->oob);
        f->frames++;
    }
    fp_expect_hdr(f);
    return 0;
}

/* feed(data) -> [(tag, body|None, [oob...]), ...] */
static PyObject *fp_feed(PyObject *self_, PyObject *const *args,
                         Py_ssize_t nargs) {
    FPObject *f = (FPObject *)self_;
    if (nargs != 1) {
        PyErr_SetString(PyExc_TypeError, "feed(data)");
        return NULL;
    }
    Py_buffer view;
    if (PyObject_GetBuffer(args[0], &view, PyBUF_SIMPLE) < 0)
        return NULL;
    PyObject *out = PyList_New(0);
    if (!out) {
        PyBuffer_Release(&view);
        return NULL;
    }
    const unsigned char *p = (const unsigned char *)view.buf;
    Py_ssize_t n = view.len, off = 0;
    while (off < n) {
        Py_ssize_t take = f->want - f->got;
        if (take > n - off)
            take = n - off;
        if (f->target) {
            memcpy(PyByteArray_AS_STRING(f->target) + f->got, p + off,
                   (size_t)take);
        } else {
            memcpy(f->small + f->got, p + off, (size_t)take);
        }
        f->got += take;
        off += take;
        if (f->got == f->want && fp_advance(f, out) < 0) {
            PyBuffer_Release(&view);
            Py_DECREF(out);
            return NULL;
        }
    }
    PyBuffer_Release(&view);
    return out;
}

/* bulk_target() -> writable memoryview of the in-progress payload's
 * remaining region, or None when the parser is between frames / the
 * remainder is small.  The parser keeps the backing bytearray alive;
 * the caller must recv_into the view and call bulk_commit(n) before
 * any other parser call. */
static PyObject *fp_bulk_target(PyObject *self_, PyObject *noargs) {
    (void)noargs;
    FPObject *f = (FPObject *)self_;
    if (!f->target || f->want - f->got < BULK_MIN)
        Py_RETURN_NONE;
    return PyMemoryView_FromMemory(
        PyByteArray_AS_STRING(f->target) + f->got,
        f->want - f->got, PyBUF_WRITE);
}

/* bulk_commit(n) -> frames completed by those n bytes (usually []) */
static PyObject *fp_bulk_commit(PyObject *self_, PyObject *const *args,
                                Py_ssize_t nargs) {
    FPObject *f = (FPObject *)self_;
    if (nargs != 1) {
        PyErr_SetString(PyExc_TypeError, "bulk_commit(nbytes)");
        return NULL;
    }
    Py_ssize_t nb = PyLong_AsSsize_t(args[0]);
    if (nb == -1 && PyErr_Occurred())
        return NULL;
    if (!f->target || nb < 0 || f->got + nb > f->want) {
        PyErr_SetString(PyExc_ValueError,
                        "bulk_commit outside an in-progress payload");
        return NULL;
    }
    PyObject *out = PyList_New(0);
    if (!out)
        return NULL;
    f->got += nb;
    if (f->got == f->want && fp_advance(f, out) < 0) {
        Py_DECREF(out);
        return NULL;
    }
    return out;
}

static PyObject *fp_stats(PyObject *self_, PyObject *noargs) {
    (void)noargs;
    return PyLong_FromUnsignedLongLong(((FPObject *)self_)->frames);
}

/* idle() -> True when the parser sits exactly between frames (EOF
 * here is a clean close; anywhere else the peer died mid-frame). */
static PyObject *fp_idle(PyObject *self_, PyObject *noargs) {
    (void)noargs;
    FPObject *f = (FPObject *)self_;
    return PyBool_FromLong(f->stage == ST_HDR && f->got == 0);
}

static void fp_dealloc(PyObject *self_) {
    FPObject *f = (FPObject *)self_;
    Py_CLEAR(f->target);
    Py_CLEAR(f->body);
    Py_CLEAR(f->oob);
    Py_TYPE(self_)->tp_free(self_);
}

static int fp_init(PyObject *self_, PyObject *args, PyObject *kwds) {
    (void)kwds;
    FPObject *f = (FPObject *)self_;
    unsigned long long max_frame;
    if (!PyArg_ParseTuple(args, "K", &max_frame))
        return -1;
    f->max_frame = max_frame;
    fp_expect_hdr(f);
    return 0;
}

static PyObject *fp_new(PyTypeObject *type, PyObject *args,
                        PyObject *kwds) {
    (void)args;
    (void)kwds;
    FPObject *f = (FPObject *)type->tp_alloc(type, 0);
    if (f) {
        f->target = f->body = f->oob = NULL;
        f->frames = 0;
        f->max_frame = 0;
        fp_expect_hdr(f);
    }
    return (PyObject *)f;
}

static PyMethodDef fp_methods[] = {
    {"feed", (PyCFunction)(void (*)(void))fp_feed, METH_FASTCALL,
     "feed(data) -> [(tag, body|None, [oob...]), ...]"},
    {"bulk_target", (PyCFunction)fp_bulk_target, METH_NOARGS,
     "writable view of the in-progress large payload, or None"},
    {"bulk_commit", (PyCFunction)(void (*)(void))fp_bulk_commit,
     METH_FASTCALL, "bulk_commit(n) -> frames completed"},
    {"idle", (PyCFunction)fp_idle, METH_NOARGS,
     "True when between frames (clean-close detector)"},
    {"stats", (PyCFunction)fp_stats, METH_NOARGS,
     "frames completed through this parser"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject FPType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "parsec_tpu_torch_commext.FrameParser",
    .tp_basicsize = sizeof(FPObject),
    .tp_dealloc = fp_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = fp_methods,
    .tp_init = fp_init,
    .tp_new = fp_new,
};

/* frame_parts(tag, body_bytes, raws) -> [header, body?, blen, raw, ...]
 * — the gather-write part list (one C crossing builds every length
 * header; the raw buffers themselves are passed through untouched). */
static PyObject *mod_frame_parts(PyObject *self_, PyObject *const *args,
                                 Py_ssize_t nargs) {
    (void)self_;
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "frame_parts(tag, body, raws)");
        return NULL;
    }
    unsigned long tag = PyLong_AsUnsignedLong(args[0]);
    if (tag == (unsigned long)-1 && PyErr_Occurred())
        return NULL;
    Py_ssize_t blen = 0;
    if (args[1] != Py_None) {
        blen = PyObject_Length(args[1]);
        if (blen < 0)
            return NULL;
    }
    PyObject *raws = PySequence_Fast(args[2], "raws must be a sequence");
    if (!raws)
        return NULL;
    Py_ssize_t nb = PySequence_Fast_GET_SIZE(raws);
    PyObject *hdr = PyBytes_FromStringAndSize(NULL, HDR_SIZE);
    if (!hdr) {
        Py_DECREF(raws);
        return NULL;
    }
    unsigned char *hp = (unsigned char *)PyBytes_AS_STRING(hdr);
    put_be32(hp, (uint32_t)tag);
    put_be64(hp + 4, (uint64_t)blen);
    put_be32(hp + 12, (uint32_t)nb);
    PyObject *out = PyList_New(0);
    if (!out)
        goto fail;
    if (PyList_Append(out, hdr) < 0)
        goto fail;
    if (blen && PyList_Append(out, args[1]) < 0)
        goto fail;
    for (Py_ssize_t i = 0; i < nb; i++) {
        PyObject *raw = PySequence_Fast_GET_ITEM(raws, i);
        Py_buffer v;
        if (PyObject_GetBuffer(raw, &v, PyBUF_SIMPLE) < 0)
            goto fail;
        Py_ssize_t rn = v.len;
        PyBuffer_Release(&v);
        PyObject *bl = PyBytes_FromStringAndSize(NULL, BLEN_SIZE);
        if (!bl)
            goto fail;
        put_be64((unsigned char *)PyBytes_AS_STRING(bl), (uint64_t)rn);
        int rc = PyList_Append(out, bl);
        Py_DECREF(bl);
        if (rc < 0)
            goto fail;
        if (rn && PyList_Append(out, raw) < 0)
            goto fail;
    }
    Py_DECREF(hdr);
    Py_DECREF(raws);
    return out;
fail:
    Py_XDECREF(out);
    Py_DECREF(hdr);
    Py_DECREF(raws);
    return NULL;
}

static PyMethodDef mod_methods[] = {
    {"frame_parts", (PyCFunction)(void (*)(void))mod_frame_parts,
     METH_FASTCALL,
     "frame_parts(tag, body, raws) -> gather-write part list"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef commext_module = {
    PyModuleDef_HEAD_INIT, "parsec_tpu_torch_commext",
    "native comm framing: incremental parser + part assembly", -1,
    mod_methods, NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit_parsec_tpu_torch_commext(void) {
    if (PyType_Ready(&FPType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&commext_module);
    if (!m)
        return NULL;
    Py_INCREF(&FPType);
    if (PyModule_AddObject(m, "FrameParser", (PyObject *)&FPType) < 0) {
        Py_DECREF(&FPType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
