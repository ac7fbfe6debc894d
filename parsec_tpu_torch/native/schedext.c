/* Native scheduler hot path: the ready queue and the dep countdown in C.
 *
 * Rebuild of the reference's native scheduling core (reference:
 * parsec/mca/sched/* queue disciplines over parsec_list_item rings and
 * the atomic dep countdown of parsec_internal.h:355-366
 * update_deps_with_counter): the per-scheduling-event Python work —
 * status transition, Task.ready_at stamping, priority-ordered
 * push/pop, and the dep-counter decrement + ready-transition test —
 * collapses into ONE METH_FASTCALL crossing per event, the pinsext.c
 * pattern (tracer 5.0 -> 1.16 us/task) applied to the scheduler.
 *
 * Concurrency model: every entry point runs under the GIL and never
 * releases it (no callbacks into Python between state mutations except
 * where noted), so the GIL itself is the queue lock — the Python
 * fallback pays a threading.Lock round-trip per operation ON TOP of
 * the GIL; this pays neither.  The heap entries own strong references
 * to their tasks (the C-side twin of NativeDequeue's park/claim side
 * table, without the ctypes crossing or the id-keyed parking dict).
 *
 * The port's copy of the JAX package's schedext.c.  Its deliberate
 * differences: ensure_runtime imports the port's modules
 * (parsec_tpu_torch.*), the module and its types carry a name of their
 * own (parsec_tpu_torch_schedext, so both packages' extensions load in
 * one process).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

static inline double now_monotonic(void) {
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + (double)t.tv_nsec * 1e-9;
}

/* interned attribute names, created at module init */
static PyObject *s_status, *s_ready_at, *s_priority;

/* ------------------------------------------------------------------ */
/* ReadyQueue: binary max-heap of (priority, FIFO seq) -> task        */
/* ------------------------------------------------------------------ */

typedef struct {
    int64_t prio;       /* higher pops first */
    uint64_t seq;       /* FIFO among equal priorities */
    PyObject *task;     /* strong reference */
} rq_ent_t;

typedef struct {
    PyObject_HEAD
    rq_ent_t *heap;
    Py_ssize_t len, cap;
    uint64_t seq;
    /* stats (display_stats / metrics scrape) */
    uint64_t pushes, pops;
    Py_ssize_t max_len;
    PyObject *ready_status;   /* TaskStatus.READY, set at construction */
} RQObject;

static int rq_grow(RQObject *q) {
    Py_ssize_t ncap = q->cap ? q->cap * 2 : 1024;
    rq_ent_t *nh = (rq_ent_t *)realloc(q->heap,
                                       (size_t)ncap * sizeof(rq_ent_t));
    if (!nh) {
        PyErr_NoMemory();
        return -1;
    }
    q->heap = nh;
    q->cap = ncap;
    return 0;
}

/* entry a beats entry b (pops first)? */
static inline int rq_before(const rq_ent_t *a, const rq_ent_t *b) {
    if (a->prio != b->prio)
        return a->prio > b->prio;
    return a->seq < b->seq;
}

static void rq_sift_up(RQObject *q, Py_ssize_t i) {
    rq_ent_t e = q->heap[i];
    while (i > 0) {
        Py_ssize_t p = (i - 1) / 2;
        if (!rq_before(&e, &q->heap[p]))
            break;
        q->heap[i] = q->heap[p];
        i = p;
    }
    q->heap[i] = e;
}

static void rq_sift_down(RQObject *q, Py_ssize_t i) {
    rq_ent_t e = q->heap[i];
    Py_ssize_t n = q->len;
    for (;;) {
        Py_ssize_t c = 2 * i + 1;
        if (c >= n)
            break;
        if (c + 1 < n && rq_before(&q->heap[c + 1], &q->heap[c]))
            c++;
        if (!rq_before(&q->heap[c], &e))
            break;
        q->heap[i] = q->heap[c];
        i = c;
    }
    q->heap[i] = e;
}

/* push one task: read .priority, set .status (and .ready_at when
 * stamping), insert.  prio_override INT64_MIN means "back of the
 * queue" (the fairness contract for distance-rescheduled tasks). */
static int rq_push_one(RQObject *q, PyObject *task, int stamp,
                       int to_back, double now) {
    int64_t prio = 0;
    if (to_back) {
        prio = INT64_MIN;
    } else {
        PyObject *p = PyObject_GetAttr(task, s_priority);
        if (!p)
            return -1;
        prio = PyLong_AsLongLong(p);
        Py_DECREF(p);
        if (prio == -1 && PyErr_Occurred())
            return -1;
    }
    if (PyObject_SetAttr(task, s_status, q->ready_status) < 0)
        return -1;
    if (stamp) {
        PyObject *ts = PyFloat_FromDouble(now);
        if (!ts)
            return -1;
        int r = PyObject_SetAttr(task, s_ready_at, ts);
        Py_DECREF(ts);
        if (r < 0)
            return -1;
    }
    if (q->len >= q->cap && rq_grow(q) < 0)
        return -1;
    rq_ent_t *e = &q->heap[q->len++];
    e->prio = prio;
    e->seq = q->seq++;
    e->task = task;
    Py_INCREF(task);
    rq_sift_up(q, q->len - 1);
    q->pushes++;
    if (q->len > q->max_len)
        q->max_len = q->len;
    return 0;
}

/* push_batch(tasks, stamp, to_back=0) — ONE crossing per scheduling
 * event: the whole ready ring transitions to READY (ready_at stamped
 * from one clock read: the batch became ready at the same moment,
 * matching core/scheduling.schedule's Python fallback) and lands in
 * the heap. */
static PyObject *rq_push_batch(PyObject *self_, PyObject *const *args,
                               Py_ssize_t nargs) {
    RQObject *q = (RQObject *)self_;
    if (nargs < 2 || nargs > 3) {
        PyErr_SetString(PyExc_TypeError,
                        "push_batch(tasks, stamp[, to_back])");
        return NULL;
    }
    int stamp = PyObject_IsTrue(args[1]);
    if (stamp < 0)
        return NULL;
    int to_back = 0;
    if (nargs == 3) {
        to_back = PyObject_IsTrue(args[2]);
        if (to_back < 0)
            return NULL;
    }
    PyObject *fast = PySequence_Fast(args[0], "tasks must be a sequence");
    if (!fast)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    PyObject **items = PySequence_Fast_ITEMS(fast);
    double now = stamp ? now_monotonic() : 0.0;
    for (Py_ssize_t i = 0; i < n; i++) {
        if (rq_push_one(q, items[i], stamp, to_back, now) < 0) {
            Py_DECREF(fast);
            return NULL;
        }
    }
    Py_DECREF(fast);
    Py_RETURN_NONE;
}

static PyObject *rq_pop(PyObject *self_, PyObject *noargs) {
    (void)noargs;
    RQObject *q = (RQObject *)self_;
    if (q->len == 0)
        Py_RETURN_NONE;
    PyObject *task = q->heap[0].task;   /* ownership moves to caller */
    q->len--;
    if (q->len > 0) {
        q->heap[0] = q->heap[q->len];
        rq_sift_down(q, 0);
    }
    q->pops++;
    return task;
}

static PyObject *rq_stats(PyObject *self_, PyObject *noargs) {
    (void)noargs;
    RQObject *q = (RQObject *)self_;
    return Py_BuildValue("(KKnn)", (unsigned long long)q->pushes,
                         (unsigned long long)q->pops, q->max_len, q->len);
}

static Py_ssize_t rq_length(PyObject *self_) {
    return ((RQObject *)self_)->len;
}

static void rq_dealloc(PyObject *self_) {
    RQObject *q = (RQObject *)self_;
    for (Py_ssize_t i = 0; i < q->len; i++)
        Py_DECREF(q->heap[i].task);
    free(q->heap);
    Py_CLEAR(q->ready_status);
    Py_TYPE(self_)->tp_free(self_);
}

static int rq_init(PyObject *self_, PyObject *args, PyObject *kwds) {
    (void)kwds;
    RQObject *q = (RQObject *)self_;
    PyObject *ready;
    if (!PyArg_ParseTuple(args, "O", &ready))
        return -1;
    Py_INCREF(ready);
    Py_XSETREF(q->ready_status, ready);
    return 0;
}

static PyObject *rq_new(PyTypeObject *type, PyObject *args,
                        PyObject *kwds) {
    (void)args;
    (void)kwds;
    RQObject *q = (RQObject *)type->tp_alloc(type, 0);
    if (q) {
        q->heap = NULL;
        q->len = q->cap = 0;
        q->seq = 0;
        q->pushes = q->pops = 0;
        q->max_len = 0;
        q->ready_status = NULL;
    }
    return (PyObject *)q;
}

static PyMethodDef rq_methods[] = {
    {"push_batch", (PyCFunction)(void (*)(void))rq_push_batch,
     METH_FASTCALL,
     "push_batch(tasks, stamp[, to_back]): READY-transition + ready_at "
     "stamp + priority-ordered insert, one crossing per event"},
    {"pop", (PyCFunction)rq_pop, METH_NOARGS,
     "pop the highest-priority task (FIFO among equals), or None"},
    {"stats", (PyCFunction)rq_stats, METH_NOARGS,
     "(pushes, pops, max_len, len)"},
    {NULL, NULL, 0, NULL}};

static PySequenceMethods rq_as_sequence = {
    .sq_length = rq_length,
};

static PyTypeObject RQType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "parsec_tpu_torch_schedext.ReadyQueue",
    .tp_basicsize = sizeof(RQObject),
    .tp_dealloc = rq_dealloc,
    .tp_as_sequence = &rq_as_sequence,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = rq_methods,
    .tp_init = rq_init,
    .tp_new = rq_new,
};

/* ------------------------------------------------------------------ */
/* DepTable: the dep-countdown record store (engine.deliver_dep)      */
/* ------------------------------------------------------------------ */

/* One pending record, a private heap type so records live as dict
 * values.  Mirrors engine.PendingRecord. */
typedef struct {
    PyObject_HEAD
    int64_t expected, arrivals;
    PyObject *locals;    /* dict */
    PyObject *inputs;    /* dict or NULL (lazily created) */
    PyObject *sources;   /* dict or NULL */
} DepRec;

static void deprec_dealloc(PyObject *self_) {
    DepRec *r = (DepRec *)self_;
    Py_CLEAR(r->locals);
    Py_CLEAR(r->inputs);
    Py_CLEAR(r->sources);
    Py_TYPE(self_)->tp_free(self_);
}

static PyTypeObject DepRecType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "parsec_tpu_torch_schedext._DepRec",
    .tp_basicsize = sizeof(DepRec),
    .tp_dealloc = deprec_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = NULL,   /* internal only */
};

typedef struct {
    PyObject_HEAD
    PyObject *table;    /* dict: key -> DepRec */
} DTObject;

/* install a fresh countdown record (called once per successor, on the
 * first arrival's MISS).  A record that appeared since the caller's
 * miss is KEPT — two workers racing the first two arrivals of one
 * successor both observe the miss, and the second create must not
 * wipe the first's recorded arrival.  Shared by the Python-visible
 * create() and the in-C delivery walk of the extended chain. */
static int dtc_create(DTObject *t, PyObject *key, long long expected,
                      PyObject *locals) {
    PyObject *existing = PyDict_GetItemWithError(t->table, key);
    if (existing)
        return 0;
    if (PyErr_Occurred())
        return -1;
    DepRec *r = (DepRec *)DepRecType.tp_alloc(&DepRecType, 0);
    if (!r)
        return -1;
    r->expected = expected;
    r->arrivals = 0;
    Py_INCREF(locals);
    r->locals = locals;
    r->inputs = NULL;
    r->sources = NULL;
    int rc = PyDict_SetItem(t->table, key, (PyObject *)r);
    Py_DECREF(r);
    return rc < 0 ? -1 : 0;
}

static PyObject *dt_create(PyObject *self_, PyObject *const *args,
                           Py_ssize_t nargs) {
    DTObject *t = (DTObject *)self_;
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError, "create(key, expected, locals)");
        return NULL;
    }
    long long expected = PyLong_AsLongLong(args[1]);
    if (expected == -1 && PyErr_Occurred())
        return NULL;
    if (dtc_create(t, args[0], expected, args[2]) < 0)
        return NULL;
    Py_RETURN_NONE;
}

/* one arrival: 2 = ready (*out is the (locals, inputs_or_None,
 * sources_or_None) payload, record removed), 1 = not ready, 0 = miss
 * (caller create()s then re-arrives), -1 = error.  The JDF gather
 * rule is enforced here: a data flow receiving two copies raises
 * (range deps may only gather CTL). */
static int dtc_arrive(DTObject *t, PyObject *key, PyObject *flow,
                      PyObject *copy, PyObject *source, PyObject **out) {
    *out = NULL;
    PyObject *ent = PyDict_GetItemWithError(t->table, key);
    if (!ent)
        return PyErr_Occurred() ? -1 : 0;
    DepRec *r = (DepRec *)ent;
    r->arrivals++;
    /* record EVERY arrival's binding, None included — a CTL delivery
     * must land flow->None in task.data so prepare_input sees the
     * task-fed flow as bound (exact twin of the Python record path) */
    if (!r->inputs) {
        r->inputs = PyDict_New();
        if (!r->inputs)
            return -1;
    } else if (copy != Py_None) {
        PyObject *prev = PyDict_GetItemWithError(r->inputs, flow);
        if (!prev && PyErr_Occurred())
            return -1;
        if (prev && prev != Py_None) {
            /* ASCII only: PyErr_Format's format string must be */
            PyErr_Format(PyExc_RuntimeError,
                         "data flow %R received two copies - range "
                         "deps may only gather CTL", flow);
            return -1;
        }
    }
    {
        /* a gather's earlier real copy must survive a later None
         * arrival on the same flow (CTL range edges all carry None) */
        int has = PyDict_Contains(r->inputs, flow);
        if (has < 0)
            return -1;
        if (copy != Py_None || !has) {
            if (PyDict_SetItem(r->inputs, flow, copy) < 0)
                return -1;
        }
    }
    if (source != Py_None) {
        if (!r->sources) {
            r->sources = PyDict_New();
            if (!r->sources)
                return -1;
        }
        if (PyDict_SetItem(r->sources, flow, source) < 0)
            return -1;
    }
    if (r->arrivals < r->expected)
        return 1;
    /* ready transition: hand the record's contents to the caller and
     * drop the entry in the same crossing */
    PyObject *payload = PyTuple_New(3);
    if (!payload)
        return -1;
    Py_INCREF(r->locals);
    PyTuple_SET_ITEM(payload, 0, r->locals);
    PyObject *ins = r->inputs ? r->inputs : Py_None;
    Py_INCREF(ins);
    PyTuple_SET_ITEM(payload, 1, ins);
    PyObject *srcs = r->sources ? r->sources : Py_None;
    Py_INCREF(srcs);
    PyTuple_SET_ITEM(payload, 2, srcs);
    if (PyDict_DelItem(t->table, key) < 0) {
        Py_DECREF(payload);
        return -1;
    }
    *out = payload;
    return 2;
}

/* arrive(key, flow, copy, source) -> None (not ready), False (no
 * record: caller must create() then re-arrive), or the ready payload
 * (locals, inputs_or_None, sources_or_None) with the record removed. */
static PyObject *dt_arrive(PyObject *self_, PyObject *const *args,
                           Py_ssize_t nargs) {
    DTObject *t = (DTObject *)self_;
    if (nargs != 4) {
        PyErr_SetString(PyExc_TypeError,
                        "arrive(key, flow, copy, source)");
        return NULL;
    }
    PyObject *payload = NULL;
    switch (dtc_arrive(t, args[0], args[1], args[2], args[3],
                       &payload)) {
    case 2:
        return payload;
    case 1:
        Py_RETURN_NONE;
    case 0:
        Py_RETURN_FALSE;   /* miss: caller create()s, then re-arrives */
    default:
        return NULL;
    }
}

static Py_ssize_t dt_length(PyObject *self_) {
    return PyDict_Size(((DTObject *)self_)->table);
}

static void dt_dealloc(PyObject *self_) {
    Py_CLEAR(((DTObject *)self_)->table);
    Py_TYPE(self_)->tp_free(self_);
}

static PyObject *dt_new(PyTypeObject *type, PyObject *args,
                        PyObject *kwds) {
    (void)args;
    (void)kwds;
    DTObject *t = (DTObject *)type->tp_alloc(type, 0);
    if (t) {
        t->table = PyDict_New();
        if (!t->table) {
            Py_DECREF(t);
            return NULL;
        }
    }
    return (PyObject *)t;
}

static PyMethodDef dt_methods[] = {
    {"create", (PyCFunction)(void (*)(void))dt_create, METH_FASTCALL,
     "create(key, expected, locals): install a countdown record"},
    {"arrive", (PyCFunction)(void (*)(void))dt_arrive, METH_FASTCALL,
     "arrive(key, flow, copy, source) -> None | False | "
     "(locals, inputs, sources)"},
    {NULL, NULL, 0, NULL}};

static PySequenceMethods dt_as_sequence = {
    .sq_length = dt_length,
};

static PyTypeObject DTType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "parsec_tpu_torch_schedext.DepTable",
    .tp_basicsize = sizeof(DTObject),
    .tp_dealloc = dt_dealloc,
    .tp_as_sequence = &dt_as_sequence,
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_methods = dt_methods,
    .tp_new = dt_new,
};

/* ------------------------------------------------------------------ */
/* TaskCore: the C task object (reference: parsec_task_t as a plain   */
/* C struct).  Field-for-field twin of core/task.py Task's slots so   */
/* every Python consumer (engine, devices, profilers, recovery) works */
/* unchanged by attribute access; construction and the trivial        */
/* progress chain below never enter bytecode.                         */
/* ------------------------------------------------------------------ */

#include <structmember.h>

/* TaskStatus values (core/task.py TaskStatus IntEnum; asserted at
 * vtable construction on the Python side so drift cannot go silent) */
#define ST_PENDING 0
#define ST_PREPARED 2
#define ST_RUNNING 3
#define ST_COMPLETE 4

typedef struct {
    PyObject_HEAD
    PyObject *task_class, *taskpool, *locals, *key, *data;
    PyObject *input_sources, *pinned_flows, *device, *prof, *dtd;
    PyObject *ready_at, *mtr_t0, *retry_snap;
    PyObject *vt;          /* TaskVT or NULL (reads as None) */
    long long priority, seq, pool_epoch;
    int status, chore_mask, retries;
} TCObject;

typedef struct {
    PyObject_HEAD
    PyObject *task_class, *taskpool;
    PyObject *name;         /* tc.name (the key head) */
    PyObject *param_names;  /* tuple of str, make_key order */
    PyObject *flow_names;   /* tuple of str, every flow */
    PyObject *priority_fn;  /* callable or None */
    PyObject *key_fn;       /* callable or None */
    PyObject *hook;         /* the single cpu hook, or None */
    int trivial;
    /* extended (non-trivial) chain: the per-class binding tables
     * computed by TaskClass.native_vt (reference: the generated
     * data_lookup / iterate_successors tables of parsec_task_class_t).
     * prep:   ((flow_name, ((guard|None, kind, payload), ...)), ...)
     *         per in-flow; kind 0=NULL 1=FROMDESC(ref_fn) 2=NEW(arena)
     *         3=FROMTASK(dep) 4=BAIL (statically ineligible dep)
     * noin:   (flow_name, ...) flows with no input deps (bind None)
     * outs:   ((flow_name, flow_index, access,
     *           ((guard|None, kind, payload), ...)), ...) per out-flow;
     *         kind 10=TOTASK(payload=(end, succ_tc, succ_flow,
     *         succ_write)) 11=BAIL (ToDesc / reshape / missing class)
     * wflows: (flow_name, ...) write-access flows (version bumps) */
    PyObject *prep, *noin, *outs, *wflows;
    int cchain;
} VTObject;

/* hard cap on per-class flow tables the extended chain will take (the
 * plan below keeps per-flow state on the stack); native_vt enforces
 * the same bound so cchain never arrives oversized */
#define MAX_CFLOWS 16

/* ------------------------------------------------------------------ */
/* bailout observability: every fast-path refusal is counted by       */
/* reason (process-global, GIL-serialized), scraped via               */
/* bailout_stats() into the metrics family                            */
/* parsec_sched_native_bailouts_total{reason} and the bench JSON —    */
/* a silently-degraded C chain is visible without an A/B run.         */
/* ------------------------------------------------------------------ */

enum {
    BR_NON_TRIVIAL = 0,   /* class shape the C chain does not cover   */
    BR_COMM_BUFFERED,     /* a successor lives on another rank        */
    BR_LINEAGE,           /* recovery lineage / minimal-replay filter */
    BR_CANCELLED,         /* cancelled pool (Python discard path)     */
    BR_FAULT_ARMED,       /* fault-injection plan armed               */
    BR_RETRY,             /* retry budget armed / task already retried*/
    BR_CHORE,             /* incarnation disabled or chore-masked     */
    BR_POOL,              /* pool/context feature (grapher/ici/dyn)   */
    BR_NREASONS
};

static const char *const bail_names[BR_NREASONS] = {
    "non_trivial", "comm_buffered", "lineage", "cancelled",
    "fault_armed", "retry", "chore", "pool"};

static uint64_t g_bail[BR_NREASONS];

/* interned attribute names for the progress chain (module init) */
static PyObject *s_pins_map, *s_running_task, *s_nb_tasks_done,
    *s_td_acc, *s_cancelled, *s_lineage, *s_context, *s_comm,
    *s_run_epoch, *s_termdet, *s_addto, *s_chore_disabled,
    *s_select, *s_exec_begin, *s_exec_end, *s_complete_exec,
    *s_task_discard;

/* extended-chain interned names (module init) */
static PyObject *s_data_attr, *s_device_attr, *s_complete_write,
    *s_repo, *s_lookup_entry, *s_addto_usage, *s_copies, *s_on_retire,
    *s_arena_attr, *s_retain_copy, *s_get_copy, *s_arenas, *s_flags,
    *s_resolve, *s_copy_on, *s_multiplicity, *s_instances,
    *s_affinity, *s_rank_of, *s_param_names_attr, *s_complete_locals,
    *s_native_deps, *s_vt_attr, *s_native_vt, *s_nb_task_inputs,
    *s_deliver_dep, *s_ring_doorbell, *s_record_error, *s_rank,
    *s_ready_stamp, *s_retry_max, *s_grapher, *s_ici,
    *s_replay_filter, *s_priority_attr;

/* lazily-bound runtime objects (cached after first use; importing an
 * already-loaded module is a sys.modules dict hit) */
static PyObject *g_seq_iter;      /* core.task._task_seq (itertools.count) */
static PyObject *g_fi_dict;       /* utils.faultinject module __dict__ */
static PyObject *g_body_failed;   /* scheduling._native_body_failed */
static PyObject *g_hook_return;   /* scheduling._native_hook_return */
static PyObject *g_one, *g_neg1;  /* cached small ints (module init) */
static PyObject *g_zero;          /* cached small int (module init) */
/* extended-chain runtime twins (core.engine / utils.output) */
static PyObject *g_engine_deliver;   /* engine.deliver_dep (fallback) */
static PyObject *g_engine_retire;    /* engine._make_retire */
static PyObject *g_engine_cow;       /* engine._cow_copy */
static PyObject *g_engine_consume;   /* engine.consume_inputs */
static PyObject *g_engine_stage;     /* engine.stage_in_host */
static PyObject *g_warning;          /* utils.output.warning */
static PyObject *g_null_fwd_fmt;     /* NULL-forward warning format */
static long long g_flag_scratch;     /* data.data.FLAG_SCRATCH */

static int ensure_runtime(void) {
    if (g_body_failed)
        return 0;
    PyObject *m = PyImport_ImportModule("parsec_tpu_torch.core.task");
    if (!m)
        return -1;
    g_seq_iter = PyObject_GetAttrString(m, "_task_seq");
    Py_DECREF(m);
    if (!g_seq_iter)
        return -1;
    m = PyImport_ImportModule("parsec_tpu_torch.utils.faultinject");
    if (!m)
        return -1;
    g_fi_dict = PyModule_GetDict(m);   /* borrowed, module is cached */
    Py_INCREF(g_fi_dict);
    Py_DECREF(m);
    m = PyImport_ImportModule("parsec_tpu_torch.core.scheduling");
    if (!m)
        return -1;
    g_hook_return = PyObject_GetAttrString(m, "_native_hook_return");
    g_body_failed = PyObject_GetAttrString(m, "_native_body_failed");
    Py_DECREF(m);
    if (!g_hook_return || !g_body_failed) {
        Py_CLEAR(g_body_failed);
        Py_CLEAR(g_hook_return);
        return -1;
    }
    m = PyImport_ImportModule("parsec_tpu_torch.core.engine");
    if (!m)
        goto fail;
    g_engine_deliver = PyObject_GetAttrString(m, "deliver_dep");
    g_engine_retire = PyObject_GetAttrString(m, "_make_retire");
    g_engine_cow = PyObject_GetAttrString(m, "_cow_copy");
    g_engine_consume = PyObject_GetAttrString(m, "consume_inputs");
    g_engine_stage = PyObject_GetAttrString(m, "stage_in_host");
    Py_DECREF(m);
    if (!g_engine_deliver || !g_engine_retire || !g_engine_cow ||
        !g_engine_consume || !g_engine_stage)
        goto fail;
    m = PyImport_ImportModule("parsec_tpu_torch.utils.output");
    if (!m)
        goto fail;
    g_warning = PyObject_GetAttrString(m, "warning");
    Py_DECREF(m);
    if (!g_warning)
        goto fail;
    m = PyImport_ImportModule("parsec_tpu_torch.data.data");
    if (!m)
        goto fail;
    {
        PyObject *fs = PyObject_GetAttrString(m, "FLAG_SCRATCH");
        Py_DECREF(m);
        if (!fs)
            goto fail;
        g_flag_scratch = PyLong_AsLongLong(fs);
        Py_DECREF(fs);
        if (g_flag_scratch == -1 && PyErr_Occurred())
            goto fail;
    }
    return 0;
fail:
    Py_CLEAR(g_body_failed);
    Py_CLEAR(g_hook_return);
    Py_CLEAR(g_engine_deliver);
    Py_CLEAR(g_engine_retire);
    Py_CLEAR(g_engine_cow);
    Py_CLEAR(g_engine_consume);
    Py_CLEAR(g_engine_stage);
    Py_CLEAR(g_warning);
    return -1;
}

/* -- TaskCore type -------------------------------------------------- */

static PyMemberDef tc_members[] = {
    {"task_class", T_OBJECT, offsetof(TCObject, task_class), 0, NULL},
    {"taskpool", T_OBJECT, offsetof(TCObject, taskpool), 0, NULL},
    {"locals", T_OBJECT, offsetof(TCObject, locals), 0, NULL},
    {"key", T_OBJECT, offsetof(TCObject, key), 0, NULL},
    {"data", T_OBJECT, offsetof(TCObject, data), 0, NULL},
    {"input_sources", T_OBJECT, offsetof(TCObject, input_sources), 0, NULL},
    {"pinned_flows", T_OBJECT, offsetof(TCObject, pinned_flows), 0, NULL},
    {"device", T_OBJECT, offsetof(TCObject, device), 0, NULL},
    {"prof", T_OBJECT, offsetof(TCObject, prof), 0, NULL},
    {"dtd", T_OBJECT, offsetof(TCObject, dtd), 0, NULL},
    {"ready_at", T_OBJECT, offsetof(TCObject, ready_at), 0, NULL},
    {"mtr_t0", T_OBJECT, offsetof(TCObject, mtr_t0), 0, NULL},
    {"retry_snap", T_OBJECT, offsetof(TCObject, retry_snap), 0, NULL},
    {"vt", T_OBJECT, offsetof(TCObject, vt), READONLY, NULL},
    {"priority", T_LONGLONG, offsetof(TCObject, priority), 0, NULL},
    {"seq", T_LONGLONG, offsetof(TCObject, seq), 0, NULL},
    {"pool_epoch", T_LONGLONG, offsetof(TCObject, pool_epoch), 0, NULL},
    {"status", T_INT, offsetof(TCObject, status), 0, NULL},
    {"chore_mask", T_INT, offsetof(TCObject, chore_mask), 0, NULL},
    {"retries", T_INT, offsetof(TCObject, retries), 0, NULL},
    {NULL, 0, 0, 0, NULL}};

static int tc_traverse(PyObject *self_, visitproc visit, void *arg) {
    TCObject *t = (TCObject *)self_;
    Py_VISIT(t->task_class);
    Py_VISIT(t->taskpool);
    Py_VISIT(t->locals);
    Py_VISIT(t->key);
    Py_VISIT(t->data);
    Py_VISIT(t->input_sources);
    Py_VISIT(t->pinned_flows);
    Py_VISIT(t->device);
    Py_VISIT(t->prof);
    Py_VISIT(t->dtd);
    Py_VISIT(t->ready_at);
    Py_VISIT(t->mtr_t0);
    Py_VISIT(t->retry_snap);
    Py_VISIT(t->vt);
    return 0;
}

static int tc_clear(PyObject *self_) {
    TCObject *t = (TCObject *)self_;
    Py_CLEAR(t->task_class);
    Py_CLEAR(t->taskpool);
    Py_CLEAR(t->locals);
    Py_CLEAR(t->key);
    Py_CLEAR(t->data);
    Py_CLEAR(t->input_sources);
    Py_CLEAR(t->pinned_flows);
    Py_CLEAR(t->device);
    Py_CLEAR(t->prof);
    Py_CLEAR(t->dtd);
    Py_CLEAR(t->ready_at);
    Py_CLEAR(t->mtr_t0);
    Py_CLEAR(t->retry_snap);
    Py_CLEAR(t->vt);
    return 0;
}

static void tc_dealloc(PyObject *self_) {
    PyObject_GC_UnTrack(self_);
    tc_clear(self_);
    Py_TYPE(self_)->tp_free(self_);
}

/* repr matches core/task.py Task: "Name(k=1,m=2)" */
static PyObject *tc_repr(PyObject *self_) {
    TCObject *t = (TCObject *)self_;
    PyObject *name = t->task_class
        ? PyObject_GetAttrString(t->task_class, "name") : NULL;
    if (!name) {
        PyErr_Clear();
        name = PyUnicode_FromString("?");
        if (!name)
            return NULL;
    }
    PyObject *parts = PyList_New(0);
    if (!parts) {
        Py_DECREF(name);
        return NULL;
    }
    if (t->locals && PyDict_Check(t->locals)) {
        PyObject *k, *v;
        Py_ssize_t pos = 0;
        while (PyDict_Next(t->locals, &pos, &k, &v)) {
            PyObject *s = PyUnicode_FromFormat("%U=%S", k, v);
            if (!s || PyList_Append(parts, s) < 0) {
                Py_XDECREF(s);
                Py_DECREF(parts);
                Py_DECREF(name);
                return NULL;
            }
            Py_DECREF(s);
        }
    }
    PyObject *sep = PyUnicode_FromString(",");
    PyObject *args = sep ? PyUnicode_Join(sep, parts) : NULL;
    Py_XDECREF(sep);
    Py_DECREF(parts);
    if (!args) {
        Py_DECREF(name);
        return NULL;
    }
    PyObject *out = PyUnicode_FromFormat("%U(%U)", name, args);
    Py_DECREF(name);
    Py_DECREF(args);
    return out;
}

static PyTypeObject TCType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "parsec_tpu_torch_schedext.TaskCore",
    .tp_basicsize = sizeof(TCObject),
    .tp_dealloc = tc_dealloc,
    .tp_repr = tc_repr,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = tc_traverse,
    .tp_clear = tc_clear,
    .tp_members = tc_members,
    .tp_new = NULL,   /* construct via TaskVT.build_* only */
};

/* -- TaskVT: the per-task-class vtable ------------------------------ */

static int vt_traverse(PyObject *self_, visitproc visit, void *arg) {
    VTObject *v = (VTObject *)self_;
    Py_VISIT(v->task_class);
    Py_VISIT(v->taskpool);
    Py_VISIT(v->name);
    Py_VISIT(v->param_names);
    Py_VISIT(v->flow_names);
    Py_VISIT(v->priority_fn);
    Py_VISIT(v->key_fn);
    Py_VISIT(v->hook);
    Py_VISIT(v->prep);
    Py_VISIT(v->noin);
    Py_VISIT(v->outs);
    Py_VISIT(v->wflows);
    return 0;
}

static int vt_clear(PyObject *self_) {
    VTObject *v = (VTObject *)self_;
    Py_CLEAR(v->task_class);
    Py_CLEAR(v->taskpool);
    Py_CLEAR(v->name);
    Py_CLEAR(v->param_names);
    Py_CLEAR(v->flow_names);
    Py_CLEAR(v->priority_fn);
    Py_CLEAR(v->key_fn);
    Py_CLEAR(v->hook);
    Py_CLEAR(v->prep);
    Py_CLEAR(v->noin);
    Py_CLEAR(v->outs);
    Py_CLEAR(v->wflows);
    return 0;
}

static void vt_dealloc(PyObject *self_) {
    PyObject_GC_UnTrack(self_);
    vt_clear(self_);
    Py_TYPE(self_)->tp_free(self_);
}

static int vt_init(PyObject *self_, PyObject *args, PyObject *kwds) {
    (void)kwds;
    VTObject *v = (VTObject *)self_;
    PyObject *tc, *tp, *name, *pnames, *fnames, *prio, *keyfn, *hook;
    PyObject *prep, *noin, *outs, *wflows;
    int trivial, cchain;
    if (!PyArg_ParseTuple(args, "OOO!O!O!OOOpiO!O!O!O!", &tc, &tp,
                          &PyUnicode_Type, &name,
                          &PyTuple_Type, &pnames,
                          &PyTuple_Type, &fnames,
                          &prio, &keyfn, &hook, &trivial, &cchain,
                          &PyTuple_Type, &prep,
                          &PyTuple_Type, &noin,
                          &PyTuple_Type, &outs,
                          &PyTuple_Type, &wflows))
        return -1;
    Py_INCREF(tc);
    Py_XSETREF(v->task_class, tc);
    Py_INCREF(tp);
    Py_XSETREF(v->taskpool, tp);
    Py_INCREF(name);
    Py_XSETREF(v->name, name);
    Py_INCREF(pnames);
    Py_XSETREF(v->param_names, pnames);
    Py_INCREF(fnames);
    Py_XSETREF(v->flow_names, fnames);
    Py_INCREF(prio);
    Py_XSETREF(v->priority_fn, prio);
    Py_INCREF(keyfn);
    Py_XSETREF(v->key_fn, keyfn);
    Py_INCREF(hook);
    Py_XSETREF(v->hook, hook);
    Py_INCREF(prep);
    Py_XSETREF(v->prep, prep);
    Py_INCREF(noin);
    Py_XSETREF(v->noin, noin);
    Py_INCREF(outs);
    Py_XSETREF(v->outs, outs);
    Py_INCREF(wflows);
    Py_XSETREF(v->wflows, wflows);
    v->trivial = trivial && hook != Py_None;
    /* the extended chain keeps per-flow plan state on the stack: a
     * class wider than MAX_CFLOWS (native_vt enforces the same bound)
     * or without a single cpu hook falls back to Python */
    v->cchain = cchain && hook != Py_None && !v->trivial
        && PyTuple_GET_SIZE(prep) <= MAX_CFLOWS
        && PyTuple_GET_SIZE(noin) <= MAX_CFLOWS
        && PyTuple_GET_SIZE(outs) <= MAX_CFLOWS
        && PyTuple_GET_SIZE(wflows) <= MAX_CFLOWS;
    return 0;
}

static PyObject *vt_new(PyTypeObject *type, PyObject *args,
                        PyObject *kwds) {
    (void)args;
    (void)kwds;
    VTObject *v = (VTObject *)type->tp_alloc(type, 0);
    return (PyObject *)v;
}

static long long vt_attr_ll(PyObject *obj, const char *name,
                            long long dflt) {
    PyObject *a = PyObject_GetAttrString(obj, name);
    if (!a) {
        PyErr_Clear();
        return dflt;
    }
    long long r = PyLong_AsLongLong(a);
    Py_DECREF(a);
    if (r == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        return dflt;
    }
    return r;
}

/* make_key's twin: (name,) + params, or (name, key_fn(locals)) */
static PyObject *vt_key(VTObject *v, PyObject *locals) {
    if (v->key_fn != Py_None) {
        PyObject *k2 = PyObject_CallFunctionObjArgs(v->key_fn, locals,
                                                    NULL);
        if (!k2)
            return NULL;
        PyObject *key = PyTuple_Pack(2, v->name, k2);
        Py_DECREF(k2);
        return key;
    }
    Py_ssize_t np = PyTuple_GET_SIZE(v->param_names);
    PyObject *key = PyTuple_New(1 + np);
    if (!key)
        return NULL;
    Py_INCREF(v->name);
    PyTuple_SET_ITEM(key, 0, v->name);
    for (Py_ssize_t i = 0; i < np; i++) {
        PyObject *pv = PyDict_GetItemWithError(
            locals, PyTuple_GET_ITEM(v->param_names, i));
        if (!pv) {
            if (!PyErr_Occurred())
                PyErr_Format(PyExc_KeyError, "task param %R missing",
                             PyTuple_GET_ITEM(v->param_names, i));
            Py_DECREF(key);
            return NULL;
        }
        Py_INCREF(pv);
        PyTuple_SET_ITEM(key, 1 + i, pv);
    }
    return key;
}

/* one task: locals is ALIASED (the caller guarantees a fresh,
 * exclusively-owned dict — iter_space / the DepTable record both
 * produce one per instance) */
static PyObject *vt_build_task(VTObject *v, PyObject *locals,
                               long long epoch, long long pool_prio) {
    if (ensure_runtime() < 0)
        return NULL;
    TCObject *t = (TCObject *)TCType.tp_alloc(&TCType, 0);
    if (!t)
        return NULL;
    Py_INCREF(v->task_class);
    t->task_class = v->task_class;
    Py_INCREF(v->taskpool);
    t->taskpool = v->taskpool;
    Py_INCREF(locals);
    t->locals = locals;
    Py_INCREF((PyObject *)v);
    t->vt = (PyObject *)v;
    t->status = ST_PENDING;
    t->chore_mask = 0xFFFF;
    t->retries = 0;
    t->pool_epoch = epoch;
    t->priority = pool_prio;
    t->key = vt_key(v, locals);
    if (!t->key)
        goto fail;
    if (v->priority_fn != Py_None) {
        PyObject *p = PyObject_CallFunctionObjArgs(v->priority_fn,
                                                   locals, NULL);
        if (!p)
            goto fail;
        long long cp = PyLong_AsLongLong(p);
        Py_DECREF(p);
        if (cp == -1 && PyErr_Occurred())
            goto fail;
        t->priority += cp;
    }
    {
        /* itertools.count: the ONE process-global task sequence,
         * shared with Python Task.__init__ */
        PyObject *seq = PyIter_Next(g_seq_iter);
        if (!seq)
            goto fail;
        t->seq = PyLong_AsLongLong(seq);
        Py_DECREF(seq);
    }
    t->data = PyDict_New();
    t->input_sources = PyDict_New();
    t->pinned_flows = PySet_New(NULL);
    if (!t->data || !t->input_sources || !t->pinned_flows)
        goto fail;
    /* tp_alloc already GC-tracked the object (PyType_GenericAlloc) */
    return (PyObject *)t;
fail:
    Py_DECREF((PyObject *)t);
    return NULL;
}

/* build_batch(locals_seq) -> [TaskCore, ...]: one crossing for the
 * whole enumeration stream (Python Task.__init__ leaves the hot loop) */
static PyObject *vt_build_batch(PyObject *self_, PyObject *arg) {
    VTObject *v = (VTObject *)self_;
    PyObject *fast = PySequence_Fast(arg, "locals_seq must be a sequence");
    if (!fast)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(fast);
    long long epoch = vt_attr_ll(v->taskpool, "run_epoch", 0);
    long long prio = vt_attr_ll(v->taskpool, "priority", 0);
    PyObject *out = PyList_New(n);
    if (!out) {
        Py_DECREF(fast);
        return NULL;
    }
    PyObject **items = PySequence_Fast_ITEMS(fast);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = vt_build_task(v, items[i], epoch, prio);
        if (!t) {
            Py_DECREF(out);
            Py_DECREF(fast);
            return NULL;
        }
        PyList_SET_ITEM(out, i, t);
    }
    Py_DECREF(fast);
    return out;
}

/* build_range(name, start, stop, step) -> [TaskCore, ...]: the flat
 * single-parameter space fully enumerated AND constructed in C (the
 * independent-task shape: locals dicts, keys, tasks — zero bytecode
 * per instance) */
static PyObject *vt_build_range(PyObject *self_, PyObject *const *args,
                                Py_ssize_t nargs) {
    VTObject *v = (VTObject *)self_;
    if (nargs != 4) {
        PyErr_SetString(PyExc_TypeError,
                        "build_range(name, start, stop, step)");
        return NULL;
    }
    PyObject *name = args[0];
    long long start = PyLong_AsLongLong(args[1]);
    long long stop = PyLong_AsLongLong(args[2]);
    long long step = PyLong_AsLongLong(args[3]);
    if (PyErr_Occurred())
        return NULL;
    if (step == 0) {
        PyErr_SetString(PyExc_ValueError, "step must not be zero");
        return NULL;
    }
    long long count = 0;
    if (step > 0 && stop > start)
        count = (stop - start + step - 1) / step;
    else if (step < 0 && stop < start)
        count = (start - stop + (-step) - 1) / (-step);
    long long epoch = vt_attr_ll(v->taskpool, "run_epoch", 0);
    long long prio = vt_attr_ll(v->taskpool, "priority", 0);
    PyObject *out = PyList_New((Py_ssize_t)count);
    if (!out)
        return NULL;
    long long val = start;
    for (Py_ssize_t i = 0; i < (Py_ssize_t)count; i++, val += step) {
        PyObject *locals = PyDict_New();
        PyObject *pv = locals ? PyLong_FromLongLong(val) : NULL;
        if (!pv || PyDict_SetItem(locals, name, pv) < 0) {
            Py_XDECREF(pv);
            Py_XDECREF(locals);
            Py_DECREF(out);
            return NULL;
        }
        Py_DECREF(pv);
        PyObject *t = vt_build_task(v, locals, epoch, prio);
        Py_DECREF(locals);
        if (!t) {
            Py_DECREF(out);
            return NULL;
        }
        PyList_SET_ITEM(out, i, t);
    }
    return out;
}

/* build_one(locals) -> TaskCore (the deliver_dep readiness path) */
static PyObject *vt_build_one(PyObject *self_, PyObject *locals) {
    VTObject *v = (VTObject *)self_;
    if (!PyDict_Check(locals)) {
        PyErr_SetString(PyExc_TypeError, "locals must be a dict");
        return NULL;
    }
    return vt_build_task(v, locals,
                         vt_attr_ll(v->taskpool, "run_epoch", 0),
                         vt_attr_ll(v->taskpool, "priority", 0));
}

static PyMethodDef vt_methods[] = {
    {"build_batch", (PyCFunction)vt_build_batch, METH_O,
     "build_batch(locals_seq) -> [TaskCore]"},
    {"build_range", (PyCFunction)(void (*)(void))vt_build_range,
     METH_FASTCALL,
     "build_range(name, start, stop, step) -> [TaskCore] (flat space)"},
    {"build_one", (PyCFunction)vt_build_one, METH_O,
     "build_one(locals) -> TaskCore"},
    {NULL, NULL, 0, NULL}};

static PyMemberDef vt_members[] = {
    {"task_class", T_OBJECT, offsetof(VTObject, task_class), READONLY,
     NULL},
    {"taskpool", T_OBJECT, offsetof(VTObject, taskpool), READONLY, NULL},
    {"trivial", T_INT, offsetof(VTObject, trivial), READONLY, NULL},
    {"cchain", T_INT, offsetof(VTObject, cchain), READONLY, NULL},
    {NULL, 0, 0, 0, NULL}};

static PyTypeObject VTType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "parsec_tpu_torch_schedext.TaskVT",
    .tp_basicsize = sizeof(VTObject),
    .tp_dealloc = vt_dealloc,
    .tp_flags = Py_TPFLAGS_DEFAULT | Py_TPFLAGS_HAVE_GC,
    .tp_traverse = vt_traverse,
    .tp_clear = vt_clear,
    .tp_methods = vt_methods,
    .tp_members = vt_members,
    .tp_init = vt_init,
    .tp_new = vt_new,
};

/* ------------------------------------------------------------------ */
/* run_quantum: the worker inner loop in one crossing                  */
/* ------------------------------------------------------------------ */

/* dispatch one PINS event to a callback list (borrowed refs) */
static int pins_dispatch(PyObject *cbs, PyObject *es, PyObject *event,
                         PyObject *task) {
    if (!cbs || !PyList_Check(cbs))
        return 0;
    for (Py_ssize_t i = 0; i < PyList_GET_SIZE(cbs); i++) {
        PyObject *r = PyObject_CallFunctionObjArgs(
            PyList_GET_ITEM(cbs, i), es, event, task, NULL);
        if (!r)
            return -1;
        Py_DECREF(r);
    }
    return 0;
}

/* which chains the (pool, class) gates allow */
#define FL_TRIV 1   /* the trivial (no-flow) chain */
#define FL_EXT 2    /* the extended (data-carrying) chain */

/* per-quantum cached state (refreshed each run_quantum call) */
typedef struct {
    PyObject *es, *pins_map, *td_acc;
    PyObject *es_ctx;      /* OWNED: es.context (doorbell / rank / errors) */
    PyObject *cb_select, *cb_begin, *cb_end, *cb_complete, *cb_discard;
    PyObject *cb_deliver;  /* borrowed: deliver_dep PINS list */
    PyObject *last_tp;     /* OWNED: last gate-checked pool (a borrowed
                            * pointer could be freed mid-quantum and a
                            * new pool allocated at the same address
                            * would inherit stale gate results) */
    PyObject *last_vt;     /* OWNED: the gate cache is keyed on the
                            * (pool, class) PAIR — chore_disabled_mask
                            * is per CLASS, and one class's disable
                            * must not poison its pool siblings */
    int last_flags;        /* FL_* mask for (last_tp, last_vt) */
    int reason_triv;       /* BR_* why FL_TRIV is clear */
    int reason_ext;        /* BR_* why FL_EXT is clear */
    long long myrank;      /* ctx.rank for the cached pool */
    int fi_armed;
    int ready_stamp;       /* ctx._ready_stamp truth, read per quantum */
    /* complete_exec stride gates (__pins_stride__ on the callback,
     * read once per quantum): a callback advertising stride N is
     * SKIPPED unless es.nb_tasks_done % N == 0 — the metrics
     * handler's own unsampled early-return, without the call */
    long long cstride[8];
    Py_ssize_t n_complete;
} quantum_t;

/* interned-name attribute read as long long, default on absence */
static long long attr_ll(PyObject *obj, PyObject *name, long long dflt) {
    PyObject *a = PyObject_GetAttr(obj, name);
    if (!a) {
        PyErr_Clear();
        return dflt;
    }
    long long r = PyLong_AsLongLong(a);
    Py_DECREF(a);
    if (r == -1 && PyErr_Occurred()) {
        PyErr_Clear();
        return dflt;
    }
    return r;
}

/* raise an exception object (with its original traceback) */
static PyObject *fetch_exc(void) {
    PyObject *et, *ev, *tb;
    PyErr_Fetch(&et, &ev, &tb);
    PyErr_NormalizeException(&et, &ev, &tb);
    if (tb)
        PyException_SetTraceback(ev, tb);
    Py_XDECREF(et);
    Py_XDECREF(tb);
    return ev;   /* owned */
}

/* 1 if obj.name exists and is not None, 0 otherwise (missing = None) */
static int attr_not_none(PyObject *obj, PyObject *name) {
    PyObject *a = PyObject_GetAttr(obj, name);
    if (!a) {
        PyErr_Clear();
        return 0;
    }
    int r = (a != Py_None);
    Py_DECREF(a);
    return r;
}

/* (pool, class) fast-path gates: which chains may take this task.
 * Cached per (pool, class) pair for the quantum (a cancel landing
 * mid-quantum is observed at the next quantum — in-flight tasks
 * finish, exactly the documented cancellation contract).  NOTE the
 * comm-attached fast-complete: an attached RemoteDepEngine no longer
 * disqualifies — a trivial class has no out flows (flush_activations
 * is a strict no-op on its empty outbox) and the extended chain bails
 * at plan time on ANY remote successor, so a zero-remote-successor
 * task rides C even on a distributed run. */
static int gates_for(quantum_t *qs, TCObject *t, VTObject *vt) {
    PyObject *tp = t->taskpool;
    if (tp == qs->last_tp && (PyObject *)vt == qs->last_vt)
        return qs->last_flags;
    Py_INCREF(tp);
    Py_XSETREF(qs->last_tp, tp);
    Py_INCREF((PyObject *)vt);
    Py_XSETREF(qs->last_vt, (PyObject *)vt);
    qs->last_flags = 0;
    qs->myrank = 0;
    qs->reason_triv = qs->reason_ext = BR_POOL;
    PyObject *a = PyObject_GetAttr(tp, s_cancelled);
    if (!a)
        return -1;
    int truth = PyObject_IsTrue(a);
    Py_DECREF(a);
    if (truth < 0)
        return -1;
    if (truth) {
        qs->reason_triv = qs->reason_ext = BR_CANCELLED;
        return 0;
    }
    a = PyObject_GetAttr(tp, s_lineage);
    if (!a)
        return -1;
    int has = (a != Py_None);
    Py_DECREF(a);
    if (has) {
        /* recovery lineage records at complete: Python path */
        qs->reason_triv = qs->reason_ext = BR_LINEAGE;
        return 0;
    }
    a = PyObject_GetAttr(vt->task_class, s_chore_disabled);
    if (!a)
        return -1;
    long long dis = PyLong_AsLongLong(a);
    Py_DECREF(a);
    if (dis == -1 && PyErr_Occurred())
        return -1;
    if (dis) {
        qs->reason_triv = qs->reason_ext = BR_CHORE;
        return 0;
    }
    int flags = FL_TRIV | FL_EXT;
    PyObject *ctx = PyObject_GetAttr(tp, s_context);
    if (!ctx)
        return -1;
    if (ctx != Py_None) {
        qs->myrank = attr_ll(ctx, s_rank, 0);
        if (attr_ll(ctx, s_retry_max, 0) > 0) {
            /* write-flow snapshots before first execution: Python */
            flags &= ~FL_EXT;
            qs->reason_ext = BR_RETRY;
        }
        if ((flags & FL_EXT) && (attr_not_none(ctx, s_grapher) ||
                                 attr_not_none(ctx, s_ici))) {
            /* DAG grapher edges / ICI placement ride release_deps */
            flags &= ~FL_EXT;
            qs->reason_ext = BR_POOL;
        }
    }
    Py_DECREF(ctx);
    if ((flags & FL_EXT) && attr_not_none(tp, s_replay_filter)) {
        /* minimal-replay delivery filtering: Python walk */
        flags &= ~FL_EXT;
        qs->reason_ext = BR_LINEAGE;
    }
    qs->last_flags = flags;
    return flags;
}

/* ------------------------------------------------------------------ */
/* the extended chain: per-instance plan -> prepare -> delivery walk  */
/* (reference: generated data_lookup + iterate_successors +           */
/* release_deps, jdf2c.c:43,7175,7631 -> parsec.c:1783)               */
/* ------------------------------------------------------------------ */

/* binding-table kinds (mirrored by TaskClass.native_vt) */
#define CK_NULL 0        /* bind None (Null dep / no active dep) */
#define CK_FROMDESC 1    /* payload = ref_fn */
#define CK_NEW 2         /* payload = arena name */
#define CK_FROMTASK 3    /* payload = dep (unbound: mult==0 -> None) */
#define CK_BAIL 4        /* statically ineligible input dep */
#define CK_TOTASK 10     /* payload = (end, succ_tc, succ_flow, w) */
#define CK_OBAIL 11      /* statically ineligible output dep */

/* one planned local delivery */
typedef struct {
    PyObject *succ_tc;      /* borrowed from the vt table */
    PyObject *succ_locals;  /* OWNED completed-locals dict */
    PyObject *dflow;        /* borrowed successor flow name */
    int succ_write;         /* successor flow has WRITE access */
} cdeliv_t;

#define CPLAN_DSTACK 8

/* the per-instance execution plan, built BEFORE exec_begin so a bail
 * re-runs the whole chain in Python with every PINS event firing
 * exactly once */
typedef struct {
    struct {
        PyObject *name;      /* borrowed flow name */
        int kind;
        PyObject *payload;   /* borrowed from the vt table */
    } prep[MAX_CFLOWS];
    Py_ssize_t nprep;
    struct {
        PyObject *name;      /* borrowed flow name */
        Py_ssize_t findex;   /* flow_index into entry.copies */
        long long access;
        Py_ssize_t start, count;   /* span into deliv[] */
    } outs[MAX_CFLOWS];
    Py_ssize_t nouts;
    cdeliv_t dstack[CPLAN_DSTACK];
    cdeliv_t *deliv;
    Py_ssize_t ndeliv, dcap;
} cplan_t;

static void plan_init(cplan_t *p) {
    p->nprep = p->nouts = p->ndeliv = 0;
    p->deliv = p->dstack;
    p->dcap = CPLAN_DSTACK;
}

static void plan_free(cplan_t *p) {
    for (Py_ssize_t i = 0; i < p->ndeliv; i++)
        Py_DECREF(p->deliv[i].succ_locals);
    if (p->deliv != p->dstack)
        free(p->deliv);
    p->deliv = p->dstack;
    p->ndeliv = 0;
    p->dcap = CPLAN_DSTACK;
}

/* append one delivery; steals the succ_locals reference on success */
static int plan_push_deliv(cplan_t *p, PyObject *succ_tc,
                           PyObject *succ_locals, PyObject *dflow,
                           int succ_write) {
    if (p->ndeliv >= p->dcap) {
        Py_ssize_t ncap = p->dcap * 2;
        cdeliv_t *nd;
        if (p->deliv == p->dstack) {
            nd = (cdeliv_t *)malloc((size_t)ncap * sizeof(cdeliv_t));
            if (nd)
                memcpy(nd, p->dstack, sizeof(p->dstack));
        } else {
            nd = (cdeliv_t *)realloc(p->deliv,
                                     (size_t)ncap * sizeof(cdeliv_t));
        }
        if (!nd) {
            PyErr_NoMemory();
            return -1;
        }
        p->deliv = nd;
        p->dcap = ncap;
    }
    cdeliv_t *d = &p->deliv[p->ndeliv++];
    d->succ_tc = succ_tc;
    d->succ_locals = succ_locals;
    d->dflow = dflow;
    d->succ_write = succ_write;
    return 0;
}

/* complete_locals' twin: fill derived params (fast path: every param
 * already present -> alias the dict) */
static PyObject *c_complete_locals(PyObject *succ_tc, PyObject *locals) {
    PyObject *pn = PyObject_GetAttr(succ_tc, s_param_names_attr);
    if (pn && PyTuple_Check(pn) && PyDict_Check(locals)) {
        int all = 1;
        for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(pn); i++) {
            int has = PyDict_Contains(locals, PyTuple_GET_ITEM(pn, i));
            if (has < 0) {
                Py_DECREF(pn);
                return NULL;
            }
            if (!has) {
                all = 0;
                break;
            }
        }
        Py_DECREF(pn);
        if (all) {
            Py_INCREF(locals);
            return locals;
        }
    } else {
        Py_XDECREF(pn);
        PyErr_Clear();
    }
    return PyObject_CallMethodObjArgs(succ_tc, s_complete_locals,
                                      locals, NULL);
}

/* evaluate a dep guard against locals: 1 applies, 0 not, -1 error */
static int guard_applies(PyObject *guard, PyObject *locals) {
    if (guard == Py_None)
        return 1;
    PyObject *r = PyObject_CallFunctionObjArgs(guard, locals, NULL);
    if (!r)
        return -1;
    int truth = PyObject_IsTrue(r);
    Py_DECREF(r);
    return truth;
}

/* build the per-instance plan from the vt binding tables.  Returns
 * 0 = covered, 1 = bail to Python (*breason set; plan freed); plan
 * evaluation is read-only, so ANY exception (a guard raising, an
 * instance expression failing) clears and bails — the Python re-run
 * surfaces it at the same site with the correct containment. */
static int plan_build(quantum_t *qs, TCObject *t, VTObject *vt,
                      cplan_t *plan, int *breason) {
    Py_ssize_t np = PyTuple_GET_SIZE(vt->prep);
    Py_ssize_t no = PyTuple_GET_SIZE(vt->outs);
    plan_init(plan);
    *breason = BR_NON_TRIVIAL;
    /* in-flows: pick this instance's binding (guards are mutually
     * exclusive: the FIRST applying dep wins, active_input's contract) */
    for (Py_ssize_t i = 0; i < np; i++) {
        PyObject *ent = PyTuple_GET_ITEM(vt->prep, i);
        PyObject *name = PyTuple_GET_ITEM(ent, 0);
        int has = PyDict_Contains(t->data, name);
        if (has < 0)
            goto excbail;
        if (has)
            continue;   /* task-fed, bound at delivery */
        PyObject *deps = PyTuple_GET_ITEM(ent, 1);
        int chosen = 0;
        for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(deps); j++) {
            PyObject *dent = PyTuple_GET_ITEM(deps, j);
            int ap = guard_applies(PyTuple_GET_ITEM(dent, 0), t->locals);
            if (ap < 0)
                goto excbail;
            if (!ap)
                continue;
            long kind = PyLong_AsLong(PyTuple_GET_ITEM(dent, 1));
            if (kind == -1 && PyErr_Occurred())
                goto excbail;
            if (kind == CK_BAIL)
                goto bail;
            plan->prep[plan->nprep].name = name;
            plan->prep[plan->nprep].kind = (int)kind;
            plan->prep[plan->nprep].payload = PyTuple_GET_ITEM(dent, 2);
            plan->nprep++;
            chosen = 1;
            break;
        }
        if (!chosen) {
            /* no active dep: bind None (prepare_input's dep-is-None) */
            plan->prep[plan->nprep].name = name;
            plan->prep[plan->nprep].kind = CK_NULL;
            plan->prep[plan->nprep].payload = NULL;
            plan->nprep++;
        }
    }
    /* out-flows: expand EVERY applying dep's instances (outputs are
     * not mutually exclusive); a remote successor bails the task to
     * Python, whose release_deps buffers the remote activation */
    for (Py_ssize_t i = 0; i < no; i++) {
        PyObject *ent = PyTuple_GET_ITEM(vt->outs, i);
        PyObject *name = PyTuple_GET_ITEM(ent, 0);
        Py_ssize_t start = plan->ndeliv;
        PyObject *deps = PyTuple_GET_ITEM(ent, 3);
        for (Py_ssize_t j = 0; j < PyTuple_GET_SIZE(deps); j++) {
            PyObject *dent = PyTuple_GET_ITEM(deps, j);
            int ap = guard_applies(PyTuple_GET_ITEM(dent, 0), t->locals);
            if (ap < 0)
                goto excbail;
            if (!ap)
                continue;
            long kind = PyLong_AsLong(PyTuple_GET_ITEM(dent, 1));
            if (kind == -1 && PyErr_Occurred())
                goto excbail;
            if (kind != CK_TOTASK)
                goto bail;
            PyObject *pl = PyTuple_GET_ITEM(dent, 2);
            PyObject *end = PyTuple_GET_ITEM(pl, 0);
            PyObject *succ_tc = PyTuple_GET_ITEM(pl, 1);
            PyObject *dflow = PyTuple_GET_ITEM(pl, 2);
            long sw = PyLong_AsLong(PyTuple_GET_ITEM(pl, 3));
            if (sw == -1 && PyErr_Occurred())
                goto excbail;
            PyObject *insts = PyObject_CallMethodObjArgs(
                end, s_instances, t->locals, NULL);
            if (!insts)
                goto excbail;
            PyObject *fast = PySequence_Fast(insts,
                                             "instances not a sequence");
            Py_DECREF(insts);
            if (!fast)
                goto excbail;
            Py_ssize_t ni = PySequence_Fast_GET_SIZE(fast);
            for (Py_ssize_t k = 0; k < ni; k++) {
                PyObject *cl = c_complete_locals(
                    succ_tc, PySequence_Fast_GET_ITEM(fast, k));
                if (!cl) {
                    Py_DECREF(fast);
                    goto excbail;
                }
                /* rank check (rank_of: affinity-owner placement) */
                long long rank = 0;
                if (attr_not_none(succ_tc, s_affinity)) {
                    PyObject *rk = PyObject_CallMethodObjArgs(
                        succ_tc, s_rank_of, cl, NULL);
                    if (!rk) {
                        Py_DECREF(cl);
                        Py_DECREF(fast);
                        goto excbail;
                    }
                    rank = PyLong_AsLongLong(rk);
                    Py_DECREF(rk);
                    if (rank == -1 && PyErr_Occurred()) {
                        Py_DECREF(cl);
                        Py_DECREF(fast);
                        goto excbail;
                    }
                }
                if (rank != qs->myrank) {
                    /* remote successor: Python buffers the activation */
                    Py_DECREF(cl);
                    Py_DECREF(fast);
                    *breason = BR_COMM_BUFFERED;
                    goto bail;
                }
                if (plan_push_deliv(plan, succ_tc, cl, dflow,
                                    (int)sw) < 0) {
                    Py_DECREF(cl);
                    Py_DECREF(fast);
                    goto excbail;
                }
            }
            Py_DECREF(fast);
        }
        long long findex = PyLong_AsLongLong(PyTuple_GET_ITEM(ent, 1));
        long long access = PyLong_AsLongLong(PyTuple_GET_ITEM(ent, 2));
        if (PyErr_Occurred())
            goto excbail;
        plan->outs[plan->nouts].name = name;
        plan->outs[plan->nouts].findex = (Py_ssize_t)findex;
        plan->outs[plan->nouts].access = access;
        plan->outs[plan->nouts].start = start;
        plan->outs[plan->nouts].count = plan->ndeliv - start;
        plan->nouts++;
    }
    return 0;
excbail:
    PyErr_Clear();
bail:
    plan_free(plan);
    return 1;
}

/* prepare_input's twin over the plan (exceptions left SET: the caller
 * routes them through _native_body_failed, task_progress's except
 * branch).  ASCII-only format strings (PyErr_Format requirement). */
static int c_prepare(TCObject *t, VTObject *vt, cplan_t *plan) {
    PyObject *noin = vt->noin;
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(noin); i++) {
        PyObject *name = PyTuple_GET_ITEM(noin, i);
        int has = PyDict_Contains(t->data, name);
        if (has < 0)
            return -1;
        if (!has && PyDict_SetItem(t->data, name, Py_None) < 0)
            return -1;
    }
    for (Py_ssize_t i = 0; i < plan->nprep; i++) {
        PyObject *name = plan->prep[i].name;
        PyObject *payload = plan->prep[i].payload;
        switch (plan->prep[i].kind) {
        case CK_NULL:
            if (PyDict_SetItem(t->data, name, Py_None) < 0)
                return -1;
            break;
        case CK_FROMDESC: {
            PyObject *ref = PyObject_CallFunctionObjArgs(payload,
                                                         t->locals, NULL);
            if (!ref)
                return -1;
            PyObject *datum = PyObject_CallMethodObjArgs(ref, s_resolve,
                                                         NULL);
            if (!datum) {
                Py_DECREF(ref);
                return -1;
            }
            PyObject *copy = PyObject_CallMethodObjArgs(datum, s_copy_on,
                                                        g_zero, NULL);
            Py_DECREF(datum);
            if (!copy) {
                Py_DECREF(ref);
                return -1;
            }
            if (copy == Py_None) {
                PyErr_Format(PyExc_RuntimeError,
                             "%S: no host copy for %S", t, ref);
                Py_DECREF(copy);
                Py_DECREF(ref);
                return -1;
            }
            Py_DECREF(ref);
            int rc = PyDict_SetItem(t->data, name, copy);
            Py_DECREF(copy);
            if (rc < 0)
                return -1;
            break;
        }
        case CK_NEW: {
            PyObject *arenas = PyObject_GetAttr(t->taskpool, s_arenas);
            if (!arenas)
                return -1;
            PyObject *arena = PyObject_GetItem(arenas, payload);
            Py_DECREF(arenas);
            if (!arena) {
                PyErr_Clear();
                PyErr_Format(PyExc_RuntimeError,
                             "%S: flow %U needs arena %R but the "
                             "taskpool has none", t, name, payload);
                return -1;
            }
            PyObject *copy = PyObject_CallMethodObjArgs(arena, s_get_copy,
                                                        NULL);
            Py_DECREF(arena);
            if (!copy)
                return -1;
            /* copy.flags |= FLAG_SCRATCH (np.empty scratch: nothing
             * may read it before the first write) */
            long long fl = attr_ll(copy, s_flags, 0);
            PyObject *nf = PyLong_FromLongLong(fl | g_flag_scratch);
            if (!nf) {
                Py_DECREF(copy);
                return -1;
            }
            int rc = PyObject_SetAttr(copy, s_flags, nf);
            Py_DECREF(nf);
            if (rc < 0 || PyDict_SetItem(t->data, name, copy) < 0) {
                Py_DECREF(copy);
                return -1;
            }
            Py_DECREF(copy);
            break;
        }
        case CK_FROMTASK: {
            PyObject *mult = PyObject_CallMethodObjArgs(
                payload, s_multiplicity, t->locals, NULL);
            if (!mult)
                return -1;
            long long m = PyLong_AsLongLong(mult);
            Py_DECREF(mult);
            if (m == -1 && PyErr_Occurred())
                return -1;
            if (m == 0) {
                /* empty JDF range at a boundary: no edge, no data */
                if (PyDict_SetItem(t->data, name, Py_None) < 0)
                    return -1;
                break;
            }
            PyErr_Format(PyExc_RuntimeError,
                         "%S: task-fed flow %U reached prepare_input "
                         "unbound - activation protocol error", t, name);
            return -1;
        }
        default:
            PyErr_SetString(PyExc_RuntimeError,
                            "corrupt native binding plan");
            return -1;
        }
    }
    return 0;
}

/* complete_execution's containment: record the pending exception on
 * the context and continue (-1 only if record_error itself failed) */
static int contained_record(quantum_t *qs, PyObject *task) {
    PyObject *exc = fetch_exc();
    if (!exc) {
        Py_INCREF(Py_None);
        exc = Py_None;
    }
    PyObject *ctx = qs->es_ctx ? qs->es_ctx : Py_None;
    PyObject *r = PyObject_CallMethodObjArgs(ctx, s_record_error, exc,
                                             task, NULL);
    Py_DECREF(exc);
    if (!r)
        return -1;
    Py_DECREF(r);
    return 0;
}

/* deliver_dep's twin for one planned local delivery: returns the
 * newly-ready task (new ref), Py_None (not ready yet), or NULL on
 * error.  Falls back to engine.deliver_dep BEFORE any arrive() when
 * the successor has no native dep table or vtable, so the arrival is
 * never double-counted. */
static PyObject *c_deliver(quantum_t *qs, PyObject *tp, cdeliv_t *d,
                           PyObject *dcopy, PyObject *src) {
    PyObject *nd = PyObject_GetAttr(tp, s_native_deps);
    PyObject *svt;
    if (!nd)
        return NULL;
    if (Py_TYPE(nd) != &DTType)
        goto fallback;
    svt = PyObject_GetAttr(d->succ_tc, s_vt_attr);
    if (!svt)
        PyErr_Clear();
    if (!svt || Py_TYPE(svt) != &VTType) {
        /* unresolved (False sentinel) or off: resolve via native_vt() */
        Py_XDECREF(svt);
        svt = PyObject_CallMethodObjArgs(d->succ_tc, s_native_vt, NULL);
        if (!svt) {
            Py_DECREF(nd);
            return NULL;
        }
        if (Py_TYPE(svt) != &VTType) {
            Py_DECREF(svt);
            goto fallback;
        }
    }
    {
        VTObject *sv = (VTObject *)svt;
        PyObject *payload = NULL;
        PyObject *locals_, *inputs, *sources, *newt;
        TCObject *nt;
        int st;
        PyObject *key = vt_key(sv, d->succ_locals);
        if (!key)
            goto fail;
        st = dtc_arrive((DTObject *)nd, key, d->dflow, dcopy, src,
                        &payload);
        if (st == 0) {
            /* first arrival: install the countdown record, re-arrive */
            PyObject *exp = PyObject_CallMethodObjArgs(
                d->succ_tc, s_nb_task_inputs, d->succ_locals, NULL);
            if (!exp) {
                Py_DECREF(key);
                goto fail;
            }
            long long expected = PyLong_AsLongLong(exp);
            Py_DECREF(exp);
            if (expected == -1 && PyErr_Occurred()) {
                Py_DECREF(key);
                goto fail;
            }
            PyObject *lc = PyDict_Copy(d->succ_locals);
            if (!lc) {
                Py_DECREF(key);
                goto fail;
            }
            int rc = dtc_create((DTObject *)nd, key, expected, lc);
            Py_DECREF(lc);
            if (rc < 0) {
                Py_DECREF(key);
                goto fail;
            }
            st = dtc_arrive((DTObject *)nd, key, d->dflow, dcopy, src,
                            &payload);
        }
        Py_DECREF(key);
        if (st < 0)
            goto fail;
        if (st == 1) {
            Py_DECREF(svt);
            Py_DECREF(nd);
            Py_RETURN_NONE;
        }
        /* ready: build the successor task (locals ALIASED — the
         * record's dict is exclusively owned, build_one's contract) */
        locals_ = PyTuple_GET_ITEM(payload, 0);
        inputs = PyTuple_GET_ITEM(payload, 1);
        sources = PyTuple_GET_ITEM(payload, 2);
        newt = vt_build_task(sv, locals_,
                             attr_ll(tp, s_run_epoch, 0),
                             attr_ll(tp, s_priority_attr, 0));
        if (!newt) {
            Py_DECREF(payload);
            goto fail;
        }
        nt = (TCObject *)newt;
        if (inputs != Py_None) {
            if (PyDict_Update(nt->data, inputs) < 0)
                goto newfail;
            PyObject *k, *val;
            Py_ssize_t pos = 0;
            while (PyDict_Next(inputs, &pos, &k, &val)) {
                if (val != Py_None &&
                    PySet_Add(nt->pinned_flows, k) < 0)
                    goto newfail;
            }
        }
        if (sources != Py_None &&
            PyDict_Update(nt->input_sources, sources) < 0)
            goto newfail;
        Py_DECREF(payload);
        Py_DECREF(svt);
        Py_DECREF(nd);
        return newt;
    newfail:
        Py_DECREF(newt);
        Py_DECREF(payload);
    fail:
        Py_DECREF(svt);
        Py_DECREF(nd);
        return NULL;
    }
fallback:
    Py_DECREF(nd);
    return PyObject_CallFunctionObjArgs(g_engine_deliver, tp,
                                        d->succ_tc, d->succ_locals,
                                        d->dflow, dcopy, src, NULL);
}

/* release_deps' local-only core over the plan, plus schedule(): write-
 * flow version bumps, per-delivery COW / repo holds / countdown
 * arrivals, heap insert of newly-ready tasks, doorbell.  Remote
 * successors / reshape / grapher / ICI / dynamic_release are
 * structurally absent — the plan or the gates bailed those shapes to
 * Python.  -1 with exception set; the caller contains. */
static int c_release_walk(quantum_t *qs, RQObject *q, TCObject *t,
                          VTObject *vt, cplan_t *plan) {
    /* write-flow version bumps: copy.data.complete_write(copy.device) */
    PyObject *wf = vt->wflows;
    for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(wf); i++) {
        PyObject *copy = PyDict_GetItemWithError(
            t->data, PyTuple_GET_ITEM(wf, i));
        if (!copy) {
            if (PyErr_Occurred())
                return -1;
            continue;
        }
        if (copy == Py_None)
            continue;
        PyObject *datum = PyObject_GetAttr(copy, s_data_attr);
        if (!datum)
            return -1;
        if (datum == Py_None) {
            Py_DECREF(datum);
            continue;
        }
        PyObject *dev = PyObject_GetAttr(copy, s_device_attr);
        if (!dev) {
            Py_DECREF(datum);
            return -1;
        }
        PyObject *r = PyObject_CallMethodObjArgs(datum, s_complete_write,
                                                 dev, NULL);
        Py_DECREF(datum);
        Py_DECREF(dev);
        if (!r)
            return -1;
        Py_DECREF(r);
    }
    PyObject *entry = NULL;   /* lazily-created repo entry (owned) */
    PyObject *repo = NULL;
    long long consumers = 0;
    PyObject *ready = PyList_New(0);
    if (!ready)
        return -1;
    for (Py_ssize_t fi = 0; fi < plan->nouts; fi++) {
        PyObject *name = plan->outs[fi].name;
        Py_ssize_t start = plan->outs[fi].start;
        Py_ssize_t count = plan->outs[fi].count;
        PyObject *copy = PyDict_GetItemWithError(t->data, name);
        if (!copy) {
            if (PyErr_Occurred())
                goto fail;
            copy = Py_None;
        }
        int real = (copy != Py_None);
        if (!real && count > 0 && plan->outs[fi].access != 0) {
            /* NULL forwarded on a data flow: legal but almost always a
             * graph bug (ptgpp forward_NULL golden behavior) */
            PyObject *cnt = PyLong_FromSsize_t(count);
            if (!cnt)
                goto fail;
            PyObject *r = PyObject_CallFunctionObjArgs(
                g_warning, g_null_fwd_fmt, (PyObject *)t, name, cnt,
                NULL);
            Py_DECREF(cnt);
            if (!r)
                goto fail;
            Py_DECREF(r);
        }
        for (Py_ssize_t di = start; di < start + count; di++) {
            cdeliv_t *d = &plan->deliv[di];
            PyObject *dcopy = copy;          /* borrowed unless COW */
            PyObject *owned_dcopy = NULL;
            if (real && count > 1 && d->succ_write) {
                /* fan-out onto a WRITE consumer: hand a copy-on-write
                 * duplicate or its in-place update races the readers */
                owned_dcopy = PyObject_CallFunctionObjArgs(g_engine_cow,
                                                           copy, NULL);
                if (!owned_dcopy)
                    goto fail;
                dcopy = owned_dcopy;
            }
            if (real && !entry) {
                repo = PyObject_GetAttr(t->task_class, s_repo);
                if (!repo) {
                    Py_XDECREF(owned_dcopy);
                    goto fail;
                }
                entry = PyObject_CallMethodObjArgs(repo, s_lookup_entry,
                                                   t->key, NULL);
                if (!entry) {
                    Py_XDECREF(owned_dcopy);
                    goto fail;
                }
            }
            if (real) {
                /* repo hold: a NEW-flow copy chained through several
                 * tasks lives in every producer's entry, and only the
                 * LAST retirement returns it to the freelist */
                PyObject *copies = PyObject_GetAttr(entry, s_copies);
                if (!copies) {
                    Py_XDECREF(owned_dcopy);
                    goto fail;
                }
                if (!PyList_Check(copies) || plan->outs[fi].findex < 0 ||
                    plan->outs[fi].findex >= PyList_GET_SIZE(copies)) {
                    PyErr_SetString(PyExc_RuntimeError,
                                    "repo entry copies list malformed");
                    Py_DECREF(copies);
                    Py_XDECREF(owned_dcopy);
                    goto fail;
                }
                PyObject *cur = PyList_GET_ITEM(copies,
                                                plan->outs[fi].findex);
                if (cur != copy) {
                    PyObject *arena = PyObject_GetAttr(copy,
                                                       s_arena_attr);
                    if (!arena) {
                        Py_DECREF(copies);
                        Py_XDECREF(owned_dcopy);
                        goto fail;
                    }
                    if (arena != Py_None) {
                        PyObject *r = PyObject_CallMethodObjArgs(
                            arena, s_retain_copy, copy, NULL);
                        if (!r) {
                            Py_DECREF(arena);
                            Py_DECREF(copies);
                            Py_XDECREF(owned_dcopy);
                            goto fail;
                        }
                        Py_DECREF(r);
                    }
                    Py_DECREF(arena);
                }
                Py_INCREF(copy);
                if (PyList_SetItem(copies, plan->outs[fi].findex,
                                   copy) < 0) {
                    Py_DECREF(copies);
                    Py_XDECREF(owned_dcopy);
                    goto fail;
                }
                Py_DECREF(copies);
                consumers++;
            }
            PyObject *src;
            if (real) {
                src = PyTuple_Pack(2, t->task_class, t->key);
                if (!src) {
                    Py_XDECREF(owned_dcopy);
                    goto fail;
                }
            } else {
                src = Py_None;
                Py_INCREF(src);
            }
            if (qs->cb_deliver && PyList_Check(qs->cb_deliver) &&
                PyList_GET_SIZE(qs->cb_deliver) > 0) {
                PyObject *pl = PyTuple_Pack(4, (PyObject *)t,
                                            d->succ_tc, d->succ_locals,
                                            d->dflow);
                int pr = pl ? pins_dispatch(qs->cb_deliver, qs->es,
                                            s_deliver_dep, pl) : -1;
                Py_XDECREF(pl);
                if (pr < 0) {
                    Py_DECREF(src);
                    Py_XDECREF(owned_dcopy);
                    goto fail;
                }
            }
            PyObject *newt = c_deliver(qs, t->taskpool, d, dcopy,
                                       real ? src : Py_None);
            Py_DECREF(src);
            Py_XDECREF(owned_dcopy);
            if (!newt)
                goto fail;
            if (newt != Py_None && PyList_Append(ready, newt) < 0) {
                Py_DECREF(newt);
                goto fail;
            }
            Py_DECREF(newt);
        }
    }
    if (entry) {
        PyObject *ret_fn = PyObject_CallFunctionObjArgs(
            g_engine_retire, (PyObject *)t, NULL);
        if (!ret_fn)
            goto fail;
        int rc = PyObject_SetAttr(entry, s_on_retire, ret_fn);
        Py_DECREF(ret_fn);
        if (rc < 0)
            goto fail;
        PyObject *climit = PyLong_FromLongLong(consumers);
        if (!climit)
            goto fail;
        PyObject *r = PyObject_CallMethodObjArgs(repo, s_addto_usage,
                                                 t->key, climit, NULL);
        Py_DECREF(climit);
        if (!r)
            goto fail;
        Py_DECREF(r);
    }
    /* schedule(es, ready): the native push + doorbell, in C */
    {
        Py_ssize_t nready = PyList_GET_SIZE(ready);
        if (nready > 0) {
            double now = qs->ready_stamp ? now_monotonic() : 0.0;
            for (Py_ssize_t i = 0; i < nready; i++) {
                if (rq_push_one(q, PyList_GET_ITEM(ready, i),
                                qs->ready_stamp, 0, now) < 0)
                    goto fail;
            }
            if (qs->es_ctx && qs->es_ctx != Py_None) {
                PyObject *n = PyLong_FromSsize_t(nready);
                if (!n)
                    goto fail;
                PyObject *r = PyObject_CallMethodObjArgs(
                    qs->es_ctx, s_ring_doorbell, n, NULL);
                Py_DECREF(n);
                if (!r)
                    goto fail;
                Py_DECREF(r);
            }
        }
    }
    Py_XDECREF(entry);
    Py_XDECREF(repo);
    Py_DECREF(ready);
    return 0;
fail:
    Py_XDECREF(entry);
    Py_XDECREF(repo);
    Py_DECREF(ready);
    return -1;
}

/* complete_execution's dep half for the extended chain, with the
 * Python path's exact containment structure: {write bumps + release
 * walk + schedule} in one contained block, consume_inputs in its own */
static int c_complete_deps(quantum_t *qs, RQObject *q, TCObject *t,
                           VTObject *vt, cplan_t *plan) {
    if (c_release_walk(qs, q, t, vt, plan) < 0) {
        if (contained_record(qs, (PyObject *)t) < 0)
            return -1;
    }
    if (t->input_sources && PyDict_Size(t->input_sources) > 0) {
        PyObject *r = PyObject_CallFunctionObjArgs(
            g_engine_consume, (PyObject *)t, NULL);
        if (!r) {
            if (contained_record(qs, (PyObject *)t) < 0)
                return -1;
        } else {
            Py_DECREF(r);
        }
    }
    return 0;
}

/* the C progress chain: returns 1 handled, 0 fall back to the Python
 * task_progress (exactly one bailout counter bumped), -1 error.  Two
 * chains share the claim/fence/execute skeleton: FL_TRIV (no flows,
 * empty completion) and FL_EXT (binding-table classes: plan ->
 * prepare -> stage -> execute -> local release walk). */
static int fast_progress(quantum_t *qs, RQObject *q, PyObject *task) {
    if (Py_TYPE(task) != &TCType) {
        g_bail[BR_NON_TRIVIAL]++;
        return 0;
    }
    TCObject *t = (TCObject *)task;
    if (!t->vt || Py_TYPE(t->vt) != &VTType) {
        g_bail[BR_NON_TRIVIAL]++;
        return 0;
    }
    VTObject *vt = (VTObject *)t->vt;
    int want = vt->trivial ? FL_TRIV : (vt->cchain ? FL_EXT : 0);
    if (!want) {
        g_bail[BR_NON_TRIVIAL]++;
        return 0;
    }
    if (qs->fi_armed) {
        g_bail[BR_FAULT_ARMED]++;
        return 0;
    }
    if (!(t->chore_mask & 1)) {
        g_bail[BR_CHORE]++;
        return 0;
    }
    if (t->retries) {
        g_bail[BR_RETRY]++;
        return 0;
    }
    int g = gates_for(qs, t, vt);
    if (g < 0)
        return -1;
    if (!(g & want)) {
        g_bail[want == FL_TRIV ? qs->reason_triv : qs->reason_ext]++;
        return 0;
    }
    /* extended chain: build the whole plan BEFORE any side effect
     * (claim, PINS) — a bail here re-runs the task in Python with
     * every event firing exactly once */
    cplan_t plan;
    int have_plan = 0;
    if (want == FL_EXT) {
        int breason;
        if (plan_build(qs, t, vt, &plan, &breason)) {
            g_bail[breason]++;
            return 0;
        }
        have_plan = 1;
    }
    PyObject *es = qs->es;
    PyObject *ret = NULL;
    /* claim BEFORE the fence check (the recovery drain contract —
     * see task_progress's comment).  The claim also freezes the
     * fence: the drain waits on running_task, so run_epoch cannot
     * move between here and completion. */
    if (PyObject_SetAttr(es, s_running_task, task) < 0) {
        if (have_plan)
            plan_free(&plan);
        return -1;
    }
    /* the recovery fence reads run_epoch FRESH per task — a restart
     * bumping it mid-quantum must discard every later stale task */
    if (t->pool_epoch != attr_ll(t->taskpool, s_run_epoch, 0)) {
        /* stale generation: discard without executing or decrementing */
        t->status = ST_COMPLETE;
        if (pins_dispatch(qs->cb_discard, es, s_task_discard, task) < 0)
            goto err;
        goto done;
    }
    if (qs->cb_begin &&
        pins_dispatch(qs->cb_begin, es, s_exec_begin, task) < 0)
        goto err;
    if (t->status < ST_PREPARED) {
        if (want == FL_TRIV) {
            /* trivial prepare: every flow binds None (no input deps) */
            PyObject *fn = vt->flow_names;
            for (Py_ssize_t i = 0; i < PyTuple_GET_SIZE(fn); i++) {
                if (PyDict_SetItem(t->data, PyTuple_GET_ITEM(fn, i),
                                   Py_None) < 0)
                    goto err;
            }
        } else if (c_prepare(t, vt, &plan) < 0) {
            /* binding error: task_progress's except branch */
            goto bodyfail;
        }
        t->status = ST_PREPARED;
    }
    if (want == FL_EXT) {
        /* execute()'s host staging (a device-pinned input lands a
         * host mirror before the cpu body runs) */
        PyObject *r = PyObject_CallFunctionObjArgs(g_engine_stage,
                                                   task, NULL);
        if (!r)
            goto bodyfail;
        Py_DECREF(r);
    }
    t->status = ST_RUNNING;
    ret = PyObject_CallFunctionObjArgs(vt->hook, es, task, NULL);
    if (!ret) {
    bodyfail:
        /* body/binding raised: the Python twin of task_progress's
         * except branch (retry / record_error / complete failed) */
        {
            PyObject *exc = fetch_exc();
            if (!exc) {
                Py_INCREF(Py_None);
                exc = Py_None;
            }
            PyObject *r = PyObject_CallFunctionObjArgs(g_body_failed,
                                                       es, task, exc,
                                                       NULL);
            Py_DECREF(exc);
            if (!r)
                goto err;
            Py_DECREF(r);
            goto done;
        }
    }
    if (ret != Py_None) {
        /* AGAIN / ASYNC / DISABLE / values: the Python helper mirrors
         * execute()'s normalization + task_progress's dispatch */
        PyObject *r = PyObject_CallFunctionObjArgs(g_hook_return, es,
                                                   task, ret, NULL);
        Py_DECREF(ret);
        if (!r)
            goto err;
        Py_DECREF(r);
        goto done;
    }
    Py_DECREF(ret);
    if (qs->cb_end &&
        pins_dispatch(qs->cb_end, es, s_exec_end, task) < 0)
        goto err;
    if (want == FL_EXT) {
        /* complete_execution's dep half: write bumps + local release
         * walk + schedule + consume_inputs, Python-contained */
        if (c_complete_deps(qs, q, t, vt, &plan) < 0)
            goto err;
    }
    /* for a trivial class the dep half is structurally empty: no
     * writebacks, no release_deps, no repo holds */
    t->status = ST_COMPLETE;
    {
        long long nbv = attr_ll(es, s_nb_tasks_done, 0);
        PyObject *cbs = qs->cb_complete;
        if (cbs && PyList_Check(cbs)) {
            Py_ssize_t ncb = PyList_GET_SIZE(cbs);
            /* a list resized mid-quantum invalidates the cached
             * strides: dispatch everything (stride 1) */
            int gated = (ncb == qs->n_complete);
            for (Py_ssize_t i = 0; i < ncb; i++) {
                if (gated && qs->cstride[i] > 1 &&
                    (nbv % qs->cstride[i]) != 0)
                    continue;
                PyObject *r = PyObject_CallFunctionObjArgs(
                    PyList_GET_ITEM(cbs, i), es, s_complete_exec,
                    task, NULL);
                if (!r)
                    goto err;
                Py_DECREF(r);
            }
        }
        PyObject *nb2 = PyLong_FromLongLong(nbv + 1);
        if (!nb2)
            goto err;
        int rc = PyObject_SetAttr(es, s_nb_tasks_done, nb2);
        Py_DECREF(nb2);
        if (rc < 0)
            goto err;
    }
    /* batched termdet: bump the per-worker accumulator (flushed by
     * worker_loop at batch boundaries / idle); es._td_acc is None
     * when termdet_batch <= 1 — then pay the locked decrement here */
    if (qs->td_acc && qs->td_acc != Py_None) {
        PyObject *entry = PyDict_GetItemWithError(qs->td_acc,
                                                  t->taskpool);
        if (!entry && PyErr_Occurred())
            goto err;
        long long ep = t->pool_epoch;
        if (entry && PyList_Check(entry)
            && PyLong_AsLongLong(PyList_GET_ITEM(entry, 0)) == ep) {
            PyObject *n2 = PyNumber_Add(PyList_GET_ITEM(entry, 1),
                                        g_one);
            if (!n2)
                goto err;
            if (PyList_SetItem(entry, 1, n2) < 0)
                goto err;
        } else {
            PyObject *fresh = Py_BuildValue("[Li]", ep, 1);
            if (!fresh)
                goto err;
            int rc = PyDict_SetItem(qs->td_acc, t->taskpool, fresh);
            Py_DECREF(fresh);
            if (rc < 0)
                goto err;
        }
    } else {
        PyObject *td = PyObject_GetAttr(t->taskpool, s_termdet);
        if (!td)
            goto err;
        PyObject *r = PyObject_CallMethodObjArgs(
            td, s_addto, t->taskpool, g_neg1, NULL);
        Py_DECREF(td);
        if (!r)
            goto err;
        Py_DECREF(r);
    }
done:
    if (have_plan)
        plan_free(&plan);
    if (PyObject_SetAttr(qs->es, s_running_task, Py_None) < 0)
        return -1;
    return 1;
err:
    if (have_plan)
        plan_free(&plan);
    PyObject_SetAttr(qs->es, s_running_task, Py_None);
    return -1;
}

/* run_quantum(es, ready_queue, limit) -> (ndone, task_or_None):
 * pop + select-PINS + the whole prepare/execute/complete chain —
 * trivial AND binding-table (data-carrying) classes — for up to
 * ``limit`` tasks in ONE crossing.  A task the fast path cannot take
 * (uncovered class shape, cancelled pool, armed fault plan, recorded
 * lineage, remote successor on this instance) pops out with its
 * select event already fired, for the Python task_progress; each
 * bail bumps its reason counter (bailout_stats). */
static PyObject *mod_run_quantum(PyObject *mod, PyObject *const *args,
                                 Py_ssize_t nargs) {
    (void)mod;
    if (nargs != 3) {
        PyErr_SetString(PyExc_TypeError,
                        "run_quantum(es, ready_queue, limit)");
        return NULL;
    }
    if (Py_TYPE(args[1]) != &RQType) {
        PyErr_SetString(PyExc_TypeError, "second arg must be ReadyQueue");
        return NULL;
    }
    if (ensure_runtime() < 0)
        return NULL;
    RQObject *q = (RQObject *)args[1];
    long limit = PyLong_AsLong(args[2]);
    if (limit == -1 && PyErr_Occurred())
        return NULL;
    quantum_t qs;
    memset(&qs, 0, sizeof(qs));
    qs.es = args[0];
    qs.pins_map = PyObject_GetAttr(qs.es, s_pins_map);
    if (!qs.pins_map)
        return NULL;
    qs.td_acc = PyObject_GetAttr(qs.es, s_td_acc);
    if (!qs.td_acc) {
        PyErr_Clear();
        qs.td_acc = Py_None;
        Py_INCREF(Py_None);
    }
    /* es.context once per quantum: doorbell / record_error / the
     * ready-stamp switch all hang off it */
    qs.es_ctx = PyObject_GetAttr(qs.es, s_context);
    if (!qs.es_ctx) {
        PyErr_Clear();
        qs.es_ctx = Py_None;
        Py_INCREF(Py_None);
    }
    qs.ready_stamp = (qs.es_ctx != Py_None &&
                      attr_ll(qs.es_ctx, s_ready_stamp, 0) != 0);
    /* borrowed cb lists, refetched per quantum (pins_register mutates
     * the lists in place; new events land within one quantum bound) */
    qs.cb_select = PyDict_GetItemWithError(qs.pins_map, s_select);
    qs.cb_begin = PyDict_GetItemWithError(qs.pins_map, s_exec_begin);
    qs.cb_end = PyDict_GetItemWithError(qs.pins_map, s_exec_end);
    qs.cb_complete = PyDict_GetItemWithError(qs.pins_map,
                                             s_complete_exec);
    qs.cb_discard = PyDict_GetItemWithError(qs.pins_map, s_task_discard);
    qs.cb_deliver = PyDict_GetItemWithError(qs.pins_map, s_deliver_dep);
    {
        PyObject *armed = g_fi_dict
            ? PyDict_GetItemString(g_fi_dict, "ARMED") : NULL;
        qs.fi_armed = armed ? PyObject_IsTrue(armed) : 0;
    }
    /* read each complete_exec callback's advertised sampling stride
     * once per quantum (missing attribute = stride 1 = always call) */
    qs.n_complete = -1;   /* sentinel: gate disabled */
    if (qs.cb_complete && PyList_Check(qs.cb_complete) &&
        PyList_GET_SIZE(qs.cb_complete) <=
            (Py_ssize_t)(sizeof(qs.cstride) / sizeof(qs.cstride[0]))) {
        qs.n_complete = PyList_GET_SIZE(qs.cb_complete);
        for (Py_ssize_t i = 0; i < qs.n_complete; i++) {
            long long v = 1;
            PyObject *st = PyObject_GetAttrString(
                PyList_GET_ITEM(qs.cb_complete, i), "__pins_stride__");
            if (st) {
                v = PyLong_AsLongLong(st);
                Py_DECREF(st);
                if (v < 1) {
                    PyErr_Clear();
                    v = 1;
                }
            } else {
                PyErr_Clear();
            }
            qs.cstride[i] = v;
        }
    }
    long ndone = 0;
    PyObject *out_task = NULL;
    while (ndone < limit) {
        if (q->len == 0)
            break;
        PyObject *task = q->heap[0].task;   /* ownership moves here */
        q->len--;
        if (q->len > 0) {
            q->heap[0] = q->heap[q->len];
            rq_sift_down(q, 0);
        }
        q->pops++;
        if (qs.cb_select &&
            pins_dispatch(qs.cb_select, qs.es, s_select, task) < 0) {
            Py_DECREF(task);
            goto fail;
        }
        int rc = fast_progress(&qs, q, task);
        if (rc < 0) {
            Py_DECREF(task);
            goto fail;
        }
        if (rc == 0) {
            out_task = task;   /* Python task_progress takes it */
            break;
        }
        Py_DECREF(task);
        ndone++;
    }
    {
        PyObject *res = Py_BuildValue("(lO)", ndone,
                                      out_task ? out_task : Py_None);
        Py_XDECREF(out_task);
        Py_XDECREF(qs.last_tp);
        Py_XDECREF(qs.last_vt);
        Py_XDECREF(qs.es_ctx);
        Py_DECREF(qs.pins_map);
        Py_DECREF(qs.td_acc);
        return res;
    }
fail:
    Py_XDECREF(qs.last_tp);
    Py_XDECREF(qs.last_vt);
    Py_XDECREF(qs.es_ctx);
    Py_DECREF(qs.pins_map);
    Py_DECREF(qs.td_acc);
    return NULL;
}

/* bailout_stats() -> {reason: count}: cumulative fast-path bailouts
 * since module load (scraped by prof.metrics; deltas by bench.py) */
static PyObject *mod_bailout_stats(PyObject *self_, PyObject *noargs) {
    (void)self_;
    (void)noargs;
    PyObject *d = PyDict_New();
    if (!d)
        return NULL;
    for (int i = 0; i < BR_NREASONS; i++) {
        PyObject *v = PyLong_FromUnsignedLongLong(
            (unsigned long long)g_bail[i]);
        if (!v || PyDict_SetItemString(d, bail_names[i], v) < 0) {
            Py_XDECREF(v);
            Py_DECREF(d);
            return NULL;
        }
        Py_DECREF(v);
    }
    return d;
}

/* ------------------------------------------------------------------ */

static PyObject *mod_now(PyObject *self_, PyObject *noargs) {
    (void)self_;
    (void)noargs;
    return PyFloat_FromDouble(now_monotonic());
}

static PyMethodDef mod_methods[] = {
    {"now", mod_now, METH_NOARGS, "CLOCK_MONOTONIC seconds"},
    {"run_quantum", (PyCFunction)(void (*)(void))mod_run_quantum,
     METH_FASTCALL,
     "run_quantum(es, ready_queue, limit) -> (ndone, task_or_None)"},
    {"bailout_stats", mod_bailout_stats, METH_NOARGS,
     "cumulative fast-path bailout counts by reason"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef schedext_module = {
    PyModuleDef_HEAD_INIT, "parsec_tpu_torch_schedext",
    "native scheduler hot path: ready queue + dep countdown", -1,
    mod_methods, NULL, NULL, NULL, NULL};

PyMODINIT_FUNC PyInit_parsec_tpu_torch_schedext(void) {
    s_status = PyUnicode_InternFromString("status");
    s_ready_at = PyUnicode_InternFromString("ready_at");
    s_priority = PyUnicode_InternFromString("priority");
    s_pins_map = PyUnicode_InternFromString("_pins_map");
    s_running_task = PyUnicode_InternFromString("running_task");
    s_nb_tasks_done = PyUnicode_InternFromString("nb_tasks_done");
    s_td_acc = PyUnicode_InternFromString("_td_acc");
    s_cancelled = PyUnicode_InternFromString("cancelled");
    s_lineage = PyUnicode_InternFromString("_lineage");
    s_context = PyUnicode_InternFromString("context");
    s_comm = PyUnicode_InternFromString("comm");
    s_run_epoch = PyUnicode_InternFromString("run_epoch");
    s_termdet = PyUnicode_InternFromString("termdet");
    s_addto = PyUnicode_InternFromString("taskpool_addto_nb_tasks");
    s_chore_disabled = PyUnicode_InternFromString("chore_disabled_mask");
    s_select = PyUnicode_InternFromString("select");
    s_exec_begin = PyUnicode_InternFromString("exec_begin");
    s_exec_end = PyUnicode_InternFromString("exec_end");
    s_complete_exec = PyUnicode_InternFromString("complete_exec");
    s_task_discard = PyUnicode_InternFromString("task_discard");
    if (!s_status || !s_ready_at || !s_priority || !s_pins_map ||
        !s_running_task || !s_nb_tasks_done || !s_td_acc ||
        !s_cancelled || !s_lineage || !s_context || !s_comm ||
        !s_run_epoch || !s_termdet || !s_addto || !s_chore_disabled ||
        !s_select || !s_exec_begin || !s_exec_end || !s_complete_exec ||
        !s_task_discard)
        return NULL;
    s_data_attr = PyUnicode_InternFromString("data");
    s_device_attr = PyUnicode_InternFromString("device");
    s_complete_write = PyUnicode_InternFromString("complete_write");
    s_repo = PyUnicode_InternFromString("repo");
    s_lookup_entry = PyUnicode_InternFromString("lookup_entry_and_create");
    s_addto_usage = PyUnicode_InternFromString("entry_addto_usage_limit");
    s_copies = PyUnicode_InternFromString("copies");
    s_on_retire = PyUnicode_InternFromString("on_retire");
    s_arena_attr = PyUnicode_InternFromString("arena");
    s_retain_copy = PyUnicode_InternFromString("retain_copy");
    s_get_copy = PyUnicode_InternFromString("get_copy");
    s_arenas = PyUnicode_InternFromString("arenas");
    s_flags = PyUnicode_InternFromString("flags");
    s_resolve = PyUnicode_InternFromString("resolve");
    s_copy_on = PyUnicode_InternFromString("copy_on");
    s_multiplicity = PyUnicode_InternFromString("multiplicity");
    s_instances = PyUnicode_InternFromString("instances");
    s_affinity = PyUnicode_InternFromString("affinity");
    s_rank_of = PyUnicode_InternFromString("rank_of");
    s_param_names_attr = PyUnicode_InternFromString("_param_names");
    s_complete_locals = PyUnicode_InternFromString("complete_locals");
    s_native_deps = PyUnicode_InternFromString("_native_deps");
    s_vt_attr = PyUnicode_InternFromString("_vt");
    s_native_vt = PyUnicode_InternFromString("native_vt");
    s_nb_task_inputs = PyUnicode_InternFromString("nb_task_inputs");
    s_deliver_dep = PyUnicode_InternFromString("deliver_dep");
    s_ready_stamp = PyUnicode_InternFromString("_ready_stamp");
    s_ring_doorbell = PyUnicode_InternFromString("ring_doorbell");
    s_record_error = PyUnicode_InternFromString("record_error");
    s_rank = PyUnicode_InternFromString("rank");
    s_retry_max = PyUnicode_InternFromString("_retry_max");
    s_grapher = PyUnicode_InternFromString("grapher");
    s_ici = PyUnicode_InternFromString("ici");
    s_replay_filter = PyUnicode_InternFromString("_replay_filter");
    s_priority_attr = PyUnicode_InternFromString("priority");
    if (!s_data_attr || !s_device_attr || !s_complete_write || !s_repo ||
        !s_lookup_entry || !s_addto_usage || !s_copies || !s_on_retire ||
        !s_arena_attr || !s_retain_copy || !s_get_copy || !s_arenas ||
        !s_flags || !s_resolve || !s_copy_on || !s_multiplicity ||
        !s_instances || !s_affinity || !s_rank_of ||
        !s_param_names_attr || !s_complete_locals || !s_native_deps ||
        !s_vt_attr || !s_native_vt || !s_nb_task_inputs ||
        !s_deliver_dep || !s_ring_doorbell || !s_record_error ||
        !s_rank || !s_ready_stamp || !s_retry_max || !s_grapher ||
        !s_ici || !s_replay_filter || !s_priority_attr)
        return NULL;
    g_one = PyLong_FromLong(1L);
    g_neg1 = PyLong_FromLong(-1L);
    g_zero = PyLong_FromLong(0L);
    g_null_fwd_fmt = PyUnicode_FromString(
        "A NULL is forwarded from %s flow %s to %d successor(s)");
    if (!g_one || !g_neg1 || !g_zero || !g_null_fwd_fmt)
        return NULL;
    if (PyType_Ready(&RQType) < 0 || PyType_Ready(&DepRecType) < 0 ||
        PyType_Ready(&DTType) < 0 || PyType_Ready(&TCType) < 0 ||
        PyType_Ready(&VTType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&schedext_module);
    if (!m)
        return NULL;
    Py_INCREF(&RQType);
    if (PyModule_AddObject(m, "ReadyQueue", (PyObject *)&RQType) < 0) {
        Py_DECREF(&RQType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&DTType);
    if (PyModule_AddObject(m, "DepTable", (PyObject *)&DTType) < 0) {
        Py_DECREF(&DTType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&TCType);
    if (PyModule_AddObject(m, "TaskCore", (PyObject *)&TCType) < 0) {
        Py_DECREF(&TCType);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(&VTType);
    if (PyModule_AddObject(m, "TaskVT", (PyObject *)&VTType) < 0) {
        Py_DECREF(&VTType);
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
