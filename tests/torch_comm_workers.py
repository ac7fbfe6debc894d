"""Rank functions of the comm twins (tests/test_torch_comm_*.py).

Each function runs on every rank of a distributed run of either package:
``pkg`` "jax" builds it with ``parsec_tpu`` under that package's
launcher, "port" with ``parsec_tpu_torch`` under the port's (children on
``device="cpu"``).  The module imports neither package at top level, so
a spawned child loads only the package its launcher wired (the children
pickle these functions by module name).  Tiles come out as float32 numpy
arrays so the parent compares the two packages directly.
"""

import collections
import threading
import time

import numpy as np


def _pkg(pkg: str) -> str:
    return "parsec_tpu" if pkg == "jax" else "parsec_tpu_torch"


def _mod(pkg: str, name: str):
    import importlib
    return importlib.import_module(f"{_pkg(pkg)}.{name}")


def seed_of(name, m, n):
    """Deterministic across processes (str hash() is randomized)."""
    return (ord(name[0]) * 10007 + m * 101 + n) % (2**31)


def put(payload, arr):
    """Write float32 numpy ``arr`` into a tile payload of either package
    (numpy in the JAX package, a torch tensor in the port)."""
    if isinstance(payload, np.ndarray):
        payload[...] = np.asarray(arr).astype(payload.dtype)
    else:
        import torch
        payload.copy_(torch.from_numpy(np.ascontiguousarray(
            arr, np.float32)).to(payload.dtype))


def get(payload):
    if isinstance(payload, np.ndarray):
        return np.asarray(payload, np.float32)
    import torch
    return payload.detach().to("cpu", torch.float32).numpy()


def dtname(x) -> str:
    """The dtype's name as either package's payload spells it."""
    return str(getattr(x, "dtype", "")).replace("torch.", "")


def counter(ctx):
    done = collections.Counter()
    lock = threading.Lock()

    def count(es, event, task):
        with lock:
            done[task.task_class.name] += 1
    ctx.pins_register("complete_exec", count)
    return done


def proto(ctx):
    """The protocol counters a twin compares (transport-independent)."""
    st = ctx.comm.stats()
    return {k: st[k] for k in ("act_eager", "act_rdv", "act_inline",
                               "eager_bytes", "rdv_bytes")}


def termdet(ctx):
    """Safra balance after the run: every app message sent was received."""
    c = ctx.comm
    return {"sent": c._app_sent, "recv": c._app_recv}


def _local_tiles(M, pkg):
    return {f"{m},{n}": get(M.data_of(m, n).pull_to_host().payload)
            for m, n in M.local_tiles()}


# -- comm engine direct ------------------------------------------------------

def ce_echo(ctx, rank, nranks, pkg):
    TAG_USER = _mod(pkg, "comm.engine").TAG_USER
    got = []
    evt = threading.Event()

    def cb(src, payload):
        got.append((src, payload))
        evt.set()

    ce = ctx.comm.ce
    ce.tag_register(TAG_USER, cb)
    ce.barrier()
    ce.send_am(TAG_USER, (rank + 1) % nranks, {"hello": rank})
    if not evt.wait(30):
        raise TimeoutError("no AM received")
    ce.barrier()
    src, payload = got[0]
    assert src == (rank - 1) % nranks
    assert payload == {"hello": src}
    return {"transport": ce.TRANSPORT, "clock_peers": len(ce.clock_table())}


def ce_onesided(ctx, rank, nranks, pkg):
    """Registered regions, one-sided put and get (a torch tensor in the
    port, numpy in the JAX package)."""
    TAG_USER = _mod(pkg, "comm.engine").TAG_USER
    ce = ctx.comm.ce
    assert ce.CAP_ONESIDED and ce.CAP_MT
    if pkg == "jax":
        mine = np.zeros(8, np.float32)
        mk = lambda v: np.full(8, v, np.float32)   # noqa: E731
    else:
        import torch
        mine = torch.zeros(8)
        mk = lambda v: torch.full((8,), v)   # noqa: E731
    rid = ce.mem_register(mine)
    rids = [None] * nranks
    got_rids = threading.Event()

    def rid_cb(src, payload):
        rids[src] = payload
        if all(r is not None for r in rids):
            got_rids.set()

    ce.tag_register(TAG_USER, rid_cb)
    ce.barrier()
    for r in range(nranks):
        ce.send_am(TAG_USER, r, rid)
    assert got_rids.wait(30)
    right = (rank + 1) % nranks
    acked = threading.Event()
    errs = []
    ce.put(right, mk(10.0 + rank), rids[right],
           on_complete=lambda err=None: (errs.append(err) if err else None,
                                         acked.set()))
    assert acked.wait(30)
    assert not errs, errs
    ce.barrier()
    after_put = get(mine).tolist()
    left = (rank - 1) % nranks
    box = {}
    fetched = threading.Event()

    def on_data(arr):
        box["arr"] = arr
        fetched.set()

    ce.get(left, rids[left], on_data)
    assert fetched.wait(30)
    ce.barrier()
    ce.mem_unregister(rid)
    return {"after_put": after_put, "got": get(box["arr"]).tolist(),
            "got_type": type(box["arr"]).__module__.split(".")[0]}


# -- PTG chains and broadcasts ----------------------------------------------

def _vec(pkg, nranks, rank, mb, lm, name="V", dtype=None):
    VT = _mod(pkg, "data.matrix").VectorTwoDimCyclic
    kw = {} if dtype is None else {"dtype": dtype}
    return VT(mb=mb, lm=lm, nodes=nranks, myrank=rank, name=name, **kw)


def _chain_pool(pkg, V, NT, name="chain"):
    api = _mod(pkg, "dsl.ptg.api")
    p = api.PTG(name, NT=NT)
    p.task("S", k=api.Range(0, NT - 1)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("T", "RW",
              api.IN(api.DATA(lambda k, V=V: V(k)), when=lambda k: k == 0),
              api.IN(api.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              api.OUT(api.TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k, NT=NT: k < NT - 1),
              api.OUT(api.DATA(lambda k, V=V: V(k)))) \
        .body(lambda T: T + 1.0)
    return p.build()


def chain(ctx, rank, nranks, pkg, NT=8, mb=4, eager=None, fill=0.0):
    """S(k) on V(k)'s rank adds one and hands the tile on: tile k ends at
    fill + k + 1.  ``eager`` forces the rendezvous path when small."""
    if eager is not None:
        ctx.comm.eager = eager
    V = _vec(pkg, nranks, rank, mb, NT * mb)
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload,
            np.full(mb, fill if m == 0 else float(m), np.float32))
    done = counter(ctx)
    ctx.add_taskpool(_chain_pool(pkg, V, NT))
    ctx.wait(timeout=120)
    vals = {m: float(get(V.data_of(m).pull_to_host().payload)[0])
            for m, _ in V.local_tiles()}
    return {"vals": vals, "done": dict(done), "proto": proto(ctx),
            "termdet": termdet(ctx)}


def bcast(ctx, rank, nranks, pkg, topo):
    api = _mod(pkg, "dsl.ptg.api")
    _mod(pkg, "utils.mca").params.set("comm_coll_bcast", topo)
    ctx.comm.bcast = topo
    NT = nranks * 2
    V = _vec(pkg, nranks, rank, 4, NT * 4, "V")
    W = _vec(pkg, nranks, rank, 4, NT * 4, "W")
    for M in (V, W):
        for m, _ in M.local_tiles():
            put(M.data_of(m).copy_on(0).payload, np.zeros(4, np.float32))
    p = api.PTG("bcast", NT=NT)
    p.task("ROOT", z=api.Range(0, 0)) \
        .affinity(lambda V=V: V(0)) \
        .flow("T", "RW",
              api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.TASK("SINK", "T",
                               lambda NT=NT: [dict(i=i)
                                              for i in range(NT)]))) \
        .body(lambda T: T + 42.0)
    p.task("SINK", i=api.Range(0, NT - 1)) \
        .affinity(lambda i, W=W: W(i)) \
        .flow("T", "READ", api.IN(api.TASK("ROOT", "T", lambda: dict(z=0)))) \
        .flow("O", "RW", api.IN(api.DATA(lambda i, W=W: W(i))),
              api.OUT(api.DATA(lambda i, W=W: W(i)))) \
        .body(lambda T, O: {"O": O + T})
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    vals = {m: float(get(W.data_of(m).pull_to_host().payload)[0])
            for m, _ in W.local_tiles()}
    st = ctx.comm.stats()
    return {"vals": vals, "proto": proto(ctx),
            "msgs": st["msgs_sent"] > 0, "termdet": termdet(ctx)}


def small_msgs(ctx, rank, nranks, pkg, steps=240):
    """A long cross-rank chain of tiny payloads: every edge one small
    message through the funnelled comm loop (the JAX package's test drives
    it with DTD, which the port does not carry; a PTG chain whose tiles
    hop round-robin over the ranks is the same traffic).  Then one local
    copy thread-shifted onto the comm loop (memcpy_shift)."""
    V = _vec(pkg, nranks, rank, 2, 2 * steps)
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload, np.zeros(2, np.float32))
    ctx.add_taskpool(_chain_pool(pkg, V, steps, "stress"))
    ctx.wait(timeout=120)
    last = None
    if V.rank_of(steps - 1) == rank:
        last = float(get(V.data_of(steps - 1).pull_to_host().payload)[0])
    new_data = _mod(pkg, "data.data").new_data
    if pkg == "jax":
        src = new_data(np.full(4, 7.0, np.float32)).copy_on(0)
        dst = new_data(np.zeros(4, np.float32)).copy_on(0)
    else:
        import torch
        src = new_data(torch.full((4,), 7.0)).copy_on(0)
        dst = new_data(torch.zeros(4)).copy_on(0)
    ctx.comm.memcpy_shift(dst, src)
    deadline = time.monotonic() + 10
    while not np.allclose(get(dst.payload), 7.0):
        if time.monotonic() > deadline:
            raise TimeoutError("memcpy_shift never landed")
        time.sleep(0.01)
    return {"last": last, "proto": proto(ctx), "termdet": termdet(ctx)}


def hosts_chain(ctx, rank, nranks, pkg):
    TAG_USER = _mod(pkg, "comm.engine").TAG_USER
    assert ctx.comm.ce._hosts == ["127.0.0.1"] * nranks
    got = threading.Event()
    ce = ctx.comm.ce
    ce.tag_register(TAG_USER, lambda src, p: got.set())
    ce.barrier()
    ce.send_am(TAG_USER, (rank + 1) % nranks, "hi")
    assert got.wait(30)
    ce.barrier()
    return "ok"


# -- dense kernels across ranks ----------------------------------------------

def _matrix(pkg, name, mt, nt, mb, rank, nranks, P, dtype=None):
    TB = _mod(pkg, "data.matrix").TwoDimBlockCyclic
    kw = {} if dtype is None else {"dtype": dtype}
    return TB(mb=mb, nb=mb, lm=mt * mb, ln=nt * mb, name=name,
              nodes=nranks, myrank=rank, P=P, **kw)


def _fill(M, mb, gen):
    for m, n in M.local_tiles():
        put(M.data_of(m, n).copy_on(0).payload, gen(M.name, m, n))


def _randn(name, m, n, mb):
    rng = np.random.default_rng(seed_of(name, m, n))
    return rng.standard_normal((mb, mb)).astype(np.float32)


def full_matrix(name, rows, cols, mb):
    out = np.zeros((rows * mb, cols * mb), np.float32)
    for m in range(rows):
        for n in range(cols):
            out[m * mb:(m + 1) * mb, n * mb:(n + 1) * mb] = \
                _randn(name, m, n, mb)
    return out


def _storage(pkg, kind):
    if kind == "f32":
        return None
    if pkg == "jax":
        import ml_dtypes
        return ml_dtypes.bfloat16
    import torch
    return torch.bfloat16


def dist_gemm(ctx, rank, nranks, pkg, mt=4, mb=8, P=2, kind="f32",
              bodies="cpu"):
    """C += A @ B over a P-row grid; returns the local C tiles, the task
    counts and the protocol counters.  ``bodies`` "device" gives the
    GEMMs their device body (the device module; CPU-backed in the port's
    children), "cpu" the CPU body only."""
    gemm_taskpool = _mod(pkg, "apps.gemm").gemm_taskpool
    dt = _storage(pkg, kind)
    A = _matrix(pkg, "A", mt, mt, mb, rank, nranks, P, dt)
    B = _matrix(pkg, "B", mt, mt, mb, rank, nranks, P, dt)
    C = _matrix(pkg, "C", mt, mt, mb, rank, nranks, P)
    for M in (A, B, C):
        _fill(M, mb, lambda nm, m, n: _randn(nm, m, n, mb))
    done = counter(ctx)
    dev = "cpu" if bodies == "cpu" else ("tpu" if pkg == "jax" else "cuda")
    ctx.add_taskpool(gemm_taskpool(A, B, C, device=dev))
    ctx.wait(timeout=120)
    return {"tiles": _local_tiles(C, pkg), "done": dict(done),
            "proto": proto(ctx), "termdet": termdet(ctx)}


def dist_qr(ctx, rank, nranks, pkg, nt=4, mb=8, P=2, kind="f32",
            bodies="cpu"):
    qr_taskpool = _mod(pkg, "apps.qr").qr_taskpool
    dt = _storage(pkg, kind)
    A = _matrix(pkg, "Q", nt, nt, mb, rank, nranks, P, dt)
    _fill(A, mb, lambda nm, m, n: _randn(nm, m, n, mb))
    done = counter(ctx)
    dev = "cpu" if bodies == "cpu" else ("tpu" if pkg == "jax" else "cuda")
    ctx.add_taskpool(qr_taskpool(A, device=dev))
    ctx.wait(timeout=180)
    return {"tiles": _local_tiles(A, pkg), "done": dict(done),
            "proto": proto(ctx), "termdet": termdet(ctx)}


def spd(n, seed=28):
    B = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return (B @ B.T + n * np.eye(n)).astype(np.float32)


def dist_potrf(ctx, rank, nranks, pkg, nt=4, mb=16, P=2, kind="f32",
               bodies="device"):
    potrf_taskpool = _mod(pkg, "apps.potrf").potrf_taskpool
    dt = _storage(pkg, kind)
    a = spd(nt * mb)
    A = _matrix(pkg, "A", nt, nt, mb, rank, nranks, P, dt)
    _fill(A, mb, lambda nm, m, n: a[m * mb:(m + 1) * mb,
                                    n * mb:(n + 1) * mb])
    done = counter(ctx)
    dev = "cpu" if bodies == "cpu" else ("tpu" if pkg == "jax" else "cuda")
    tp = potrf_taskpool(A, device=dev)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=180)
    failed = tp.cholesky_check.failed() if pkg == "port" else False
    out = {"tiles": {k: v for k, v in _local_tiles(A, pkg).items()
                     if int(k.split(",")[0]) >= int(k.split(",")[1])},
           "done": dict(done), "proto": proto(ctx),
           "termdet": termdet(ctx), "failed": failed}
    if pkg == "port":
        ck = _mod(pkg, "apps.cuda_kernels")
        out["staged_in"] = sum(int(d.stats.bytes_in) for d in
                               ctx.device_registry.accelerators)
        out["k1_tiles"] = ck.gemm_tile_launches.value + \
            ck.gemm_tile_grouped_members.value
    return out


# -- remote reshape corpus ---------------------------------------------------

def remote_presend_reshape(ctx, rank, nranks, pkg):
    api = _mod(pkg, "dsl.ptg.api")
    Dtt = _mod(pkg, "data.reshape").Dtt
    NT = 4
    V = _vec(pkg, nranks, rank, 8, 8 * NT, "V")
    W = _vec(pkg, nranks, rank, 8, 8 * NT, "W")
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload, np.full(8, 1.5 + m, np.float32))
    for m, _ in W.local_tiles():
        put(W.data_of(m).copy_on(0).payload, np.zeros(8, np.float32))
    seen = {}
    bf16 = Dtt(dtype=_storage(pkg, "bf16"), name="bf16")
    p = api.PTG("rrs", NT=NT)
    p.task("P", k=api.Range(0, NT - 1)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("T", "READ",
              api.IN(api.DATA(lambda k, V=V: V(k))),
              api.OUT(api.TASK("C", "T", lambda k: dict(k=k)), dtt=bf16)) \
        .body(lambda: None)

    def c_body(T, O, k):
        seen[k] = dtname(T)
        return get(T) * 2.0 if pkg == "jax" else T.float() * 2.0
    p.task("C", k=api.Range(0, NT - 1)) \
        .affinity(lambda k, W=W, NT=NT: W((k + 1) % NT)) \
        .flow("T", "READ", api.IN(api.TASK("P", "T", lambda k: dict(k=k)))) \
        .flow("O", "RW",
              api.IN(api.DATA(lambda k, W=W, NT=NT: W((k + 1) % NT))),
              api.OUT(api.DATA(lambda k, W=W, NT=NT: W((k + 1) % NT)))) \
        .body(c_body)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    vals = {m: get(W.data_of(m).pull_to_host().payload).tolist()
            for m, _ in W.local_tiles()}
    return {"vals": vals, "seen": seen}


def _one_edge(pkg, nranks, rank, val):
    V = _vec(pkg, nranks, rank, 4, 4 * nranks)
    if rank == 0:
        put(V.data_of(0).copy_on(0).payload, np.full(4, val, np.float32))
    return V


def remote_consumer_reshape(ctx, rank, nranks, pkg):
    api = _mod(pkg, "dsl.ptg.api")
    Dtt = _mod(pkg, "data.reshape").Dtt
    V = _one_edge(pkg, nranks, rank, 3.0)
    seen = {}
    p = api.PTG("rcr")
    p.task("P").affinity(lambda V=V: V(0)) \
        .flow("X", "READ", api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.TASK("C", "X", lambda: dict()))) \
        .body(lambda: None)
    p.task("C").affinity(lambda V=V: V(1)) \
        .flow("X", "READ", api.IN(api.TASK("P", "X", lambda: dict()),
                                  dtt=Dtt(dtype=_storage(pkg, "bf16")))) \
        .body(lambda X: seen.update(dtype=dtname(X),
                                    val=float(get(X)[0])))
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    return seen


def remote_no_re_reshape(ctx, rank, nranks, pkg):
    api = _mod(pkg, "dsl.ptg.api")
    Dtt = _mod(pkg, "data.reshape").Dtt
    V = _one_edge(pkg, nranks, rank, 5.0)
    seen = {}
    p = api.PTG("rnr")
    p.task("P").affinity(lambda V=V: V(0)) \
        .flow("X", "READ", api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.TASK("C", "X", lambda: dict()),
                      dtt=Dtt(dtype=_storage(pkg, "bf16")))) \
        .body(lambda: None)
    p.task("C").affinity(lambda V=V: V(1)) \
        .flow("X", "READ", api.IN(api.TASK("P", "X", lambda: dict()),
                                  dtt=Dtt(dtype=_storage(pkg, "bf16")))) \
        .body(lambda X: seen.update(dtype=dtname(X),
                                    val=float(get(X)[0])))
    tp = p.build()
    ctx.add_taskpool(tp)
    ctx.wait(timeout=120)
    return {"seen": seen, "conv": tp.reshape.conversions}


def remote_new_flow_reshape(ctx, rank, nranks, pkg):
    api = _mod(pkg, "dsl.ptg.api")
    Dtt = _mod(pkg, "data.reshape").Dtt
    V = _vec(pkg, nranks, rank, 4, 4 * nranks)
    seen = {}
    p = api.PTG("rnew")
    if pkg == "jax":
        p.arena("scratch", (4,), np.float32)
    else:
        import torch
        p.arena("scratch", (4,), torch.float32)

    def produce(X):
        put(X, np.arange(4, dtype=np.float32) + 1.0)
    p.task("P").affinity(lambda V=V: V(0)) \
        .flow("X", "RW", api.IN(api.NEW("scratch")),
              api.OUT(api.TASK("C", "X", lambda: dict()))) \
        .body(produce)
    p.task("C").affinity(lambda V=V: V(1)) \
        .flow("X", "READ", api.IN(api.TASK("P", "X", lambda: dict()),
                                  dtt=Dtt(dtype=_storage(pkg, "bf16")))) \
        .body(lambda X: seen.update(dtype=dtname(X),
                                    vals=[float(v) for v in get(X)]))
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    return seen


def remote_multi_outs(ctx, rank, nranks, pkg, range_deps=False):
    """One predecessor flow shipped remotely in several wire types (the
    reshape corpus's remote_multiple_outs_same_pred_flow[_multiple_deps]
    cases)."""
    api = _mod(pkg, "dsl.ptg.api")
    Dtt = _mod(pkg, "data.reshape").Dtt
    V = _one_edge(pkg, nranks, rank, 8.0 if range_deps else 6.0)
    seen = {}
    p = api.PTG("rmo", N=2)
    if range_deps:
        second = api.OUT(api.TASK("CR", "X",
                                  lambda: [dict(i=i) for i in range(2)]),
                         dtt=Dtt(transform=lambda a: a + 1.0,
                                 inverse=lambda a: a - 1.0, name="p1"))
    else:
        second = api.OUT(api.TASK("CH", "X", lambda: dict()),
                         dtt=Dtt(transform=lambda a: a * 0.5,
                                 inverse=lambda a: a * 2.0, name="half"))
    p.task("P").affinity(lambda V=V: V(0)) \
        .flow("X", "READ", api.IN(api.DATA(lambda V=V: V(0))),
              api.OUT(api.TASK("CB", "X", lambda: dict()),
                      dtt=Dtt(dtype=_storage(pkg, "bf16"))),
              second) \
        .body(lambda: None)
    p.task("CB").affinity(lambda V=V: V(1)) \
        .flow("X", "READ", api.IN(api.TASK("P", "X", lambda: dict()))) \
        .body(lambda X: seen.update(b_dtype=dtname(X),
                                    b_val=float(get(X)[0])))
    if range_deps:
        def cr_body(X, i):
            seen[f"r{i}"] = float(get(X)[0])
        p.task("CR", i=api.Range(0, 1)).affinity(lambda i, V=V: V(1)) \
            .flow("X", "READ", api.IN(api.TASK("P", "X", lambda i: dict()))) \
            .body(cr_body)
    else:
        p.task("CH").affinity(lambda V=V: V(1)) \
            .flow("X", "READ", api.IN(api.TASK("P", "X", lambda: dict()))) \
            .body(lambda X: seen.update(h_dtype=dtname(X),
                                        h_val=float(get(X)[0])))
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    return seen


# -- dynamic pools and the user trigger across ranks -------------------------

def dynamic_chain(ctx, rank, nranks, pkg, N=9):
    """A dynamic pool (``%option dynamic``): only rank 0 seeds S(0); every
    S(k) is discovered at run time by its predecessor's release and runs
    where V(k) lives, so a rank can drain to zero while a discovery is in
    flight.  Each rank's pool holds until the pool-scoped Safra round
    proves every rank drained."""
    api = _mod(pkg, "dsl.ptg.api")
    V = _vec(pkg, nranks, rank, 4, 4 * N)
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload, np.zeros(4, np.float32))
    p = api.PTG("dynchain", N=N)
    p.dynamic = True
    tb = p.task("S", k=api.Range(0, N - 1)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("T", "RW",
              api.IN(api.DATA(lambda k, V=V: V(k)), when=lambda k: k == 0),
              api.IN(api.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              api.OUT(api.TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k, N=N: k < N - 1),
              api.OUT(api.DATA(lambda k, V=V: V(k)))) \
        .body(lambda T: T + 1.0)
    tp = p.build()
    tp.task_classes["S"].properties["startup_fn"] = \
        lambda g, myrank: [dict(k=0)] if myrank == 0 else []
    done = counter(ctx)
    ctx.add_taskpool(tp)
    ctx.wait(timeout=120)
    return {"vals": {m: float(get(V.data_of(m).pull_to_host().payload)[0])
                     for m, _ in V.local_tiles()},
            "done": dict(done), "termdet": termdet(ctx)}


def user_trigger(ctx, rank, nranks, pkg):
    """A pool on the user-trigger termdet on every rank: its local work
    drains, yet it stays alive until rank 0 declares termination, which
    the comm layer carries to every rank."""
    V = _vec(pkg, nranks, rank, 2, 2 * nranks * 3)
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload, np.zeros(2, np.float32))
    tp = _chain_pool(pkg, V, nranks * 3, "trig")
    tp.termdet_name = "user_trigger"
    ctx.add_taskpool(tp)
    ctx.start()
    deadline = time.monotonic() + 60
    while tp.nb_tasks > 0:
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: local drain")
        time.sleep(0.01)
    ctx.comm.ce.barrier()          # every rank ran its share
    alive = not tp.completed       # zero counters fired nothing
    ctx.comm.ce.barrier()
    if rank == 0:
        tp.termdet.trigger(tp)
    ctx.wait(timeout=60)
    return {"alive_before_trigger": alive, "completed": tp.completed,
            "vals": {m: float(get(V.data_of(m).pull_to_host().payload)[0])
                     for m, _ in V.local_tiles()}}


# -- cross-rank telemetry -----------------------------------------------------

def scrape(ctx, rank, nranks, pkg):
    """A chain, then rank 0 scrapes the cluster's metrics: its own
    samples plus the peer's, pulled over TAG_METRICS."""
    V = _vec(pkg, nranks, rank, 4, 24)
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload, np.zeros(4, np.float32))
    ctx.add_taskpool(_chain_pool(pkg, V, 6))
    ctx.wait(timeout=60)
    frames = ctx.comm.stats()["frames_sent"]
    if rank != 0:
        return {"frames": frames}
    text, ranks = _mod(pkg, "prof.metrics").cluster_exposition(
        ctx, timeout=5.0)
    return {"frames": frames, "ranks": ranks, "text": text}


def journal_pull(ctx, rank, nranks, pkg):
    """A chain, a journaled barrier, then rank 0 pulls every rank's
    journal over the control lane and merges them."""
    jr = _mod(pkg, "prof.journal")
    V = _vec(pkg, nranks, rank, 4, 24, name=f"J{rank}")
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload, np.zeros(4, np.float32))
    ctx.add_taskpool(_chain_pool(pkg, V, 6))
    ctx.wait(timeout=60)
    ctx.comm.ce.barrier(timeout=30)
    if rank != 0:
        return {"events": len(ctx.journal)}
    per_rank = jr.cluster_journals(ctx, timeout=5.0)
    merged = jr.merge_journals(dict(per_rank))
    return {"ranks": sorted(per_rank),
            "peer_kinds": sorted({e["e"] for e in merged
                                  if e["rank"] == 1})}


def traced_potrf(ctx, rank, nranks, pkg, outdir):
    """A 2-rank potrf under the task profiler and the causal tracer; the
    rank's trace file goes to ``outdir``."""
    import os
    prof = _mod(pkg, "prof.profiling").Profile(f"potrf-r{rank}")
    mod = _mod(pkg, "prof.pins").install_task_profiler(ctx, prof)
    tr = _mod(pkg, "prof.causal").install_causal_tracer(ctx, prof)
    n, mb = 64, 16
    a = spd(n, 3)
    A = _matrix(pkg, "A", n // mb, n // mb, mb, rank, nranks, 1)
    _fill(A, mb, lambda nm, m, k: a[m * mb:(m + 1) * mb,
                                    k * mb:(k + 1) * mb])
    ctx.add_taskpool(_mod(pkg, "apps.potrf").potrf_taskpool(A,
                                                           device="cpu"))
    ctx.wait(timeout=120)
    # the clock handshake runs through the same loop the workload used;
    # wait for one pong round before the header snapshot
    deadline = time.time() + 15
    while len(ctx.comm.ce.clock) < nranks - 1 and time.time() < deadline:
        time.sleep(0.05)
    mod.uninstall(ctx)
    tr.uninstall(ctx)
    return prof.dump(os.path.join(outdir, f"rank{rank}.ptt"))


# -- the parent side ---------------------------------------------------------

def run_port(fn, nranks, args=(), **kw):
    from parsec_tpu_torch.comm.launch import run_distributed
    return run_distributed(fn, nranks, args=("port",) + tuple(args),
                           device="cpu", **kw)


def run_jax(fn, nranks, args=(), **kw):
    from parsec_tpu.comm.launch import run_distributed
    return run_distributed(fn, nranks, args=("jax",) + tuple(args), **kw)


def run_both(fn, nranks, args=(), **kw):
    """The same rank function on both packages, one run after the other
    (side by side they would double the processes a test host runs at
    once, next to the other test files): (jax results, port results)."""
    return run_jax(fn, nranks, args, **kw), run_port(fn, nranks, args, **kw)


def merged(results, key="vals"):
    out = {}
    for r in results:
        out.update(r[key])
    return out
