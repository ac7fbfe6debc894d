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


# -- distributed DTD (twins of tests/test_dtd_distributed.py) -----------------
#
# Each case runs SPMD on every rank of one run; ``dtd_suite`` runs several
# cases one after the other in one context (a barrier between them), so a
# handful of spawns covers every case.  Bodies are written once for both
# packages: numpy in, numpy or a tile payload out.

def _dtd_pool(ctx, pkg, name="dtd"):
    tp = _mod(pkg, "dsl.dtd").DTDTaskpool(name)
    ctx.add_taskpool(tp)
    ctx.start()
    return tp


def _dev(pkg):
    """Each package's device incarnation name."""
    return "tpu" if pkg == "jax" else "cuda"


def _val(M, m):
    return get(M.data_of(m).pull_to_host().payload).tolist()


def _filled(pkg, nranks, rank, mb, lm, name, value):
    V = _vec(pkg, nranks, rank, mb, lm, name=name)
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload,
            np.full(mb, value(m) if callable(value) else value, np.float32))
    return V


def dtd_chain(ctx, rank, nranks, pkg, steps=13):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4, "V", 0.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    for i in range(steps):
        tp.insert_task(lambda T: T + 1.0, (t, d.INOUT),
                       (i % nranks, d.AFFINITY))
    tp.wait(timeout=60)
    ctx.wait(timeout=60)
    return {"V0": _val(V, 0)} if rank == 0 else {}


def dtd_war(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4 * nranks, "V", 7.0)
    R = _filled(pkg, nranks, rank, 4, 4 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg)
    src = tp.tile_of(V, 0)
    for r in range(nranks):
        tp.insert_task(lambda s, out: np.asarray(s).copy(),
                       (src, d.INPUT), (tp.tile_of(R, r), d.OUTPUT))
    tp.insert_task(lambda T: T * 0.0 + 100.0, (src, d.INOUT),
                   (nranks - 1, d.AFFINITY))
    tp.wait(timeout=60)
    ctx.wait(timeout=60)
    out = {"R": _val(R, rank)}
    if rank == 0:
        out["V0"] = _val(V, 0)
    return out


def dtd_broadcast(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 8, 8 * nranks, "V", 0.0)
    R = _filled(pkg, nranks, rank, 8, 8 * nranks, "R", 0.0)
    tp = _dtd_pool(ctx, pkg)
    root = tp.tile_of(V, 0)
    tp.insert_task(lambda T: np.asarray(T) + np.arange(8, dtype=np.float32),
                   (root, d.INOUT))
    for r in range(nranks):
        tp.insert_task(lambda s, out: np.asarray(s) * 2.0,
                       (root, d.INPUT), (tp.tile_of(R, r), d.OUTPUT))
    tp.wait(timeout=60)
    ctx.wait(timeout=60)
    return {"R": _val(R, rank)}


def dtd_reduce(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4 * nranks, "V", lambda m: m + 1.0)
    acc = _filled(pkg, nranks, rank, 4, 4, "acc", 0.0)
    tp = _dtd_pool(ctx, pkg)
    out = tp.tile_of(acc, 0)
    for m in range(nranks):
        tp.insert_task(lambda a, x: np.asarray(a) + np.asarray(x),
                       (out, d.INOUT), (tp.tile_of(V, m), d.INPUT))
    tp.wait(timeout=60)
    ctx.wait(timeout=60)
    return {"acc": _val(acc, 0)} if rank == 0 else {}


def dtd_allreduce(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4 * nranks, "V", lambda m: m + 1.0)
    S = _filled(pkg, nranks, rank, 4, 4 * nranks, "S", 0.0)
    tp = _dtd_pool(ctx, pkg)
    root = tp.tile_of(S, 0)
    for m in range(nranks):
        tp.insert_task(lambda a, x: np.asarray(a) + np.asarray(x),
                       (root, d.INOUT), (tp.tile_of(V, m), d.INPUT))
    for r in range(1, nranks):
        tp.insert_task(lambda s, out: np.asarray(s).copy(),
                       (root, d.INPUT), (tp.tile_of(S, r), d.OUTPUT))
    tp.wait(timeout=60)
    ctx.wait(timeout=60)
    return {"S": _val(S, rank)}


def dtd_affinity(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4 * nranks, "V", 0.0)
    tp = _dtd_pool(ctx, pkg)
    ran_here = []
    local = []
    for m in range(nranks):
        t = tp.insert_task(lambda T: (ran_here.append(1), T + 1.0)[1],
                           (tp.tile_of(V, m), d.INOUT), (0, d.AFFINITY))
        local.append(t is not None)
    tp.wait(timeout=60)
    ctx.wait(timeout=60)
    return {"local": local, "ran": len(ran_here), "V": _val(V, rank)}


def dtd_device_chain(ctx, rank, nranks, pkg, steps=8):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 8, 8, "V", 1.0)
    tp = _dtd_pool(ctx, pkg, "dev-chain")
    t = tp.tile_of(V, 0)

    def bump(T):
        return T * 2.0

    for i in range(steps):
        tp.insert_task(bump, (t, d.INOUT), (i % nranks, d.AFFINITY),
                       device=_dev(pkg))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    return {"V0": _val(V, 0)} if rank == 0 else {}


def _slow_read(s, out):
    time.sleep(1.0)               # a later version's payload lands mid-body
    return np.asarray(s).copy()


def dtd_skip_reader(ctx, rank, nranks, pkg):
    """The recv of a LATER remote version waits for a pending local reader
    of an older one, through the skipped surrogate's WAW chain."""
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4, "V", 0.0)
    R = _filled(pkg, nranks, rank, 4, 8 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg, "skip-war")
    t = tp.tile_of(V, 0)
    res1 = tp.tile_of(R, 1)
    res2 = tp.tile_of(R, nranks + 1)
    inc = (lambda T: T + 1.0)
    tp.insert_task(inc, (t, d.INOUT), (0, d.AFFINITY))
    tp.insert_task(_slow_read, (t, d.INPUT), (res1, d.OUTPUT),
                   (1, d.AFFINITY))
    tp.insert_task(inc, (t, d.INOUT), (0, d.AFFINITY))
    tp.insert_task(inc, (t, d.INOUT), (0, d.AFFINITY))
    tp.insert_task(lambda s, out: np.asarray(s).copy(),
                   (t, d.INPUT), (res2, d.OUTPUT), (1, d.AFFINITY))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    if rank == 1:
        return {"R1": _val(R, 1), "R2": _val(R, nranks + 1)}
    return {"V0": _val(V, 0)} if rank == 0 else {}


def dtd_skip_writer(ctx, rank, nranks, pkg):
    """A LOCAL writer after a skipped remote version waits for the
    pending reader of the older version."""
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4, "V", 0.0)
    R = _filled(pkg, nranks, rank, 4, 4 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg, "skip-waw")
    t = tp.tile_of(V, 0)
    res = tp.tile_of(R, 1)
    inc = (lambda T: T + 1.0)
    tp.insert_task(inc, (t, d.INOUT), (0, d.AFFINITY))
    tp.insert_task(_slow_read, (t, d.INPUT), (res, d.OUTPUT),
                   (1, d.AFFINITY))
    tp.insert_task(inc, (t, d.INOUT), (0, d.AFFINITY))
    tp.insert_task(lambda T: np.full((4,), 50.0, np.float32),
                   (t, d.OUTPUT), (1, d.AFFINITY))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    if rank == 1:
        return {"R1": _val(R, 1)}
    return {"V0": _val(V, 0)} if rank == 0 else {}


def dtd_rdv(ctx, rank, nranks, pkg, steps=6):
    d = _mod(pkg, "dsl.dtd")
    params = _mod(pkg, "utils.mca").params
    params.set("comm_eager_limit", 64)    # every tile over the limit
    try:
        V = _filled(pkg, nranks, rank, 256, 256, "V", 0.0)
        tp = _dtd_pool(ctx, pkg, "rdv")
        t = tp.tile_of(V, 0)
        for i in range(steps):
            tp.insert_task(lambda T: T + 1.0, (t, d.INOUT),
                           (i % nranks, d.AFFINITY))
        tp.wait(timeout=120)
        ctx.wait(timeout=120)
        # the serve-once regions drain as the last GETs are served — a
        # peer's pull may complete a beat after our quiescence returns
        deadline = time.monotonic() + 15
        while ctx.comm.ce._regions and time.monotonic() < deadline:
            time.sleep(0.02)
        out = {"regions": len(ctx.comm.ce._regions),
               "refs_pending": ctx.comm.dtd_refs_pending}
        if rank == 0:
            out["V0"] = _val(V, 0)
        return out
    finally:
        params.unset("comm_eager_limit")


def _lanes(d, n, k):
    """n Region lanes of k elements each, with their byte extents."""
    return [d.Region(f"q{i}", slices=(slice(k * i, k * i + k),))
            for i in range(n)]


def _bump(lo, hi, by):
    def body(T):
        out = np.asarray(T).copy()
        out[lo:hi] += by
        return out
    return body


def dtd_region_disjoint(ctx, rank, nranks, pkg, steps=5):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 8, 8, "V", 0.0)
    R = _filled(pkg, nranks, rank, 8, 8 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    lo, hi = _lanes(d, 2, 4)
    for _ in range(steps):
        tp.insert_task(_bump(0, 4, 1.0), (t, d.INOUT | lo), (0, d.AFFINITY))
        tp.insert_task(_bump(4, 8, 2.0), (t, d.INOUT | hi),
                       (nranks - 1, d.AFFINITY))
    for r in range(nranks):
        tp.insert_task(lambda s, out: np.asarray(s).copy(),
                       (t, d.INPUT), (tp.tile_of(R, r), d.OUTPUT))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    return {"R": _val(R, rank)}


def dtd_region_barrier(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 8, 8, "V", 0.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    lo, hi = _lanes(d, 2, 4)
    tp.insert_task(_bump(0, 4, 1.0), (t, d.INOUT | lo), (0, d.AFFINITY))
    tp.insert_task(_bump(4, 8, 2.0), (t, d.INOUT | hi),
                   (nranks - 1, d.AFFINITY))
    tp.insert_task(lambda T: T * 2.0, (t, d.INOUT), (nranks - 1, d.AFFINITY))
    tp.insert_task(_bump(0, 4, 10.0), (t, d.INOUT | lo), (0, d.AFFINITY))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    return {"V0": _val(V, 0)} if rank == 0 else {}


def dtd_region_three(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 8, 8, "V", 0.0)
    R = _filled(pkg, nranks, rank, 8, 8 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    lo, hi = _lanes(d, 2, 4)
    tp.insert_task(_bump(0, 4, 3.0), (t, d.INOUT | lo), (1, d.AFFINITY))
    tp.insert_task(_bump(4, 8, 4.0), (t, d.INOUT | hi), (2, d.AFFINITY))
    tp.insert_task(lambda s, o: np.asarray(s).copy(),
                   (t, d.INPUT), (tp.tile_of(R, 0), d.OUTPUT),
                   (0, d.AFFINITY))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    return {"R0": _val(R, 0)} if rank == 0 else {}


def dtd_region_output_read(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 8, 8, "V", 7.0)
    R = _filled(pkg, nranks, rank, 8, 8 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    lo = _lanes(d, 1, 4)[0]

    def write_lo(T):
        out = np.asarray(T).copy()
        out[0:4] = 9.0
        return out
    tp.insert_task(write_lo, (t, d.OUTPUT | lo), (1, d.AFFINITY))
    tp.insert_task(lambda s, o: np.asarray(s).copy(),
                   (t, d.INPUT), (tp.tile_of(R, 1), d.OUTPUT),
                   (1, d.AFFINITY))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    return {"R1": _val(R, 1)} if rank == 1 else {}


def dtd_region_quarters(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 16, 16, "V", 0.0)
    R = _filled(pkg, nranks, rank, 16, 16 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    quarters = _lanes(d, 4, 4)
    for _ in range(3):
        for i, q in enumerate(quarters):
            tp.insert_task(_bump(4 * i, 4 * i + 4, i + 1.0),
                           (t, d.INOUT | q), (i, d.AFFINITY))
    for r in range(nranks):
        tp.insert_task(lambda s, o: np.asarray(s).copy(),
                       (t, d.INPUT), (tp.tile_of(R, r), d.OUTPUT))
    tp.wait(timeout=180)
    ctx.wait(timeout=180)
    return {"R": _val(R, rank)}


def dtd_ordering_only(ctx, rank, nranks, pkg):
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 4, 4, "V", 0.0)
    R = _filled(pkg, nranks, rank, 4, 4 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    x = d.Region("x")                    # NO slices: ordering-only
    for i in range(6):
        tp.insert_task(lambda T: T * 2.0 + 1.0, (t, d.INOUT | x),
                       (i % nranks, d.AFFINITY))
    for r in range(nranks):
        tp.insert_task(lambda s, out: np.asarray(s).copy(),
                       (t, d.INPUT), (tp.tile_of(R, r), d.OUTPUT))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    return {"R": _val(R, rank)}


def dtd_lane_write_back(ctx, rank, nranks, pkg):
    """Rank 0 writes the low lane of its tile (slowly, so the version-0
    pull rank 1 takes does not carry it); rank 1's high-lane writer reads
    the tile, waits while the low lane's payload lands in place, and
    returns the whole tile; rank 1 then reads the whole tile.  Both
    lanes' writes must be there: a lane writer's whole-tile write-back
    must not undo the other lane's landed bytes."""
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, 8, 8, "V", 0.0)
    R = _filled(pkg, nranks, rank, 8, 8 * nranks, "R", -1.0)
    tp = _dtd_pool(ctx, pkg)
    t = tp.tile_of(V, 0)
    lo, hi = _lanes(d, 2, 4)

    def slow_lo(T):
        time.sleep(0.2)
        return _bump(0, 4, 1.0)(T)

    def slow_hi(T):
        out = np.asarray(T).copy()
        time.sleep(0.8)            # the low lane's payload lands here
        out[4:8] += 2.0
        return out

    tp.insert_task(slow_lo, (t, d.INOUT | lo), (0, d.AFFINITY))
    tp.insert_task(slow_hi, (t, d.INOUT | hi), (1, d.AFFINITY))
    tp.insert_task(lambda s, o: np.asarray(s).copy(),
                   (t, d.INPUT), (tp.tile_of(R, 1), d.OUTPUT),
                   (1, d.AFFINITY))
    tp.wait(timeout=120)
    ctx.wait(timeout=120)
    return {"R1": _val(R, 1)} if rank == 1 else {}


def dtd_suite(ctx, rank, nranks, pkg, names):
    """Run the named DTD cases in turn in this rank's context; per case:
    its values, the tasks it executed per class, its Safra message
    counts, its pools' termdet counters and the DTD lanes' leftovers."""
    done = counter(ctx)
    out = {}
    before, td0 = dict(done), termdet(ctx)
    for name in names:
        npools = len(ctx.taskpools)
        vals = globals()[name](ctx, rank, nranks, pkg)
        # the case ended in global quiescence: read its counters, then
        # hold every rank until all have read theirs (a peer's next case
        # must not send into this one's window: its first frames would
        # wait in this rank's DTD backlog until the next pool registers)
        td, now = termdet(ctx), dict(done)
        lanes = (ctx.comm.dtd_refs_pending,
                 sum(len(v) for v in ctx.comm._dtd_backlog.values()))
        ctx.comm.ce.barrier(timeout=60)
        pools = [tp for tid, tp in sorted(ctx.taskpools.items())][npools:]
        out[name] = {
            "vals": vals,
            "done": {k: v - before.get(k, 0) for k, v in now.items()
                     if v != before.get(k, 0)},
            "termdet": {k: td[k] - td0[k] for k in td},
            "pools": [(tp.nb_tasks, tp.nb_pending_actions) for tp in pools],
            "lanes": lanes,
        }
        before, td0 = now, td
    return out


def dtd_snapshot(ctx, rank, nranks, pkg, mb):
    """P (rank 0, device body) writes T = 1 and R (rank 1) reads it.  The
    comm loop of rank 0 is held until P's release has returned, and right
    then the host buffer the payload was pulled into is written in place
    (+1000) — what the next pull of a newer version, or an in-place
    writer, would do — so the DTD frame (or the rendezvous pull) leaves
    only after that write.  R must see P's bytes: ``_wire_msg`` froze
    them at encode time."""
    import threading
    d = _mod(pkg, "dsl.dtd")
    V = _filled(pkg, nranks, rank, mb, mb * nranks, "V", 0.0)
    seen, wrote = {}, {}
    tp = _dtd_pool(ctx, pkg, "snap")
    t = tp.tile_of(V, 0)
    if rank == 0:
        gate = threading.Event()
        ctx.comm.ce.post(gate.wait, 30)       # frames wait behind this
        release = tp.dynamic_release

        def release_then_write(es, task):
            ready = release(es, task)
            if task.task_class.name == "produce":
                V.data_of(0).copy_on(0).payload.add_(1000.0)
                wrote["after_release"] = True
                gate.set()
            return ready
        tp.dynamic_release = release_then_write

    def produce(T):
        time.sleep(0.5)        # R's insert finds P pending: P's release
        return T + 1.0         # encodes the payload

    tp.insert_task(produce, (t, d.INOUT), (0, d.AFFINITY), device="cuda")
    tp.insert_task(lambda X: seen.update(val=float(get(X)[0])),
                   (t, d.INPUT), (1, d.AFFINITY))
    tp.wait(timeout=60)
    ctx.wait(timeout=60)
    return {"seen": seen.get("val"), "wrote": wrote.get("after_release")}


# -- textual JDF across ranks (twins of tests/test_jdf_hard_corpus.py) --------
#
# The JDF corpus the JAX package's tests read from the reference tree is
# not part of this repository, so the twins carry their JDF text inline
# and run that same text through both packages' front-ends.

#: k-cyclic views: FILL_A/FILL_CA stamp (M, N, owner) into A and its
#: k-cyclic twin CA, READ_VA reads A through the kview after the permuted
#: FILL_A wrote it home (CTL ordering over the permutation pm/pn and its
#: inverse qm/qn), COMPARE checks all three on A's owner.
KCYCLIC_JDF = r"""
extern "C" %{
/* k-cyclic distributions and k-cyclic views of a block-cyclic matrix */
#include "parsec/data_dist/matrix/two_dim_rectangle_cyclic.h"
%}

dA   [ type = "parsec_tiled_matrix_t*" ]
dVA  [ type = "parsec_tiled_matrix_t*" ]
dCA  [ type = "parsec_tiled_matrix_t*" ]
MT   [ type = "int" hidden = on default = "dA->super.mt-1" ]
NT   [ type = "int" hidden = on default = "dA->super.nt-1" ]

FILL_A(M, N)
  M = 0 .. MT
  N = 0 .. NT
: dA( M, N )
RW  A <- dA( M, N )
      -> A COMPARE( M, N )
      -> dA( M, N )
CTL C -> C READ_VA( qm(M), qn(N) )
BODY
{
    /* A[0..2] = (M, N, rank_of(M, N)) */
}
END

FILL_CA(M, N)
  M = 0 .. MT
  N = 0 .. NT
: dCA( M, N )
RW  CA <- dCA( M, N )
       -> CA COMPARE( M, N )
BODY
{
}
END

READ_VA(M, N)
  M = 0 .. MT
  N = 0 .. NT
: dVA( M, N )
CTL C  <- C FILL_A( pm(M), pn(N) )
READ VA <- dVA( M, N )
        -> VA COMPARE( M, N )
BODY
{
}
END

COMPARE(M, N)
  M = 0 .. MT
  N = 0 .. NT
: dA( M, N )
READ A  <- A FILL_A( M, N )
READ CA <- CA FILL_CA( M, N )
READ VA <- VA READ_VA( M, N )
BODY
{
}
END
"""


def jdf_kcyclic(ctx, rank, nranks, pkg):
    mat = _mod(pkg, "data.matrix")
    jdf = _mod(pkg, "dsl.ptg.jdf")
    n, mb = 12, 3
    dt = np.int32 if pkg == "jax" else _torch_dtype("int32")
    dA = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, nodes=nranks,
                               myrank=rank, P=2, dtype=dt, name="dA")
    dCA = mat.TwoDimBlockCyclic(mb=mb, nb=mb, lm=n, ln=n, nodes=nranks,
                                myrank=rank, P=2, kp=2, kq=2, dtype=dt,
                                name="dCA")
    dVA = mat.block_cyclic_kview(dA, 2, 2, name="dVA")
    qm = {dVA._pm(m): m for m in range(dA.mt)}
    qn = {dVA._pn(j): j for j in range(dA.nt)}
    errors = []

    def fill_a(A, M, N):
        A.reshape(-1)[0:3] = _as_payload(A, [M, N, dA.rank_of(M, N)])

    def fill_ca(CA, M, N):
        CA.reshape(-1)[0:3] = _as_payload(CA, [M, N, dCA.rank_of(M, N)])

    def compare(A, CA, VA, M, N):
        a, ca, va = (get(x).reshape(-1) for x in (A, CA, VA))
        if a[0] != ca[0] or a[1] != ca[1]:
            errors.append(("kcyclic", M, N))
        if va[2] != dA.rank_of(int(va[0]), int(va[1])):
            errors.append(("view", M, N))

    done = counter(ctx)
    tp = jdf.jdf_taskpool(KCYCLIC_JDF, name="kcyclic",
                          globals={"pm": dVA._pm, "pn": dVA._pn,
                                   "qm": qm.__getitem__,
                                   "qn": qn.__getitem__},
                          data={"dA": dA, "dVA": dVA, "dCA": dCA},
                          bodies={"FILL_A": fill_a, "FILL_CA": fill_ca,
                                  "READ_VA": lambda VA: None,
                                  "COMPARE": compare})
    hidden = (tp.globals["MT"], tp.globals["NT"])
    ctx.add_taskpool(tp)
    ctx.wait(timeout=120)
    return {"errors": errors, "hidden": hidden, "done": dict(done),
            "termdet": termdet(ctx),
            "pool": (tp.nb_tasks, tp.nb_pending_actions)}


def _torch_dtype(name):
    import torch
    return getattr(torch, name)


def _as_payload(like, values):
    """``values`` as the payload type of ``like`` (numpy or a tensor)."""
    if isinstance(like, np.ndarray):
        return np.asarray(values, like.dtype)
    import torch
    return torch.tensor(values, dtype=like.dtype)


#: dynamic task discovery: the declared space (n = 0..31, l = 0..2^n-1)
#: is astronomically larger than what runs — PROJECT(0, 0) is seeded by a
#: startup function, and each task spawns its children only while its
#: body leaves ``larger_than_thresh`` set (this_task->locals in C).
PROJECT_DYN_JDF = r"""
extern "C" %{
/* Haar-tree projection with runtime pruning (dynamic termination) */
%}

%option dynamic = ON

treeA     [ type = "parsec_data_collection_t*" ]
fakeDesc  [ type = "parsec_data_collection_t*" ]
NP        [ type = "int" ]
thresh    [ type = "double" ]
verbose   [ type = "int" ]
alpha     [ type = "double" ]

PROJECT(n, l) [ make_key_fn = project_dyn_make_key
                startup_fn = my_project_dyn_startup ]
  n = 0 .. 31
  l = 0 .. %{ return (1 << n) - 1; %}
  larger_than_thresh = 1

: treeA( n, l )

CTL RL <- (n > 0 && l % 2 == 0) ? RL PROJECT( n-1, l/2 )
       <- (n > 0 && l % 2 == 1) ? RR PROJECT( n-1, l/2 )
       -> larger_than_thresh ? RL PROJECT( n+1, 2*l )
CTL RR -> larger_than_thresh ? RL PROJECT( n+1, 2*l+1 )
RW  NODE <- NEW
         -> treeA( n, l )

BODY
{
    /* project f on the (n, l) box; prune when the detail is small */
}
END
"""


def tree_dist(pkg, nodes=1, myrank=0, name="treeA"):
    """Minimal tree collection (the reference's test-local fixture
    tests/apps/haar_tree/tree_dist.c): (n, l) keys, data created on
    demand, in either package."""
    DataCollection = _mod(pkg, "data.collection").DataCollection
    new_data = _mod(pkg, "data.data").new_data

    class TreeDist(DataCollection):
        def __init__(self):
            super().__init__(nodes=nodes, myrank=myrank, name=name)
            self._lock = threading.Lock()
            self.tiles = {}

        def data_key(self, n, l=0):
            return (n, l)

        def key_to_indices(self, key):
            return tuple(key)

        def rank_of(self, n, l=0):
            return 0 if self.nodes == 1 else (n * 31 + l) % self.nodes

        def data_of(self, n, l=0):
            with self._lock:
                d = self.tiles.get((n, l))
                if d is None:
                    zeros = np.zeros(2) if pkg == "jax" else \
                        __import__("torch").zeros(2, dtype=_torch_dtype(
                            "float64"))
                    d = new_data(zeros, key=(self.name, n, l),
                                 collection=self)
                    self.tiles[(n, l)] = d
                return d
    return TreeDist()


def project_dyn(ctx, rank, nranks, pkg):
    """The project_dyn JDF: on one rank, or seeded only on rank 0 of
    several so every task elsewhere arrives by remote discovery (the
    pool-scoped quiescence hold of the distributed dynamic termdet)."""
    import math
    jdf = _mod(pkg, "dsl.ptg.jdf")
    tree = tree_dist(pkg, nodes=nranks, myrank=rank)
    ALPHA, THRESH, NMIN = 1.0, 0.02, 4
    executed, pruned = [], []

    def key_to_x(n, l):
        return -10.0 + (20.0 * 2.0 ** -n) * (0.5 + l)

    def f(x):
        return math.exp(-(x / ALPHA) * (x / ALPHA))

    def project(task, n, l, NODE):
        executed.append((n, l))
        sl = f(key_to_x(n + 1, 2 * l))
        sr = f(key_to_x(n + 1, 2 * l + 1))
        d = 0.5 * (sl - sr)
        if n >= NMIN and abs(d) * 2.0 ** (-0.5 * n) <= THRESH:
            task.locals["larger_than_thresh"] = 0
            pruned.append((n, l))
        else:
            NODE[:] = _as_payload(NODE, [0.5 * (sl + sr), d])

    arena = (np.float64 if pkg == "jax" else _torch_dtype("float64"))
    done = counter(ctx)
    tp = jdf.jdf_taskpool(
        PROJECT_DYN_JDF, name="project_dyn",
        globals={"NP": nranks, "fakeDesc": tree, "thresh": THRESH,
                 "verbose": 0, "alpha": ALPHA},
        data={"treeA": tree}, bodies={"PROJECT": project},
        arenas={"default": ((2,), arena)},
        funcs={"project_dyn_make_key": lambda n, l: (n << 32) | l,
               "my_project_dyn_startup":
               lambda globals_, r: [dict(n=0, l=0)] if r == 0 else []})
    dynamic = type(tp).__name__
    ctx.add_taskpool(tp)
    ctx.wait(timeout=120)
    root = None
    if (0, 0) in tree.tiles and tree.rank_of(0, 0) == rank:
        root = get(tree.tiles[(0, 0)].pull_to_host().payload).tolist()
    return {"executed": sorted(executed), "pruned": sorted(pruned),
            "root": root, "pool_class": dynamic, "done": dict(done),
            "termdet": termdet(ctx) if nranks > 1 else None,
            "pool": (tp.nb_tasks, tp.nb_pending_actions)}


# -- the ring, ring attention and all2all apps across ranks -----------------

def _ring_vectors(pkg, nranks, rank, P, mb):
    V = _vec(pkg, nranks, rank, mb, mb * P, name="V")
    A = _vec(pkg, nranks, rank, mb, mb * P, name="A")
    for m, _ in V.local_tiles():
        put(V.data_of(m).copy_on(0).payload, np.full(mb, m + 1, np.float32))
    for m, _ in A.local_tiles():
        put(A.data_of(m).copy_on(0).payload, np.zeros(mb, np.float32))
    return V, A


def attn_operands(P, Tq, d, seed):
    """Ring attention's Q, K, V (float32 numpy, P * Tq rows)."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((P * Tq, d)).astype(np.float32)
                 for _ in range(3))


def ring_suite(ctx, rank, nranks, pkg, Tq=4, d=8):
    """The ring allreduce (two parties per rank: intra and inter-rank
    hops; reference tests/test_apps_ring.py::_ring_ranks), then causal
    ring attention with one party per rank, every KV block crossing the
    wire: each rank's accumulators and task counts."""
    ring = _mod(pkg, "apps.ring")
    attn = _mod(pkg, "apps.ring_attention")
    mat = _mod(pkg, "data.matrix")
    done = counter(ctx)
    P = 2 * nranks
    V, A = _ring_vectors(pkg, nranks, rank, P, 4)
    ctx.add_taskpool(ring.ring_pipeline_taskpool(
        V, A, **({"device": "cpu"} if pkg == "port" else {})))
    ctx.wait(timeout=180)
    ring_vals = {m: get(A.data_of(m).pull_to_host().payload).tolist()
                 for m, _ in A.local_tiles()}
    ring_done = dict(done)
    ctx.comm.ce.barrier(timeout=120)

    P = nranks
    Q, K, Vv = attn_operands(P, Tq, d, seed=13)
    KV = mat.TwoDimBlockCyclic(mb=2 * Tq, nb=d, lm=P * 2 * Tq, ln=d,
                               nodes=nranks, myrank=rank, P=nranks,
                               name="KV")
    ACC = mat.TwoDimBlockCyclic(mb=Tq, nb=2 * d + 2, lm=P * Tq,
                                ln=2 * d + 2, nodes=nranks, myrank=rank,
                                P=nranks, name="ACC")
    for q, _ in KV.local_tiles():
        KV.data_of(q, 0).overwrite_host(
            attn.pack_kv(K[q * Tq:(q + 1) * Tq], Vv[q * Tq:(q + 1) * Tq]))
    for q, _ in ACC.local_tiles():
        ACC.data_of(q, 0).overwrite_host(
            attn.pack_query(Q[q * Tq:(q + 1) * Tq]))
    done.clear()
    ctx.add_taskpool(attn.ring_attention_taskpool(
        KV, ACC, device="cpu", causal=True))
    ctx.wait(timeout=180)
    out = {q: get(attn.unpack_output(get(
        ACC.data_of(q, 0).pull_to_host().payload), d)).tolist()
        for q, _ in ACC.local_tiles()}
    return {"ring": ring_vals, "ring_done": ring_done, "attn": out,
            "attn_done": dict(done), "termdet": termdet(ctx)}


def all2all(ctx, rank, nranks, pkg, mb=4):
    """reference: tests/apps/all2all (tests/test_apps_trees.py::_all2all)
    — every rank sends a distinct block to every other rank (PTG over
    two tabular distributions)."""
    mat = _mod(pkg, "data.matrix")
    api = _mod(pkg, "dsl.ptg.api")
    # S(i,j) owned by rank i; R(i,j) owned by rank j: the (i,j) edge is
    # an i->j message — all pairs = all-to-all
    S = mat.TwoDimTabular(mb=mb, nb=mb, lm=nranks * mb, ln=nranks * mb,
                          table=[i for i in range(nranks)
                                 for _ in range(nranks)],
                          nodes=nranks, myrank=rank, name="S")
    R = mat.TwoDimTabular(mb=mb, nb=mb, lm=nranks * mb, ln=nranks * mb,
                          table=[j for _ in range(nranks)
                                 for j in range(nranks)],
                          nodes=nranks, myrank=rank, name="R")
    for i, j in S.local_tiles():
        S.data_of(i, j).copy_on(0).payload[:] = 100.0 * i + j
    for i, j in R.local_tiles():
        R.data_of(i, j).copy_on(0).payload[:] = -1.0
    p = api.PTG("a2a", N=nranks)
    p.task("SEND", i=api.Range(0, nranks - 1), j=api.Range(0, nranks - 1)) \
        .affinity(lambda i, j, S=S: S(i, j)) \
        .flow("T", "READ",
              api.IN(api.DATA(lambda i, j, S=S: S(i, j))),
              api.OUT(api.TASK("RECV", "T", lambda i, j: dict(i=i, j=j)))) \
        .body(lambda: None)
    p.task("RECV", i=api.Range(0, nranks - 1), j=api.Range(0, nranks - 1)) \
        .affinity(lambda i, j, R=R: R(i, j)) \
        .flow("T", "READ",
              api.IN(api.TASK("SEND", "T", lambda i, j: dict(i=i, j=j)))) \
        .flow("D", "RW",
              api.IN(api.DATA(lambda i, j, R=R: R(i, j))),
              api.OUT(api.DATA(lambda i, j, R=R: R(i, j)))) \
        .body(lambda T, D: {"D": T})
    done = counter(ctx)
    ctx.add_taskpool(p.build())
    ctx.wait(timeout=120)
    return {"vals": _local_tiles(R, pkg), "done": dict(done),
            "proto": proto(ctx), "termdet": termdet(ctx)}


# -- chip_smoke.py's 2-rank DTD GEMM, rehearsed on the CPU ------------------

def chip_dtd_gemm(ctx, rank, nranks, pkg, mb, t, passes, refs):
    """One rank of chip_smoke.py's 2-rank DTD GEMM path at a tiny size
    (the port only: the script drives the port)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    return chip_smoke._dtd_gemm_rank(ctx, rank, nranks, mb, t, passes,
                                     refs)


def chip_pingpong(ctx, rank, nranks, pkg, rtt, bw):
    """One rank of chip_smoke.py's 2-rank pingpong (the port only)."""
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    return {"pingpong": chip_smoke._pingpong_rank(ctx, rank, nranks, rtt,
                                                  bw)}


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
