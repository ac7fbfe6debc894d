"""The reference PTG compiler's edge-case suite on the port's PTG
front-end against the JAX package's.

Twins of every case of tests/test_ptgpp_golden.py (reference:
tests/dsl/ptg/ptgpp/, one minimal JDF per jdf2c generator path): each
case builds the same PTG through both packages' front-ends (the port on
``device="cpu"``), runs it, and holds what each observes — the build
diagnostics, the NULL-forward warning, the values written home, which
bodies ran — to the reference test's expectations and to each other.
Tiles are numpy arrays in the JAX package and CPU tensors in the port.
"""

import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.api as jax_api
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.api as port_api

PKGS = {"jax": (jax_context, jax_matrix, jax_api, {}),
        "port": (port_context, port_matrix, port_api, {"device": "cpu"})}


class _P:
    def __init__(self, pkg):
        ctx_mod, matrix, api, self.ctx_kw = PKGS[pkg]
        self.pkg = pkg
        self.Context = ctx_mod.Context
        self.TwoDimBlockCyclic = matrix.TwoDimBlockCyclic
        self.VectorTwoDimCyclic = matrix.VectorTwoDimCyclic
        for name in ("DATA", "IN", "NEW", "NULL_END", "OUT", "PTG", "Range",
                     "TASK"):
            setattr(self, name, getattr(api, name))

    def run(self, p, nb_cores=2, timeout=60):
        with self.Context(nb_cores=nb_cores, **self.ctx_kw) as ctx:
            ctx.add_taskpool(p.build() if isinstance(p, self.PTG) else p)
            ctx.wait(timeout=timeout)

    def fill(self, V, value):
        for m, _ in V.local_tiles():
            V.data_of(m).copy_on(0).payload[:] = value

    def home(self, d):
        """A tile's values once pulled home, as a float64 numpy array."""
        p = d.pull_to_host().payload
        p = p.numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
        return p.astype(np.float64)


def _both(case):
    """``case(_P(pkg))`` on both packages; their observations must agree.
    Returns the port's."""
    got = {pkg: case(_P(pkg)) for pkg in PKGS}
    jax_obs, port_obs = got["jax"], got["port"]
    if isinstance(port_obs, np.ndarray):
        np.testing.assert_array_equal(port_obs, jax_obs)
    else:
        assert port_obs == jax_obs
    return port_obs


# -- output_NULL / output_NEW: rejected at build time -----------------------

_GUARDS = [None, lambda k: k < 5, lambda k: k >= 5]
_GUARD_IDS = ["plain", "true-case", "false-case"]


@pytest.mark.parametrize("guard", _GUARDS, ids=_GUARD_IDS)
def test_output_null_rejected(guard):
    def case(P):
        p = P.PTG("t", NB=10)
        with pytest.raises(ValueError,
                           match="NULL data only supported in IN") as ei:
            p.task("T", k=P.Range(0, 9)).flow(
                "A", "RW",
                P.IN(P.NULL_END()),
                P.OUT(P.NULL_END(), when=guard))
        return str(ei.value)
    _both(case)


@pytest.mark.parametrize("guard", _GUARDS, ids=_GUARD_IDS)
def test_output_new_rejected(guard):
    def case(P):
        p = P.PTG("t", NB=10)
        with pytest.raises(ValueError,
                           match="NEW only supported in IN dependencies") \
                as ei:
            p.task("T", k=P.Range(0, 9)).flow(
                "A", "RW",
                P.IN(P.NEW()),
                P.OUT(P.NEW(), when=guard))
        return str(ei.value)
    _both(case)


# -- forward_{READ,RW}_NULL: NULL flows forward with a runtime warning ------

@pytest.mark.parametrize("mode", ["READ", "RW"])
def test_forward_null(mode, capfd):
    """The NULL input is forwarded task-to-task down the whole chain;
    every body receives None and each runtime flags the forward
    (reference: PASS_REGULAR_EXPRESSION "A NULL is forwarded")."""
    def case(P):
        NB = 6
        V = P.VectorTwoDimCyclic(mb=2, lm=2 * (NB + 1))
        seen = []
        p = P.PTG("nullfwd", NB=NB)
        p.task("T", k=P.Range(0, NB)) \
            .affinity(lambda k, V=V: V(k)) \
            .flow("A", mode,
                  P.IN(P.NULL_END(), when=lambda k: k == 0),
                  P.IN(P.TASK("T", "A", lambda k: dict(k=k - 1)),
                       when=lambda k: k > 0),
                  P.OUT(P.TASK("T", "A", lambda k: dict(k=k + 1)),
                        when=lambda k, NB=NB: k < NB)) \
            .body(lambda A, k: seen.append((k, A is None)))
        capfd.readouterr()
        P.run(p)
        warned = capfd.readouterr().err.count("A NULL is forwarded")
        return sorted(seen), warned
    seen, warned = _both(case)
    assert seen == [(k, True) for k in range(7)]
    assert warned >= 1


# -- write_check.jdf: WRITE/RW/READ flow plumbing, numerically validated ----

def test_write_check():
    """Port of write_check.jdf: STARTUP writes a NEW tile with index
    values; TASK1 increments the collection tile and copies the index
    tile through a second NEW flow; TASK2 sums them back into the
    collection.  Final A(p, k)[i] == 2 + index."""
    P_, NT, BLOCK = 2, 3, 8
    idx = np.arange(BLOCK, dtype=np.float32).reshape(1, BLOCK)

    def case(P):
        A = P.TwoDimBlockCyclic(mb=1, nb=BLOCK, lm=P_ + 1,
                                ln=(NT + 1) * BLOCK, name="A")
        for m, n in A.local_tiles():
            A.data_of(m, n).copy_on(0).payload[:] = 1.0
        # the index tile in the package's own array type; TASK1's copy of
        # it is the type's own copy (numpy ``.copy()``, torch ``.clone()``)
        ix = idx if P.pkg == "jax" else torch.from_numpy(idx.copy())
        dup = (lambda a: a.copy()) if P.pkg == "jax" \
            else (lambda a: a.clone())
        p = P.PTG("write_check", P=P_, NT=NT)
        p.arena("blk", (1, BLOCK))
        p.task("STARTUP", p=P.Range(0, P_), k=P.Range(0, NT)) \
            .affinity(lambda p, k, A=A: A(p, k)) \
            .flow("A1", "WRITE",
                  P.IN(P.NEW("blk")),
                  P.OUT(P.TASK("TASK1", "A2", lambda p, k: dict(p=p, k=k)))) \
            .body(lambda A1, k, ix=ix: k * BLOCK + ix)
        p.task("TASK1", p=P.Range(0, P_), k=P.Range(0, NT)) \
            .affinity(lambda p, k, A=A: A(p, k)) \
            .flow("A3", "WRITE",
                  P.IN(P.NEW("blk")),
                  P.OUT(P.TASK("TASK2", "A1", lambda p, k: dict(p=p, k=k)))) \
            .flow("A1", "RW",
                  P.IN(P.DATA(lambda p, k, A=A: A(p, k))),
                  P.OUT(P.TASK("TASK2", "A2", lambda p, k: dict(p=p, k=k)))) \
            .flow("A2", "READ",
                  P.IN(P.TASK("STARTUP", "A1",
                              lambda p, k: dict(p=p, k=k)))) \
            .body(lambda A1, A2, A3: {"A1": A1 + 1.0, "A3": dup(A2)})
        p.task("TASK2", p=P.Range(0, P_), k=P.Range(0, NT)) \
            .affinity(lambda p, k, A=A: A(p, k)) \
            .flow("A1", "READ",
                  P.IN(P.TASK("TASK1", "A3", lambda p, k: dict(p=p, k=k)))) \
            .flow("A2", "RW",
                  P.IN(P.TASK("TASK1", "A1", lambda p, k: dict(p=p, k=k))),
                  P.OUT(P.DATA(lambda p, k, A=A: A(p, k)))) \
            .body(lambda A1, A2: A2 + A1)
        P.run(p)
        return np.stack([P.home(A.data_of(m, n))
                         for m in range(P_ + 1) for n in range(NT + 1)])
    got = _both(case)
    expect = np.stack([2.0 + n * BLOCK + idx
                       for m in range(P_ + 1) for n in range(NT + 1)])
    np.testing.assert_allclose(got, expect)


# -- too_many_*: the reference's codegen limits do not exist here -----------

def test_many_in_deps_supported():
    """too_many_in_deps.jdf must FAIL in the reference (dep bitmask
    width); counter-based tracking has no such limit — 30 CTL gather
    deps on one flow must work."""
    def case(P):
        NB = 30
        V = P.VectorTwoDimCyclic(mb=1, lm=NB + 1)
        done = []
        p = P.PTG("many_in", NB=NB)
        p.task("SRC", k=P.Range(0, NB - 1)) \
            .affinity(lambda k, V=V: V(k)) \
            .flow("X", "CTL",
                  P.OUT(P.TASK("SINK", "X", lambda k: dict()))) \
            .body(lambda: None)
        p.task("SINK") \
            .affinity(lambda V=V: V(NB)) \
            .flow("X", "CTL",
                  *[P.IN(P.TASK("SRC", "X", lambda i=i: dict(k=i)))
                    for i in range(NB)]) \
            .body(lambda: done.append(1))
        P.run(p)
        return done
    assert _both(case) == [1]


def test_many_out_deps_supported():
    """too_many_out_deps.jdf inverse: 30 guarded OUT deps on one flow."""
    def case(P):
        NB = 30
        V = P.VectorTwoDimCyclic(mb=1, lm=NB + 1)
        got = []
        p = P.PTG("many_out", NB=NB)
        p.task("SRC") \
            .affinity(lambda V=V: V(NB)) \
            .flow("X", "CTL",
                  *[P.OUT(P.TASK("SINK", "X", lambda i=i: dict(k=i)))
                    for i in range(NB)]) \
            .body(lambda: None)
        p.task("SINK", k=P.Range(0, NB - 1)) \
            .affinity(lambda k, V=V: V(k)) \
            .flow("X", "CTL", P.IN(P.TASK("SRC", "X", lambda k: dict()))) \
            .body(lambda k: got.append(k))
        P.run(p)
        return sorted(got)
    assert _both(case) == list(range(30))


def test_many_flows_supported():
    """too_many_{read,write}_flows.jdf inverse: 12 read + 12 write flows
    on one task class (the reference caps flows at MAX_PARAM_COUNT)."""
    N = 12
    args = [f"r{i}" for i in range(N)] + [f"w{i}" for i in range(N)]
    exec_ns = {}
    exec("def body({0}):\n    return ({1})".format(
        ", ".join(args), ", ".join(f"w{i} + r{i}" for i in range(N))),
        exec_ns)

    def case(P):
        V = P.VectorTwoDimCyclic(mb=2, lm=2 * N)
        for m, _ in V.local_tiles():
            V.data_of(m).copy_on(0).payload[:] = float(m)
        p = P.PTG("many_flows", N=N)
        tb = p.task("T").affinity(lambda V=V: V(0))
        for i in range(N):
            tb.flow(f"r{i}", "READ", P.IN(P.DATA(lambda i=i, V=V: V(i))))
        for i in range(N):
            tb.flow(f"w{i}", "RW", P.IN(P.DATA(lambda i=i, V=V: V(i))),
                    P.OUT(P.DATA(lambda i=i, V=V: V(i))))
        tb.body(exec_ns["body"])
        P.run(p)
        return np.stack([P.home(V.data_of(m)) for m in range(N)])
    got = _both(case)
    np.testing.assert_allclose(
        got, np.repeat(2.0 * np.arange(N)[:, None], 2, axis=1))


def test_many_local_vars_supported():
    """too_many_local_vars.jdf inverse: a task class with 12 parameters
    (the reference caps MAX_LOCAL_COUNT)."""
    def case(P):
        V = P.VectorTwoDimCyclic(mb=1, lm=1)
        hits = []
        p = P.PTG("many_locals")
        params = {f"p{i}": P.Range(0, 1) for i in range(12)}
        p.task("T", **params) \
            .affinity(lambda V=V, **kw: V(0)) \
            .body(lambda task: hits.append(
                tuple(task.locals[f"p{i}"] for i in range(12))))
        P.run(p)
        return len(hits), sorted(set(hits))
    n, uniq = _both(case)
    assert n == 2 ** 12 and len(uniq) == 2 ** 12


# -- user-defined make_key (udf.jdf [make_key_fn = ...]) --------------------

def test_user_defined_make_key():
    """Custom task keys drive dep tracking and the repo exactly like the
    default parameter-tuple keys (reference: udf.jdf UD_MAKE_KEY)."""
    NT = 5

    def case(P):
        V = P.VectorTwoDimCyclic(mb=2, lm=2 * NT)
        P.fill(V, 0.0)
        p = P.PTG("udf", NT=NT)
        # keys deliberately scrambled: (7 * k + 13) — any hashable works
        p.task("S", k=P.Range(0, NT - 1)) \
            .affinity(lambda k, V=V: V(k)) \
            .make_key(lambda k: 7 * k + 13) \
            .flow("T", "RW",
                  P.IN(P.DATA(lambda k, V=V: V(k)), when=lambda k: k == 0),
                  P.IN(P.TASK("S", "T", lambda k: dict(k=k - 1)),
                       when=lambda k: k > 0),
                  P.OUT(P.TASK("S", "T", lambda k: dict(k=k + 1)),
                        when=lambda k, NT=NT: k < NT - 1),
                  P.OUT(P.DATA(lambda k, V=V: V(k)),
                        when=lambda k, NT=NT: k == NT - 1)) \
            .body(lambda T: T + 1.0)
        P.run(p)
        return P.home(V.data_of(NT - 1))
    np.testing.assert_allclose(_both(case), float(NT))


# -- branching / choice / local-indices -------------------------------------

def test_branching_diamond():
    """branching.jdf pattern: one producer fans out along guarded edges
    to two distinct consumer classes, which join in a sink."""
    def case(P):
        V = P.VectorTwoDimCyclic(mb=2, lm=8)
        P.fill(V, 1.0)
        p = P.PTG("branching", NB=4)
        p.task("SRC", k=P.Range(0, 3)) \
            .affinity(lambda k, V=V: V(k)) \
            .flow("T", "RW",
                  P.IN(P.DATA(lambda k, V=V: V(k))),
                  P.OUT(P.TASK("EVEN", "T", lambda k: dict(k=k)),
                        when=lambda k: k % 2 == 0),
                  P.OUT(P.TASK("ODD", "T", lambda k: dict(k=k)),
                        when=lambda k: k % 2 == 1)) \
            .body(lambda T, k: T * (k + 1.0))
        for cls, par, mul in (("EVEN", 0, 10.0), ("ODD", 1, 100.0)):
            p.task(cls, k=P.Range(par, 3, 2)) \
                .affinity(lambda k, V=V: V(k)) \
                .flow("T", "RW",
                      P.IN(P.TASK("SRC", "T", lambda k: dict(k=k))),
                      P.OUT(P.DATA(lambda k, V=V: V(k)))) \
                .body(lambda T, mul=mul: T * mul)
        P.run(p)
        return np.stack([P.home(V.data_of(k)) for k in range(4)])
    got = _both(case)
    for k in range(4):
        np.testing.assert_allclose(
            got[k], (k + 1.0) * (10.0 if k % 2 == 0 else 100.0))


def test_choice_guarded_paths():
    """choice.jdf pattern: a run-time global selects which guarded dep
    path carries the data; the not-taken path must produce no edge."""
    def case(P):
        out = []
        for choice in (0, 1):
            V = P.VectorTwoDimCyclic(mb=2, lm=4)
            P.fill(V, 3.0)
            p = P.PTG("choice", C=choice)
            p.task("A") \
                .affinity(lambda V=V: V(0)) \
                .flow("T", "RW",
                      P.IN(P.DATA(lambda V=V: V(0))),
                      P.OUT(P.TASK("L", "T", lambda: dict()),
                            when=lambda C=choice: C == 0),
                      P.OUT(P.TASK("R", "T", lambda: dict()),
                            when=lambda C=choice: C == 1)) \
                .body(lambda T: T + 1.0)
            for cls, target in (("L", 0), ("R", 1)):
                p.task(cls) \
                    .affinity(lambda V=V: V(1)) \
                    .flow("T", "RW",
                          P.IN(P.TASK("A", "T", lambda: dict()),
                               when=lambda C=choice, c=target: C == c),
                          P.IN(P.NULL_END(),
                               when=lambda C=choice, c=target: C != c),
                          P.OUT(P.DATA(lambda V=V: V(1)),
                                when=lambda C=choice, c=target: C == c)) \
                    .body(lambda T: None if T is None else T * 2.0)
            P.run(p)
            out.append(P.home(V.data_of(1)))
        return np.stack(out)
    np.testing.assert_allclose(_both(case), 8.0)


def test_local_indices_derived_ranges():
    """local_indices.jdf pattern: later parameters range over earlier
    ones (triangular spaces) and dep expressions use derived locals."""
    NT = 4

    def case(P):
        V = P.VectorTwoDimCyclic(mb=1, lm=NT * (NT + 1) // 2 + 1)
        hits = []
        p = P.PTG("locidx", NT=NT)
        p.task("T", k=P.Range(0, NT - 1), j=P.Range(0, lambda k: k)) \
            .affinity(lambda k, j, V=V: V(k * (k + 1) // 2 + j)) \
            .body(lambda k, j: hits.append((k, j)))
        P.run(p)
        return sorted(hits)
    assert _both(case) == [(k, j) for k in range(NT) for j in range(k + 1)]
