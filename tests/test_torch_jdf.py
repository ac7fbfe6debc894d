"""The port's textual JDF front-end against the JAX package's.

Twins of tests/test_jdf_parser.py and tests/test_jdf_hard_corpus.py.  Those
read the reference's .jdf corpus from a tree this repository does not
carry, so most of them skip here; the twins carry their JDF text inline
(written for this file in the corpus's style: the examples Ex01-Ex07, a
1D stencil, a multichain, k-cyclic views, a binomial-tree reduction and
a dynamic Haar-tree projection) and run the SAME text through
``parsec_tpu.dsl.ptg.jdf`` and the port's ``jdf_taskpool``.  Each case
must agree on the values, the tasks executed per class and the pool's
termdet counters.  The port runs with ``device="cpu"``; the multi-rank
cases run the rank functions of tests/torch_comm_workers.py under both
packages' launchers.
"""

import collections
import threading

import jax  # noqa: F401  (the JAX package below runs on the CPU)
import numpy as np
import pytest
import torch

import parsec_tpu.core.context as jax_context
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.jdf as jax_jdf
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.jdf as port_jdf
import torch_comm_workers as W

SIDES = {
    "jax": (jax_context, jax_matrix, jax_jdf, {}, np.int32, np.float64),
    "port": (port_context, port_matrix, port_jdf, {"device": "cpu"},
             torch.int32, torch.float64),
}

T_RUN = 240   # per distributed run, seconds


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


class _Side:
    def __init__(self, side):
        (self.ctx_mod, self.mat, self.jdf, self.kw, self.i32,
         self.f64) = SIDES[side]
        self.side = side

    def vec(self, mb, lm, dtype=None, fill=None):
        kw = {} if dtype is None else {"dtype": dtype}
        V = self.mat.VectorTwoDimCyclic(mb=mb, lm=lm, **kw)
        if fill is not None:
            for m, _ in V.local_tiles():
                V.data_of(m).copy_on(0).payload[:] = fill
        return V

    def run(self, tp, expect_error=False):
        """Run ``tp``; return (per-class completions, termdet counters)."""
        done = collections.Counter()
        lock = threading.Lock()

        def count(es, event, task):
            with lock:
                done[task.task_class.name] += 1
        with self.ctx_mod.Context(nb_cores=2, **self.kw) as ctx:
            ctx.pins_register("complete_exec", count)
            ctx.add_taskpool(tp)
            if expect_error:
                with pytest.raises(RuntimeError) as exc:
                    ctx.wait(timeout=60)
                return exc.value
            ctx.wait(timeout=60)
        return dict(done), (tp.nb_tasks, tp.nb_pending_actions)


def _both(case):
    """(jax, port) results of ``case(side)``: each is (values, per-class
    completions, termdet counters)."""
    return [case(_Side(side)) for side in ("jax", "port")]


def _same(j, p):
    assert p[0] == j[0], (p[0], j[0])
    assert p[1] == j[1]                 # executed tasks per class
    assert p[2] == j[2] == (0, 0)       # termdet drained


# -- the examples (twins of tests/test_jdf_parser.py) -------------------------

EX01 = r"""
extern "C" %{
#include "parsec.h"
/* the hello-world of the PaRSEC examples: one task, no data */
%}

taskdist   [ type = "parsec_data_collection_t*" ]

HelloWorld(k)

k = 0 .. 0

: taskdist( k )

BODY
{
    printf("HelloWorld %d\n", k);
}
END
"""


def test_ex01_helloworld_runs():
    def case(s):
        said = []

        def body(k):
            said.append(k)
        tp = s.jdf.jdf_taskpool(EX01, data={"taskdist": s.vec(1, 1)},
                                bodies={"HelloWorld": body})
        return (said,) + s.run(tp)
    j, p = _both(case)
    _same(j, p)
    assert p[0] == [0]


EX02 = r"""
extern "C" %{
/* a chain of NB+1 tasks passing one NEW datum along */
%}

taskdist   [ type = "parsec_data_collection_t*" ]
NB         [ type = "int" ]

Task(k)

k = 0 .. NB

: taskdist( k )

RW  A <- (k == 0)  ? NEW : A Task( k-1 )
      -> (k < NB) ? A Task( k+1 )

BODY
{
    int *Aint = (int*)A;
    if ( k == 0 ) *Aint = 0; else *Aint += 1;
}
END
"""

#: Ex03 is Ex02 over MPI: the chain hops between the ranks the taskdist
#: collection maps k to (one rank here)
EX03 = EX02.replace("a chain of NB+1 tasks passing one NEW datum along",
                    "the chain across the ranks of taskdist") \
    .replace("RW  A <- (k == 0)  ? NEW : A Task( k-1 )",
             "RW  A <- (k == 0)  ? NEW : A Task( k-1 )  [ type = DEFAULT ]")


def _chain_case(text, NB):
    def case(s):
        seen = []

        def body(A, k):
            A[0] = 0 if k == 0 else A[0] + 1
            seen.append(int(A[0]))
        tp = s.jdf.jdf_taskpool(text, globals={"NB": NB},
                                data={"taskdist": s.vec(1, NB + 1)},
                                bodies={"Task": body},
                                arenas={"default": ((1,), s.i32)})
        return (seen,) + s.run(tp)
    return case


def test_ex02_chain_new_datum():
    j, p = _both(_chain_case(EX02, 7))
    _same(j, p)
    assert p[0] == list(range(8))


def test_ex03_chainmpi_chain_semantics():
    j, p = _both(_chain_case(EX03, 9))
    _same(j, p)
    assert p[0] == list(range(10))


EX04 = r"""
mydata  [ type = "parsec_data_collection_t*" ]
NB      [ type = "int" ]

Task(k)

k = 0 .. NB

: mydata( k )

/* the datum of tile 0 flows the whole chain and lands in tile NB */
RW  A <- (k == 0)  ? mydata( k ) : A Task( k-1 )
      -> (k == NB) ? mydata( k ) : A Task( k+1 )

BODY
{
    int *Aint = (int*)A;
    *Aint += 1;
}
END
"""


def test_ex04_chaindata_roundtrip():
    NB = 5

    def case(s):
        V = s.vec(1, NB + 1, s.i32, 100)

        def body(A, k):
            A[0] += 1
        tp = s.jdf.jdf_taskpool(EX04, globals={"NB": NB},
                                data={"mydata": V}, bodies={"Task": body})
        done = s.run(tp)
        return (int(_np(V.data_of(NB).pull_to_host().payload)[0]),) + done
    j, p = _both(case)
    _same(j, p)
    assert p[0] == 100 + NB + 1


EX05 = r"""
mydata  [ type = "parsec_data_collection_t*" ]
nodes   [ type = "int" ]
rank    [ type = "int" ]
NB      [ type = "int" ]

TaskBcast(k)

k = 0 .. 0

: mydata( k )

RW  A <- mydata( k )
      -> A TaskRecv( k, 0 .. NB .. 2 )

BODY
{
    *(int*)A = k;
}
END

TaskRecv(k, n)

k = 0 .. 0
n = 0 .. NB .. 2

: mydata( n )

READ A <- A TaskBcast( k )

BODY
{
    printf("%d received %d\n", n, *(int*)A);
}
END
"""


def test_ex05_broadcast_fanout():
    NB = 6

    def case(s):
        V = s.vec(1, NB + 1, s.i32, -1)
        lock = threading.Lock()
        recvs = []

        def bcast(A, k):
            A[0] = k

        def recv(A, k, n):
            with lock:
                recvs.append((k, n, int(A[0])))
        tp = s.jdf.jdf_taskpool(EX05, globals={"nodes": 1, "rank": 0,
                                               "NB": NB},
                                data={"mydata": V},
                                bodies={"TaskBcast": bcast,
                                        "TaskRecv": recv})
        done = s.run(tp)
        return (sorted(recvs),) + done
    j, p = _both(case)
    _same(j, p)
    assert p[0] == [(0, n, 0) for n in range(0, NB + 1, 2)]


EX06 = r"""
mydata  [ type = "parsec_data_collection_t*" ]
nodes   [ type = "int" ]
rank    [ type = "int" ]
NB      [ type = "int" hidden = on default = "6" ]

TaskBcast(k)

k = 0 .. 0

: mydata( k )

RW  A <- mydata( k )
      -> A TaskRecv( k, 0 .. NB .. 2 )
      -> A TaskUpdate( k )

BODY
{
    *(int*)A = k + 1;
}
END

TaskRecv(k, n)

k = 0 .. 0
n = 0 .. NB .. 2

: mydata( n + 1 )

READ A <- A TaskBcast( k )

BODY
{
}
END

TaskUpdate(k)

k = 0 .. 0

: mydata( k )

/* the write-after-read hazard: the runtime hands the readers their own
   version while the update writes the datum */
RW  A <- A TaskBcast( k )
      -> mydata( k )

BODY
{
    *(int*)A = -k - 1;
}
END
"""


def test_ex06_raw_bcast_update():
    NB = 6

    def case(s):
        V = s.vec(1, 1 + NB + 1, s.i32, 0)
        lock = threading.Lock()
        recvd = []

        def bcast(A, k):
            A[0] = k + 1

        def recv(A, k, n):
            with lock:
                recvd.append((k, n, int(A[0])))

        def update(A, k):
            A[0] = -k - 1
        tp = s.jdf.jdf_taskpool(EX06, globals={"nodes": 1, "rank": 0,
                                               "mydata": V},
                                data={"mydata": V},
                                bodies={"TaskBcast": bcast,
                                        "TaskRecv": recv,
                                        "TaskUpdate": update})
        done = s.run(tp)
        home = int(_np(V.data_of(0).pull_to_host().payload)[0])
        return ((sorted(recvd), home),) + done
    j, p = _both(case)
    _same(j, p)
    assert p[0] == ([(0, n, 1) for n in range(0, NB + 1, 2)], -1)


EX07 = r"""
mydata  [ type = "parsec_data_collection_t*" ]
nodes   [ type = "int" ]
rank    [ type = "int" ]
NB      [ type = "int" ]

TaskBcast(k)

k = 0 .. 0

: mydata( k )

RW  A <- mydata( k )
      -> A TaskRecv( k, 0 .. NB .. 2 )
      -> A TaskUpdate( k )

BODY
{
    *(int*)A = k + 1;
}
END

TaskRecv(k, n)

k = 0 .. 0
n = 0 .. NB .. 2

: mydata( n )

READ A <- A TaskBcast( k )
CTL  ctl -> ctl TaskUpdate( k )

BODY
{
}
END

TaskUpdate(k)

k = 0 .. 0

: mydata( k )

RW  A <- A TaskBcast( k )
      -> mydata( k )
/* the anti-dependency made explicit: the update waits for every read */
CTL ctl <- ctl TaskRecv( k, 0 .. NB .. 2 )

BODY
{
    *(int*)A = -k - 1;
}
END
"""


def test_ex07_raw_ctl_orders_update_after_reads():
    NB = 6

    def case(s):
        V = s.vec(1, 2 * NB, s.i32, 0)
        lock = threading.Lock()
        events = []

        def bcast(A, k):
            A[0] = k + 1

        def recv(A, k, n):
            with lock:
                events.append(("recv", k, n, int(A[0])))

        def update(A, k):
            with lock:
                events.append(("update", k))
            A[0] = -k - 1
        tp = s.jdf.jdf_taskpool(EX07, globals={"nodes": 1, "rank": 0,
                                               "NB": NB},
                                data={"mydata": V},
                                bodies={"TaskBcast": bcast,
                                        "TaskRecv": recv,
                                        "TaskUpdate": update})
        done = s.run(tp)
        upd = events.index(("update", 0))
        reads = [e for e in events if e[0] == "recv"]
        ordered = all(events.index(r) < upd for r in reads)
        home = int(_np(V.data_of(0).pull_to_host().payload)[0])
        return ((sorted(reads), ordered, home),) + done
    j, p = _both(case)
    _same(j, p)
    reads, ordered, home = p[0]
    assert len(reads) == len(range(0, NB + 1, 2)) and ordered
    assert all(r[3] == 1 for r in reads) and home == -1


STENCIL_1D = r"""
extern "C" %{
/* 1D stencil over the tiles of one row: each step reads its left and
   right neighbours' previous values (NULL at the borders) */
#include "parsec/data_dist/matrix/matrix.h"
%}

descA            [ type = "parsec_tiled_matrix_t*" ]
iter             [ type = "int" ]
R                [ type = "int" ]
rank_neighbor    [ type = "int (*)(int)" ]
sizeof_datatype  [ type = "int" ]

task(t, n)

t = 1 .. iter
n = 0 .. %{ return descA->lnt - 1; %}
m = 0

: descA( m, n )

READ AL <- (t > 1 && n > 0) ? A task( t-1, n-1 ) : NULL  [ type_remote = LR displ_remote = %{ return 0; %} ]
READ AR <- (t > 1 && n < descA->lnt - 1) ? A task( t-1, n+1 ) : NULL  [ type_remote = RR ]
READ A0 <- (t > 1) ? A task( t-1, n ) : descA( m, n )
RW   A  <- descA( m, n )
        -> (t < iter) ? A0 task( t+1, n )
        -> (t < iter && n < descA->lnt - 1) ? AL task( t+1, n+1 )
        -> (t < iter && n > 0) ? AR task( t+1, n-1 )

BODY
{
    CORE_stencil_1D(AL, AR, A0, A, R, descA->mb, sizeof_datatype);
}
END
"""


class _DescAdapter:
    """Reference-style tiled-matrix handle (descA->lnt etc.) over a
    VectorTwoDimCyclic, for JDFs written against parsec_tiled_matrix_t."""

    def __init__(self, V, lnt):
        import types
        self._V = V
        self.lmt = 1
        self.lnt = lnt
        self.mb = V.mb
        self.nb = V.mb
        self.ln = V.lm
        self.super = types.SimpleNamespace(myrank=0)   # descA->super.myrank

    def __call__(self, m, n):
        return self._V(n)


def test_stencil_1d_jdf_parses_and_builds():
    """Guards, NULL endpoints, a derived local, an inline-C range bound
    and type_remote/displ annotations parse and build; the inline-C body
    raises a clear error when it runs."""
    ast = {side: SIDES[side][2].parse_jdf(STENCIL_1D) for side in SIDES}
    for tree in ast.values():
        t = next(tt for tt in tree.tasks if tt.name == "task")
        assert [f.name for f in t.flows] == ["AL", "AR", "A0", "A"]
        assert sum(len(f.deps) for f in t.flows) == 7

    def case(s):
        desc = _DescAdapter(s.vec(4, 16), lnt=4)
        tp = s.jdf.jdf_taskpool(STENCIL_1D,
                                globals={"descA": desc, "iter": 1, "R": 1,
                                         "rank_neighbor": lambda *a: 0,
                                         "sizeof_datatype": 8},
                                data={"descA": desc}, name="stencil1d")
        classes = set(tp.task_classes)
        err = s.run(tp, expect_error=True)
        return classes, str(err.__cause__)
    (jc, je), (pc, pe) = _both(case)
    assert pc == jc == {"task"}
    assert "inline-C body" in pe and "inline-C body" in je


MULTICHAIN = r"""
extern "C" %{
/* two task classes chained horizontally and vertically over two
   block-cyclic matrices */
%}

descA  [ type = "parsec_tiled_matrix_t*" ]
descB  [ type = "parsec_tiled_matrix_t*" ]
NI     [ type = "int" ]
NJ     [ type = "int" ]

HORIZONTAL(i)

i = 0 .. NI-1

: descA( i, 0 )

READ A <- descA( i, 0 )
RW   B <- (i == 0) ? descB( 0, 0 ) : B HORIZONTAL( i-1 )
       -> (i < NI-1) ? B HORIZONTAL( i+1 )
       -> B VERTICAL( i, 0 )

BODY
{
}
END

VERTICAL(i, j)

i = 0 .. NI-1
j = 0 .. NJ-1

: descB( i, 0 )

READ A <- descA( i, 0 )
RW   B <- (j == 0) ? B HORIZONTAL( i ) : B VERTICAL( i, j-1 )
       -> (j < NJ-1) ? B VERTICAL( i, j+1 ) : descB( i, 0 )

BODY
{
}
END
"""


def test_multichain_parses_and_runs():
    NI, NJ, mb = 4, 3, 2

    def case(s):
        A = s.mat.TwoDimBlockCyclic(mb=mb, nb=1, lm=mb * NI, ln=1,
                                    name="descA")
        B = s.mat.TwoDimBlockCyclic(mb=mb, nb=1, lm=mb * NI, ln=1,
                                    name="descB")
        for M in (A, B):
            for m, n in M.local_tiles():
                M.data_of(m, n).copy_on(0).payload[:] = 0.0

        def horizontal(A, B, i):
            B[:] = B + 1.0

        def vertical(A, B, i, j):
            B[:] = B + 1.0
        tp = s.jdf.jdf_taskpool(MULTICHAIN, globals={"NI": NI, "NJ": NJ},
                                data={"descA": A, "descB": B},
                                bodies={"HORIZONTAL": horizontal,
                                        "VERTICAL": vertical})
        done = s.run(tp)
        out = [_np(B.data_of(i, 0).pull_to_host().payload).tolist()
               for i in range(NI)]
        return (out,) + done
    j, p = _both(case)
    _same(j, p)
    assert p[1] == {"HORIZONTAL": NI, "VERTICAL": NI * NJ}
    # tile i rode i+1 HORIZONTAL steps, then its NJ VERTICAL steps
    assert p[0] == [[[float(i + 1 + NJ)]] * mb for i in range(NI)]


def test_jdf_error_reporting():
    for side, (_c, mat, jdf, _k, _i, _f) in SIDES.items():
        with pytest.raises(jdf.JdfError, match="subset"):
            jdf.jdf_taskpool(
                "T(k)\nk = 0 .. %{ while (x) x--; return x; %}\n"
                ": d( k )\nBODY\n{}\nEND\n",
                data={"d": mat.VectorTwoDimCyclic(mb=1, lm=1)})
        with pytest.raises(jdf.JdfError, match="no range"):
            jdf.jdf_taskpool("T(k)\n: d( k )\nBODY\n{}\nEND\n",
                             data={"d": mat.VectorTwoDimCyclic(mb=1,
                                                               lm=1)})


def test_inline_c_statement_subset():
    """Declarations, assignments and a final return translate to one
    Python expression, the same in both packages."""
    src = "%{ int r = k + 1; r = r * 2; return r + n; %}"
    assert port_jdf.c2py(src) == jax_jdf.c2py(src)
    assert eval(port_jdf.c2py(src), {"k": 3, "n": 10}) == 18
    with pytest.raises(port_jdf.JdfError):
        port_jdf.c2py("%{ for (i = 0; i < 3; i++) x += i; return x; %}")


def test_inline_c_integer_division():
    """C '/' and '%' on integral operands keep C truncation; floats keep
    true division."""
    ns = dict(port_jdf.C_EVAL_HELPERS)
    cases = [("%{ int r = k / 2; return r; %}", {"k": 3}, 1),
             ("k / 2", {"k": 7}, 3), ("(0 - 7) / 2", {}, -3),
             ("(0 - 7) % 2", {}, -1), ("k / 2.0", {"k": 7}, 3.5),
             ("%{ int r = k; r /= 2; return r; %}", {"k": 9}, 4)]
    for expr, env, want in cases:
        assert port_jdf.c2py(expr) == jax_jdf.c2py(expr)
        assert eval(port_jdf.c2py(expr), {**ns, **env}) == want
    # a torch integer (a tensor element read by a body) is integral too
    assert port_jdf._c_div(torch.tensor(7).item(), 2) == 3


# -- the hard corpus (twins of tests/test_jdf_hard_corpus.py) -----------------

def test_option_and_multiline_task_props_parse():
    text = """
%option dynamic = ON
%option no_taskpool_instance = true

T (k) [ make_key_fn = mk
        startup_fn = su ]
  k = 0 .. 3
  d = k + 1
: A(k)
CTL C -> (d > 1) ? C T(k+1)
BODY
END
"""
    for jdf in (jax_jdf, port_jdf):
        tree = jdf.parse_jdf(text)
        assert tree.options == {"dynamic": "ON",
                                "no_taskpool_instance": "true"}
        t = tree.tasks[0]
        assert t.props == {"make_key_fn": "mk", "startup_fn": "su"}
        assert [d[:2] for d in t.defs] == [("range", "k"), ("local", "d")]


def test_kview_permutation_matches_reference_formula():
    """kview_compute_m/n (two_dim_rectangle_cyclic.c:441-463) on a 2x2
    grid with kp=kq=2, in both packages."""
    def ref_perm(x, p, ps, xt):
        while True:
            x = x - x % (p * ps) + (x % ps) * p + (x // ps) % p
            if x < xt:
                return x
    views = []
    for mat in (jax_matrix, port_matrix):
        A = mat.TwoDimBlockCyclic(mb=2, nb=2, lm=16, ln=16, nodes=4,
                                  myrank=0, P=2, name="dA")
        V = mat.block_cyclic_kview(A, 2, 2)
        assert [V._pm(m) for m in range(A.mt)] == \
            [ref_perm(m, 2, 2, A.mt) for m in range(A.mt)]
        assert sorted(V._pn(n) for n in range(A.nt)) == list(range(A.nt))
        views.append([(V.data_key(m, n), V.rank_of(m, n))
                      for m in range(A.mt) for n in range(A.nt)])
    assert views[0] == views[1]


def test_kcyclic_jdf_golden_4ranks():
    j, p = W.run_both(W.jdf_kcyclic, 4, timeout=T_RUN)
    for rj, rp in zip(j, p):
        assert rp["errors"] == rj["errors"] == []
        assert rp["hidden"] == rj["hidden"] == (3, 3)   # dA->super.mt-1
        assert rp["done"] == rj["done"]
        assert rp["pool"] == rj["pool"] == (0, 0)
        assert rp["termdet"] == rj["termdet"]
    assert sum(sum(r["done"].values()) for r in p) == 4 * 16


#: NT values decomposed into power-of-two binomial trees reduced in
#: parallel (BT_REDUC), then a linear pass chaining the tree roots
#: (LINEAR_REDUC).  Derived locals sit BETWEEN ranges and feed the later
#: bounds, and inline C calls the prologue's helper functions.
BT_REDUCTION = r"""
extern "C" %{
/* generalized binomial-tree reduction: helpers count_bits,
   log_of_tree_size, index_to_tree, global_to_local_index and
   compute_offset are defined in this prologue in C */
%}

dataA  [ type = "parsec_tiled_matrix_t*" ]
NT     [ type = "int" ]
NB     [ type = "int" ]

REDUCTION(i)
  i  = 0 .. NT-1
  t  = %{ return index_to_tree(NT, i); %}
  li = %{ return global_to_local_index(NT, i); %}
  sz = %{ return log_of_tree_size(NT, t); %}
: dataA( i, 0 )
RW  A <- dataA( i, 0 )
      -> (sz > 0 && li % 2 == 0) ? A BT_REDUC( t, 1, li/2 )
      -> (sz > 0 && li % 2 == 1) ? B BT_REDUC( t, 1, li/2 )
      -> (sz == 0 && t == count_bits(NT)) ? C LINEAR_REDUC( t )
      -> (sz == 0 && t != count_bits(NT)) ? B LINEAR_REDUC( t )
BODY
{
}
END

BT_REDUC(t, s, i)
  t  = 1 .. %{ return count_bits(NT); %}
  sz = %{ return log_of_tree_size(NT, t); %}
  s  = 1 .. sz
  i  = 0 .. %{ return (1 << (sz - s)) - 1; %}
  offset = %{ return compute_offset(NT, t); %}
: dataA( offset + i * (1 << s), 0 )
READ A <- (s == 1) ? A REDUCTION( offset + 2*i ) : B BT_REDUC( t, s-1, 2*i )
RW   B <- (s == 1) ? A REDUCTION( offset + 2*i + 1 ) : B BT_REDUC( t, s-1, 2*i+1 )
       -> (s < sz && i % 2 == 0) ? A BT_REDUC( t, s+1, i/2 )
       -> (s < sz && i % 2 == 1) ? B BT_REDUC( t, s+1, i/2 )
       -> (s == sz && t == count_bits(NT)) ? C LINEAR_REDUC( t )
       -> (s == sz && t != count_bits(NT)) ? B LINEAR_REDUC( t )
BODY
{
}
END

LINEAR_REDUC(i)
  i  = 1 .. %{ return count_bits(NT); %}
  tree_count = %{ return count_bits(NT); %}
  sz = %{ return log_of_tree_size(NT, i); %}
  offset = %{ return compute_offset(NT, i); %}
: dataA( offset, 0 )
READ B <- (i == tree_count) ? NULL
       <- (i != tree_count && sz > 0) ? B BT_REDUC( i, sz, 0 )
       <- (i != tree_count && sz == 0) ? A REDUCTION( offset )
RW   C <- (i == tree_count && sz > 0) ? B BT_REDUC( i, sz, 0 )
       <- (i == tree_count && sz == 0) ? A REDUCTION( offset )
       <- (i != tree_count) ? C LINEAR_REDUC( i+1 )
       -> (i > 1) ? C LINEAR_REDUC( i-1 )
CTL  ctl -> (i == 1) ? ctl LINE_TERMINATOR( 0 )
BODY
{
}
END

LINE_TERMINATOR(k)
  k = 0 .. 0
: dataA( 0, 0 )
CTL  ctl <- ctl LINEAR_REDUC( 1 )
BODY
{
}
END
"""


def _count_bits(N):
    return bin(N).count("1")


def _log_of_tree_size(N, t):
    cnt = 0
    for i in range(32):
        if (1 << i) & N:
            cnt += 1
        if cnt == t:
            return i
    raise AssertionError(N)


def _index_to_tree(N, idx):
    cnt = 0
    for i in range(32):
        if (1 << i) & N:
            cnt += 1
            if idx < (1 << i):
                return cnt
            idx -= 1 << i
    raise AssertionError(N)


def _global_to_local_index(N, idx):
    for i in range(32):
        if (1 << i) & N:
            if idx < (1 << i):
                return idx
            idx -= 1 << i
    raise AssertionError(N)


def _compute_offset(N, t):
    cnt, offset = 0, 0
    for i in range(32):
        if (1 << i) & N:
            cnt += 1
        if cnt == t:
            return offset
        if (1 << i) & N:
            offset += 1 << i
    raise AssertionError(N)


@pytest.mark.parametrize("NT", [5, 7])
def test_bt_reduction_jdf_golden(NT):
    NB = 4

    def case(s):
        dataA = s.mat.TwoDimBlockCyclic(mb=1, nb=NB, lm=NT, ln=NB,
                                        dtype=s.i32, name="dataA")
        result = []

        def reduction(A, i):
            A[:] = i

        def bt_reduc(A, B):
            B += A

        def linear_reduc(B, C, i, tree_count):
            if tree_count != i and B is not None:
                C += B
            if i == 1:
                result.append(_np(C).copy().tolist())

        tp = s.jdf.jdf_taskpool(
            BT_REDUCTION,
            globals={"NT": NT, "NB": NB, "count_bits": _count_bits,
                     "log_of_tree_size": _log_of_tree_size,
                     "index_to_tree": _index_to_tree,
                     "global_to_local_index": _global_to_local_index,
                     "compute_offset": _compute_offset},
            data={"dataA": dataA},
            bodies={"REDUCTION": reduction, "BT_REDUC": bt_reduc,
                    "LINEAR_REDUC": linear_reduc,
                    "LINE_TERMINATOR": lambda: None})
        return (result,) + s.run(tp)
    j, p = _both(case)
    _same(j, p)
    assert p[0] == [[[sum(range(NT))] * NB]]
    assert p[1]["REDUCTION"] == NT and p[1]["LINE_TERMINATOR"] == 1


def test_project_dyn_jdf_dynamic_termdet():
    """%option dynamic = ON: a startup_fn seeds PROJECT(0, 0), each task
    decides at runtime whether to spawn its two children, and the pool
    terminates by dynamic task counting."""
    res = []
    for side in ("jax", "port"):
        s = _Side(side)
        with s.ctx_mod.Context(nb_cores=2, **s.kw) as ctx:
            res.append(W.project_dyn(ctx, 0, 1, side))
    j, p = res
    assert p["pool_class"] == j["pool_class"] == "DynamicTaskpool"
    for key in ("executed", "pruned", "root", "done", "pool"):
        assert p[key] == j[key], key
    NMIN = 4
    executed, pruned = set(p["executed"]), set(p["pruned"])
    assert len(executed) >= 2 ** (NMIN + 1) - 1 and pruned
    assert len(executed) < 4096
    assert max(n for n, _ in executed) > NMIN
    for (n, l) in executed:
        if n:
            assert (n - 1, l // 2) in executed
    for (n, l) in pruned:
        assert (n + 1, 2 * l) not in executed
    assert p["root"][0] != 0.0


def test_project_dyn_distributed_dynamic_termdet():
    """Seeded only on rank 0: every task on rank 1 arrives by remote
    discovery (the distributed dynamic termdet's pool-scoped hold)."""
    j, p = W.run_both(W.project_dyn, 2, timeout=T_RUN)
    for rj, rp in zip(j, p):
        for key in ("executed", "pruned", "done", "pool", "termdet"):
            assert rp[key] == rj[key], key
    assert sum(len(r["executed"]) for r in p) >= 2 ** 5 - 1
    assert all(r["executed"] for r in p)
