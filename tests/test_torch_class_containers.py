"""The port's base containers against the JAX package's.

Twins of tests/test_class_containers.py (reference: tests/class/{lifo,
list,hash,atomics,rwlock,future,future_datacopy}.c): each case runs the
same operations on both packages' containers and compares what they
observe — pop orders, values, counts — and holds each to the reference
test's invariants.  The multithreaded cases run the same thread counts
on both; their outcomes are the counts and agreements the reference
asserts, not orders (threads interleave differently run to run).
"""

import threading
import types

import pytest

import parsec_tpu.containers.futures as jax_futures
import parsec_tpu.containers.hash_table as jax_hash
import parsec_tpu.containers.lists as jax_lists
import parsec_tpu.containers.sync as jax_sync
import parsec_tpu_torch.containers.futures as port_futures
import parsec_tpu_torch.containers.hash_table as port_hash
import parsec_tpu_torch.containers.lists as port_lists
import parsec_tpu_torch.containers.sync as port_sync

NTHREADS = 8
NITEMS = 2000


def _ns(lists, hash_table, futures, sync):
    return types.SimpleNamespace(
        Dequeue=lists.Dequeue, Fifo=lists.Fifo, Lifo=lists.Lifo,
        OrderedList=lists.OrderedList, HBBuffer=lists.HBBuffer,
        ConcurrentHashTable=hash_table.ConcurrentHashTable,
        Future=futures.Future, CountdownFuture=futures.CountdownFuture,
        DataCopyFuture=futures.DataCopyFuture,
        AtomicCounter=sync.AtomicCounter, Barrier=sync.Barrier,
        RWLock=sync.RWLock)


PKGS = {"jax": _ns(jax_lists, jax_hash, jax_futures, jax_sync),
        "port": _ns(port_lists, port_hash, port_futures, port_sync)}


def both(fn):
    """``fn`` on each package's containers: (jax result, port result),
    which must be equal."""
    ref, got = fn(PKGS["jax"]), fn(PKGS["port"])
    assert got == ref, (got, ref)
    return got


def run_threads(n, fn):
    threads = [threading.Thread(target=fn, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


class Item:
    def __init__(self, value, priority=0):
        self.value = value
        self.priority = priority


def test_lifo_order():
    def run(C):
        s = C.Lifo()
        for i in range(10):
            s.push(i)
        out = [s.pop() for _ in range(10)]
        return out, s.pop(), s.is_empty()
    assert both(run) == (list(range(9, -1, -1)), None, True)


def test_fifo_order():
    def run(C):
        q = C.Fifo()
        q.push_chain(range(10))
        return [q.pop() for _ in range(10)], q.pop()
    assert both(run) == (list(range(10)), None)


def test_dequeue_both_ends():
    def run(C):
        d = C.Dequeue()
        d.push_back(1)
        d.push_front(0)
        d.push_back(2)
        return [d.pop_front(), d.pop_back(), d.pop_back(), d.pop_back()]
    assert both(run) == [0, 2, 1, None]


def test_ordered_list_priority():
    def run(C):
        lst = C.OrderedList()
        for v, p in (("lo", 1), ("hi", 10), ("mid", 5)):
            lst.push_sorted(Item(v, p))
        return [lst.pop_front().value for _ in range(3)]
    assert both(run) == ["hi", "mid", "lo"]


@pytest.mark.parametrize("kind", ["Lifo", "Fifo"])
def test_queue_mt_stress(kind):
    """Every pushed item is popped exactly once (reference
    tests/class/lifo.c)."""
    def run(C):
        q = getattr(C, kind)()
        seen = [set() for _ in range(NTHREADS)]

        def worker(tid):
            for i in range(NITEMS):
                q.push((tid, i))
            while True:
                got = q.pop()
                if got is None:
                    break
                seen[tid].add(got)

        run_threads(NTHREADS, worker)
        while True:
            got = q.pop()
            if got is None:
                break
            seen[0].add(got)
        return len(set().union(*seen))
    assert both(run) == NTHREADS * NITEMS


def test_hash_table_basics():
    def run(C):
        h = C.ConcurrentHashTable()
        h.insert(("tc", 1, 2), "v")
        out = [h.find(("tc", 1, 2)), ("tc", 1, 2) in h,
               h.remove(("tc", 1, 2)), h.find(("tc", 1, 2))]
        v, ins = h.find_or_insert("k", lambda: [0])
        v2, ins2 = h.find_or_insert("k", lambda: [1])
        return out, ins, v, ins2, v2 is v
    assert both(run) == (["v", True, "v", None], True, [0], False, True)


def test_hash_table_mt():
    """Concurrent find_or_insert yields exactly one value per key."""
    def run(C):
        h = C.ConcurrentHashTable()
        winners = [[] for _ in range(NTHREADS)]

        def worker(tid):
            for i in range(NITEMS):
                v, _ins = h.find_or_insert(i % 101, lambda: object())
                winners[tid].append(v)

        run_threads(NTHREADS, worker)
        return [len({winners[t][j] for t in range(NTHREADS)
                     for j in range(i, NITEMS, 101)}) for i in range(101)]
    assert both(run) == [1] * 101


def test_hash_update_locked():
    def run(C):
        h = C.ConcurrentHashTable()

        def worker(tid):
            for _ in range(NITEMS):
                h.update_locked("ctr", lambda v: v + 1, default=0)

        run_threads(NTHREADS, worker)
        return h.find("ctr")
    assert both(run) == NTHREADS * NITEMS


def test_atomic_counter_mt():
    def run(C):
        c = C.AtomicCounter()

        def worker(tid):
            for _ in range(NITEMS):
                c.add_and_fetch(1)

        run_threads(NTHREADS, worker)
        total = c.value
        return (total, c.cas(total, 0), c.cas(123456, 1), c.value,
                c.fetch_add(5), c.sub_and_fetch(2), c.fetch_sub(1),
                c.value)
    assert both(run) == (NTHREADS * NITEMS, True, False, 0, 0, 3, 3, 2)


def test_future_basic_and_callbacks():
    def run(C):
        f = C.Future()
        hits = []
        f.on_ready(hits.append)
        before = f.is_ready()
        f.set(42)
        f.on_ready(hits.append)   # post-completion: fires immediately
        with pytest.raises(RuntimeError):
            f.set(1)
        return before, f.is_ready(), f.get(), hits
    assert both(run) == (False, True, 42, [42, 42])


def test_future_blocking_get():
    def run(C):
        f = C.Future()
        t = threading.Timer(0.05, lambda: f.set("done"))
        t.start()
        got = f.get(timeout=5)
        t.join()
        return got
    assert both(run) == "done"


def test_countdown_future():
    def run(C):
        f = C.CountdownFuture(3, "fin")
        f.contribute()
        f.contribute()
        before = f.is_ready()
        f.contribute()
        return before, f.get()
    assert both(run) == (False, "fin")


def test_datacopy_future_triggers_once():
    """Reference tests/class/future_datacopy.c: one materialization,
    shared."""
    def run(C):
        calls = []
        fut = C.DataCopyFuture(
            trigger=lambda spec: calls.append(spec) or spec * 2, spec=21,
            nb_consumers=NTHREADS)
        results = []
        lock = threading.Lock()

        def worker(tid):
            v = fut.get_copy()
            with lock:
                results.append(v)
            fut.consume()

        run_threads(NTHREADS, worker)
        return calls, results
    assert both(run) == ([21], [42] * NTHREADS)


def test_datacopy_future_cleanup_on_last_consumer():
    def run(C):
        released = []
        fut = C.DataCopyFuture(trigger=lambda s: "copy", nb_consumers=2,
                               cleanup=released.append)
        got = fut.get_copy()
        fut.consume()
        mid = list(released)
        fut.consume()
        return got, mid, released
    assert both(run) == ("copy", [], ["copy"])


def test_rwlock():
    def run(C):
        rw = C.RWLock()
        state = {"readers": 0, "max_readers": 0, "writes": 0,
                 "overlaps": 0}
        mx = threading.Lock()

        def reader(tid):
            for _ in range(200):
                with rw.read():
                    with mx:
                        state["readers"] += 1
                        state["max_readers"] = max(state["max_readers"],
                                                   state["readers"])
                    with mx:
                        state["readers"] -= 1

        def writer(tid):
            for _ in range(50):
                with rw.write():
                    if state["readers"]:
                        state["overlaps"] += 1
                    state["writes"] += 1

        threads = ([threading.Thread(target=reader, args=(i,))
                    for i in range(4)]
                   + [threading.Thread(target=writer, args=(i,))
                      for i in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return state["writes"], state["overlaps"], state["max_readers"] >= 1
    assert both(run) == (100, 0, True)


def test_barrier():
    def run(C):
        b = C.Barrier(NTHREADS)
        order = []
        lock = threading.Lock()

        def worker(tid):
            with lock:
                order.append(("pre", tid))
            b.wait()
            with lock:
                order.append(("post", tid))

        run_threads(NTHREADS, worker)
        pres = [i for i, (p, _) in enumerate(order) if p == "pre"]
        posts = [i for i, (p, _) in enumerate(order) if p == "post"]
        return max(pres) < min(posts), len(order)
    assert both(run) == (True, 2 * NTHREADS)


def test_dequeue_chain_front_preserves_order():
    def run(C):
        d = C.Dequeue()
        d.push_back("tail")
        d.chain_front(["a", "b", "c"])
        return [d.pop_front() for _ in range(4)]
    assert both(run) == ["a", "b", "c", "tail"]


def test_ordered_list_mixed_modes_no_inversion():
    def run(C):
        lst = C.OrderedList()
        lst.push_back(Item("p10", 10))
        lst.push_front(Item("p1", 1))
        lst.push_sorted(Item("p5", 5))
        vals = [lst.pop_front().value for _ in range(3)]
        return vals.index("p5") < vals.index("p1")
    assert both(run) is True


def test_hbbuffer_overflow_chain():
    """reference: parsec/hbbuffer.c — bounded pushes overflow to the
    parent store; pops drain local then parent; steal stays local."""
    def run(C):
        system = C.Dequeue()
        group = C.HBBuffer(capacity=2, parent=system)
        local = C.HBBuffer(capacity=2, parent=group)
        for i in range(7):
            local.push_back(i)
        sizes = (len(local), len(group), len(system))
        drained = [local.pop_front() for _ in range(8)]
        local.push_back("a")
        group.push_back("g")
        steal = [local.pop_back(), local.pop_back(), len(group)]
        lone = C.HBBuffer(capacity=1)
        lone.push_back(1)
        with pytest.raises(OverflowError):
            lone.push_back(2)
        return sizes, drained, steal
    assert both(run) == ((2, 2, 3), list(range(7)) + [None],
                         ["a", None, 1])
