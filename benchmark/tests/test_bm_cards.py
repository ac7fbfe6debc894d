"""A cell of several cards: the narrowing of what CUDA shows a run, the peak
floor, the trace reduced card by card, counters summed over the device
modules, and (on a host with four cards) a four-card cell end to end."""

import gzip
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import cards, readers, spec
from benchmark import trace as tr
from benchmark.harness import run_cell
from benchmark.tests.tiny import GEMM, POTRF, tiny_cell
from benchmark.window import Pass, check_peak

K1 = "void gemm_tile_wgmma_kernel<__nv_bfloat16, 8>(WgArgs<__nv_bfloat16, 8>)"
LIBRARY = ("void cusolver_potrf_kernel<float>(int, float*)",
           "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8",
           "void at::native::elementwise_kernel<128, 4>(int)")


# -- narrowing -----------------------------------------------------------------

@pytest.mark.parametrize("chips, found, shown", [
    (1, None, "0"), (4, None, "0,1,2,3"),
    (1, "3,1", "3"), (4, "2, 5,6,7,0", "2,5,6,7"), (4, "1", "1"),
    (1, "GPU-8a1b,GPU-77c2", "GPU-8a1b"), (1, "", "")])
def test_a_run_sees_the_first_cards_it_would_see(chips, found, shown):
    assert cards.visible(chips, found) == shown
    env = {} if found is None else {cards.ENV: found}
    assert cards.narrow(chips, env) == shown and env[cards.ENV] == shown


def test_a_cell_needs_a_card():
    with pytest.raises(ValueError):
        cards.visible(0, None)


#: starts ``benchmark.run`` on a cell, stops it once it has narrowed what
#: CUDA shows, and prints that and whether torch was loaded by then
NARROWED = """import os, sys
import benchmark.cards as c
real, loaded = c.narrow, []
class Narrowed(Exception):
    pass
def narrow(chips, *a):
    loaded.append('torch' in sys.modules)
    real(chips, *a)
    raise Narrowed
c.narrow = narrow
import benchmark.run as r
try:
    r.main(['--workload', sys.argv[1], '--seed', '1', '--seconds', '1'])
except Narrowed:
    pass
print(os.environ['CUDA_VISIBLE_DEVICES'], loaded)
"""


@pytest.mark.parametrize("found, shown", [("0,1,2,3", "0"), (None, "0"),
                                          ("2,3", "2")])
def test_the_run_narrows_before_torch_is_loaded(found, shown):
    """A one-chip cell on a host of four sees one card: ``benchmark.run``
    narrows what CUDA shows the process before it loads torch."""
    env = {k: v for k, v in os.environ.items() if k != cards.ENV}
    if found is not None:
        env[cards.ENV] = found
    out = subprocess.run([sys.executable, "-c", NARROWED, GEMM],
                         cwd=spec.ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == f"{shown} [False]"


# -- the peak floor ------------------------------------------------------------

def test_the_peak_floor_scales_with_the_cards():
    flops, peak = 2.53e15, 989e12
    one = flops / peak                         # 2.558 s on one card
    check_peak(Pass(0.0, one, False), flops, peak, 1)
    check_peak(Pass(0.0, one, False), flops, peak)
    with pytest.raises(RuntimeError):
        check_peak(Pass(0.0, 0.87 * one, False), flops, peak, 1)
    # four cards that scale well: under one card's floor, over four's
    check_peak(Pass(0.0, 0.87 * one, False), flops, peak, 4)
    check_peak(Pass(0.0, one / 4, False), flops, peak, 4)
    with pytest.raises(RuntimeError):
        check_peak(Pass(0.0, 0.99 * one / 4, False), flops, peak, 4)


# -- the trace, card by card ---------------------------------------------------

def _ev(name, cat, ts, dur, card):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": card, "tid": 7, "args": {"device": card, "stream": 7}}


def _spans():
    return [("bm.pass", 100, 200), ("bm.restore", 100, 110),
            ("bm.wait", 110, 195), ("bm.pass", 200, 300),
            ("bm.wait", 200, 300)]


def _four_cards():
    """Card 0 as in the one-card test of test_bm_harness; card 1 busy
    120-190 with a library kernel and a copy to another card; card 2 busy
    100-300 with K1; card 3 idle in the window."""
    events = [
        _ev(K1, "kernel", 120, 30, 0),
        _ev(LIBRARY[2], "kernel", 140, 20, 0),
        _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 102, 6, 0),
        _ev(LIBRARY[0], "kernel", 250, 40, 0),
        _ev(LIBRARY[1], "kernel", 120, 60, 1),
        _ev("Memcpy PtoP (Device -> Device)", "gpu_memcpy", 150, 40, 1),
        _ev(K1, "kernel", 100, 200, 2),
        _ev(K1, "kernel", 400, 50, 3),          # outside the window
    ]
    return events, _spans()


def test_one_card_and_the_union_agree():
    events, spans = _four_cards()
    one = [e for e in events if e["pid"] == 0]
    s = tr.summarize(one, spans)
    assert list(s.cards) == [0]
    assert s.busy_s_by_card == [pytest.approx(86e-6)]
    assert s.busy_s == tr.total(s.busy) * 1e-6
    assert [n for n, _ in tr.top_gaps(s)][0] == "bm.wait"
    assert not any(n.startswith("cuda:") for n, _ in tr.top_gaps(s))


def test_four_cards_are_read_card_by_card():
    s = tr.summarize(*_four_cards(), cards=4)
    assert list(s.cards) == [0, 1, 2, 3]
    # busy: card 0 86 us, card 1 120-190 = 70, card 2 200, card 3 none
    assert s.busy_s_by_card == pytest.approx([86e-6, 70e-6, 200e-6, 0.0])
    assert s.busy_s == pytest.approx(356e-6 / 4)
    obs = readers.Observation(problem=None, setup_s=1.0, trace=s)
    assert readers.device_idle(obs) == pytest.approx(
        100 * (1 - 356 / 4 / 200))
    # library time card by card: card 0 60 us, card 1 60 us; of 356 busy
    assert readers.library_share(obs) == pytest.approx(100 * 120 / 356)
    gaps = tr.top_gaps(s)
    # card 3 idle the whole window, card 1 idle 190-300 and 100-120
    assert gaps[0] == ["cuda:3 bm.wait", pytest.approx(200e-6)]
    assert gaps[1] == ["cuda:1 bm.wait", pytest.approx(110e-6)]
    assert all(n.split()[0] in ("cuda:0", "cuda:1", "cuda:3")
               for n, _ in gaps)
    # the union of all cards is what the program-span readers take
    assert tr.total(s.busy) == pytest.approx(200.0)


def test_the_card_of_an_operation():
    assert tr.card_of({"args": {"device": 2}, "pid": 2}) == 2
    assert tr.card_of({"pid": 3}) == 3
    # a copy between cards, as the profiler writes it on four H100s
    assert tr.card_of({"pid": 1, "args": {"fromDevice": 1, "toDevice": 2,
                                          "bytes": 4096}}) == 1
    assert tr.card_of({"args": {"device": 1}, "pid": "Spans"}) == 1
    assert tr.card_of({"pid": "Traces"}) == 0
    assert tr.card_of({}) == 0


def _recorded(seed=20240611, passes=6):
    """A one-card window as the profiler writes it: passes of stages, and
    device operations on two streams that overlap, with K1, library
    kernels, copies and fills, some reaching past the window."""
    rnd = random.Random(seed)
    spans, events, t = [], [], 1000.0
    names = [(K1, "kernel")] * 4 + [(n, "kernel") for n in LIBRARY] + [
        ("Memcpy DtoD (Device -> Device)", "gpu_memcpy"),
        ("Memset (Device)", "gpu_memset")]
    for _ in range(passes):
        start = t
        for stage in ("bm.collect", "bm.restore", "bm.build_pool",
                      "bm.add_taskpool", "bm.wait", "bm.synchronize"):
            d = rnd.uniform(5.0, 40.0) if stage != "bm.wait" else \
                rnd.uniform(2000.0, 4000.0)
            spans.append((stage, t, t + d))
            if stage in ("bm.restore", "bm.wait"):
                at = t + rnd.uniform(0.0, 3.0)
                while at < t + d:
                    name, cat = rnd.choice(names)
                    dur = rnd.uniform(0.5, 120.0)
                    events.append(_ev(name, cat, round(at, 3), round(dur, 3),
                                      0))
                    if rnd.random() < 0.2:         # a second stream
                        name, cat = rnd.choice(names)
                        events.append(_ev(name, cat, round(at + dur / 3, 3),
                                          round(rnd.uniform(1.0, 60.0), 3),
                                          0))
                    at += dur + rnd.expovariate(1 / 8.0)
            t += d
        spans.append(("bm.pass", start, t))
        t += rnd.uniform(1.0, 4.0)
    events.append(_ev(K1, "kernel", 990.0, 25.0, 0))    # into the window
    events.append({"ph": "X", "name": "aten::mm", "cat": "cpu_op",
                   "ts": 1500.0, "dur": 9.0, "pid": 4242, "tid": 1})
    return events, spans


#: what the reduction that kept no cards apart read on each one-card window
BEFORE = {
    "synthetic": {
        "busy_s": 0.01445475624633593,
        "window_s": 0.01656410824633592,
        "device_idle": 12.734473650077671,
        "library_share": 38.86428040890712,
        "k1_roofline": 0.6833961181167092,
        "top_gaps": [["bm.collect", 5.750700000000006e-05],
                     ["bm.wait", 4.6445000000001525e-05],
                     ["bm.collect", 4.488600000000042e-05],
                     ["bm.add_taskpool", 4.255799999999999e-05],
                     ["bm.wait", 4.13650000000016e-05],
                     ["bm.wait", 4.033599999999933e-05],
                     ["bm.wait", 3.874299999999994e-05],
                     ["bm.wait", 3.184099999999853e-05],
                     ["bm.wait", 2.8492000000000187e-05],
                     ["bm.wait", 2.7894999999998617e-05]],
        "top_ops": [
            ["gemm_tile_wgmma_kernel", 0.006595459999999998],
            ["sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8",
             0.0022135100000000006],
            ["Memset ", 0.002051219],
            ["at::native::elementwise_kernel", 0.0018044669999999993],
            ["cusolver_potrf_kernel", 0.001774548],
            ["Memcpy DtoD ", 0.001482262]],
    },
    # the GEMM cell's traced passes on an NVIDIA H100 80GB HBM3 (700 W),
    # its device operations as the profiler wrote them
    "recorded": {
        "busy_s": 3.9767518920898435,
        "window_s": 4.011905929931641,
        "device_idle": 0.8762428246266496,
        "library_share": 0.0,
        "k1_roofline": 65.67752414598229,
        "top_gaps": [["bm.collect", 0.0030188037109375],
                     ["bm.collect", 0.002974931884765625],
                     ["bm.collect", 0.002845395263671875],
                     ["bm.collect", 0.00212225390625],
                     ["bm.collect", 0.0017868288574218749],
                     ["bm.collect", 0.0017364279785156249],
                     ["bm.collect", 0.00173018798828125],
                     ["bm.collect", 0.001688587158203125],
                     ["bm.restore", 0.0015295458984375],
                     ["bm.collect", 0.001528651123046875]],
        "top_ops": [["anon::gemm_tile_wgmma_kernel", 3.907658846000001],
                    ["Memcpy DtoD ", 0.06909304599999998]],
    },
}

RECORDED = Path(__file__).resolve().parent / "data" / \
    "gemm_one_card_trace.json.gz"


class _K1Problem:
    k1_dtype = "bfloat16"

    def k1_tasks_per_pass(self):
        return {"GEMM": 3}

    def k1_work(self, cls):
        return 2.0 * 1024 ** 3, 4.0 * 1024 * 1024 * 2


def _window(kind):
    """(events, spans, problem) of a one-card window."""
    if kind == "synthetic":
        return (*_recorded(), _K1Problem())
    with gzip.open(RECORDED) as f:
        doc = json.load(f)
    cell = spec.load_cell(GEMM)
    problem = spec.problem_module(cell.problem).Problem(
        cell.config, cell.traffic, 1, "cpu")
    return doc["events"], [tuple(s) for s in doc["spans"]], problem


@pytest.mark.parametrize("kind", sorted(BEFORE))
def test_one_card_reads_as_before_to_the_last_bit(kind):
    events, spans, problem = _window(kind)
    s = tr.summarize(events, spans)
    obs = readers.Observation(problem=problem, setup_s=1.0, trace=s,
                              peaks={"bfloat16": 989e12, "bytes": 3.35e12})
    assert {"busy_s": s.busy_s, "window_s": s.window_s,
            "device_idle": readers.device_idle(obs),
            "library_share": readers.library_share(obs),
            "k1_roofline": readers.k1_roofline(obs),
            "top_gaps": tr.top_gaps(s),
            "top_ops": tr.top_ops(s)} == BEFORE[kind]
    assert s.busy_s_by_card == [s.busy_s]


# -- counters and the problem over CPU-backed modules --------------------------

def _cell_of(name, chips, tiny=True):
    """The cell ``name`` on ``chips`` cards, by a manifest of its own; at
    test size where ``tiny``."""
    m = spec.load_json(spec.MANIFEST)
    for w in m["workloads"]:
        if w["name"] == name:
            w["chips"] = chips
    cell = spec.load_cell(name, manifest=m)
    if tiny:
        small = tiny_cell(name)
        cell.config, cell.traffic = small.config, small.traffic
    return cell


def test_a_four_card_cell_on_four_cpu_modules(monkeypatch):
    from benchmark.problems import potrf
    placed = []
    real = potrf.Problem.place

    def place(self, devs):
        placed.append(list(devs))
        return real(self, devs)
    monkeypatch.setattr(potrf.Problem, "place", place)
    r = run_cell(_cell_of(POTRF, 4), 2 ** 31 + 5, 0.2, True, device="cpu",
                 out=lambda s: None)
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    (devs,) = placed
    assert len(devs) == 4 and len({d.space for d in devs}) == 4
    d = r["device"]
    assert d["count"] == 4
    assert len(d["memory_peak_bytes_by_card"]) == 4
    assert len(d["busy_s_by_card"]) == 4
    c, by = r["counters"], r["counters_by_card"]
    assert len(by) == 4
    for k in by[0]:
        assert c[k] == sum(b[k] for b in by)
    assert all(b["executed_tasks"] > 0 for b in by)
    ici = {k: v for k, v in c.items() if k.startswith("ici.")}
    assert set(ici) == {"ici.puts", "ici.put_bytes", "ici.bcasts",
                        "ici.bcast_bytes", "ici.permutes",
                        "ici.permute_edges", "ici.permute_bytes"}
    assert ici["ici.put_bytes"] + ici["ici.bcast_bytes"] + \
        ici["ici.permute_bytes"] > 0


def test_one_module_carries_no_ici_counters():
    r = run_cell(tiny_cell(GEMM), 3, 0.0, False, device="cpu",
                 out=lambda s: None)
    assert r["device"]["count"] == 1
    assert not any(k.startswith("ici.") for k in r["counters"])
    assert r["counters"] == r["counters_by_card"][0]


def test_the_reference_reads_alike_on_any_number_of_devices():
    from benchmark.reference import potrf as ref
    cell = tiny_cell(POTRF)
    cpu = torch.device("cpu")
    one = ref.reference(cell.config, cell.traffic, 9, [cpu])
    four = ref.reference(cell.config, cell.traffic, 9, [cpu] * 4)
    assert all(torch.equal(one[t], four[t]) for t in one)
    assert ref.control(cell.config, cell.traffic, 9, [cpu] * 3) == \
        ref.control(cell.config, cell.traffic, 9, [cpu])


# -- four cards ----------------------------------------------------------------

#: the rehearsal's size: the Cholesky cell's tile, 12 tiles a side
REHEARSAL_N = 6144 * 12


def rehearse() -> None:
    """A four-card Cholesky end to end (run in a process of its own that
    sees every card): the cell's configuration and tile at ``REHEARSAL_N``,
    tiles dealt over the cards by the program.  Prints the card count, or
    the result line."""
    cards.narrow(4)
    if torch.cuda.device_count() < 4:
        print(json.dumps({"cards": torch.cuda.device_count()}))
        return
    cell = _cell_of(POTRF, 4, tiny=False)
    cell.config = dict(cell.config, n=REHEARSAL_N, diagonal=REHEARSAL_N)
    r = run_cell(cell, 2 ** 31 + 4404, 3.0, True,
                 out=lambda s: print(s, file=sys.stderr))
    print(json.dumps(r))


@pytest.mark.cuda
def test_a_four_card_cell_runs_on_four_cards(card, every_card_env):
    out = subprocess.run(
        [sys.executable, "-c",
         "from benchmark.tests.test_bm_cards import rehearse; rehearse()"],
        cwd=spec.ROOT, env=every_card_env, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    if "cards" in r:
        pytest.skip(f"this host has {r['cards']} card(s), not four")
    assert r["correct"] is True and r["failed"] == 0, r["checks"]
    d = r["device"]
    assert d["count"] == 4 and d["platform"] == "gpu"
    assert len(d["busy_s_by_card"]) == 4 and min(d["busy_s_by_card"]) > 0
    assert len(d["memory_peak_bytes_by_card"]) == 4
    assert min(d["memory_peak_bytes_by_card"]) > 0
    assert d["memory_peak_bytes"] == max(d["memory_peak_bytes_by_card"])
    assert d["busy_s"] == pytest.approx(sum(d["busy_s_by_card"]) / 4)
    c = r["counters"]
    assert c["ici.put_bytes"] + c["ici.bcast_bytes"] + \
        c["ici.permute_bytes"] > 0
    assert all(b["executed_tasks"] > 0 for b in r["counters_by_card"])
    assert any(n.startswith("cuda:") for n, _ in
               r["breakdown"]["idle_gaps"])
