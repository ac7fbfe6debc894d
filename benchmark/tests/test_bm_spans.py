"""The readers of the program's spans (benchmark/spans.py) on synthetic
spans, and ``benchmark.spancheck`` on the CPU-backed module at test
size."""

import pytest

from benchmark import spancheck
from benchmark import spans as sp
from benchmark import trace as tr
from benchmark.tests.tiny import POTRF, tiny_cell


def _summary(busy, stages, t0=0.0, t1=100.0):
    return tr.TraceSummary(t0=t0, t1=t1, passes=1, busy=busy,
                           stages=stages, cards={0: tr.CardTrace(busy=busy)})


def _spans():
    s = sp.ProgramSpans()
    # a chained launch (POTRF then a TRSM wave of two), a SYRK wave
    s.dev = [("POTRF", 10.0, 20.0, 1, "device"),
             ("TRSM", 20.0, 40.0, 1, "device"),
             ("TRSM", 20.0, 40.0, 1, "device"),
             ("SYRK", 50.0, 90.0, 2, "device")]
    s.stages = [("mgr.idle", 0.0, 8.0, 1), ("mgr.pop", 8.0, 8.5, 1),
                ("mgr.stage_in", 8.5, 9.0, 1),
                ("mgr.dispatch", 9.0, 10.0, 1),
                ("mgr.idle", 40.0, 47.0, 2), ("mgr.pop", 47.0, 47.5, 2),
                ("mgr.stage_in", 47.5, 48.0, 2),
                ("mgr.dispatch", 48.0, 49.0, 2)]
    return s


def test_trsm_share_is_a_union_over_the_union():
    s = _spans()
    # TRSM 20 us of the 70 us the device spans cover (the wave counted once)
    assert sp.trsm_share(s, 0.0, 100.0) == pytest.approx(100 * 20 / 70)
    assert sp.trsm_share(s, 0.0, 100.0, cls="GEMM") == 0.0
    assert sp.trsm_share(None, 0.0, 100.0) is None
    assert sp.trsm_share(sp.ProgramSpans(), 0.0, 100.0) is None


def test_launch_us_counts_stage_in_and_dispatch_per_task():
    s = _spans()
    # (0.5 + 1.0) * 2 us over four tasks
    assert sp.launch_us(s, 0.0, 100.0) == pytest.approx(3.0 / 4)
    assert sp.launch_us(s, 45.0, 100.0) == pytest.approx(1.5 / 1)
    assert sp.launch_us(sp.ProgramSpans(), 0.0, 100.0) is None


def test_idle_dag_is_device_idle_while_the_manager_waits():
    s = _spans()
    busy = [(10.0, 40.0), (50.0, 90.0)]
    summary = _summary(busy, [("bm.wait", 0.0, 100.0)])
    # idle [0,10) [40,50) [90,100); manager idle [0,8) [40,47): 15 of 100
    assert sp.idle_dag(s, summary) == pytest.approx(15.0)
    no_stages = sp.ProgramSpans(dev=s.dev)
    assert sp.idle_dag(no_stages, summary) is None
    assert sp.idle_dag(None, summary) is None


def test_gap_names_append_the_innermost_program_span():
    s = _spans()
    summary = _summary([(10.0, 40.0), (50.0, 90.0)],
                       [("bm.wait", 0.0, 92.0), ("bm.synchronize", 92.0,
                                                 100.0)])
    names = sp.gap_names(summary, s)
    assert names == [["bm.wait>mgr.idle", pytest.approx(10e-6)],
                     ["bm.wait>mgr.idle", pytest.approx(10e-6)],
                     ["bm.synchronize", pytest.approx(10e-6)]]
    # without program spans the names are the harness's own
    assert [n for n, _ in sp.gap_names(summary, None)] == \
        [n for n, _ in tr.top_gaps(summary)]
    assert sp.innermost(s, 9.5) == "mgr.dispatch"
    assert sp.innermost(s, 30.0) == "dev:TRSM"


def test_agreement_pairs_steps_with_the_kernels_inside_them():
    s = _spans()
    summary = _summary([(10.0, 40.0), (50.0, 90.0)],
                       [("bm.wait", 0.0, 100.0)])
    summary.kernels = [("potrf_k", 10.5, 9.0), ("sgemm_tn", 21.0, 18.5),
                       ("wgmma", 50.0, 40.0)]
    a = spancheck.agreement(summary, s)
    assert a["steps"] == 3 and a["steps_without_kernel"] == 0
    # edges off by 0.5, 0.5; 1.0, 0.5; 0, 0
    assert a["edge_us_median"] == pytest.approx(0.5)
    # signed (first start - start, last end - end): (0.5, -0.5),
    # (1.0, -0.5), (0, 0): step offsets 0, 0.25, 0
    assert a["clock_offset_us"] == pytest.approx(0.0)
    assert a["edge_us_median_less_offset"] == pytest.approx(0.5)
    assert a["trsm_product_kernel"] == "sgemm_tn"
    assert a["cupti_trsm_product_share"] == pytest.approx(
        100 * 18.5 / (9.0 + 18.5 + 40.0))
    assert a["dev_vs_kernel_busy_rel"] == pytest.approx(
        70.0 / 67.5 - 1)


def test_from_profile_maps_the_program_clock(tmp_path):
    from parsec_tpu_torch.prof.reader import read_trace
    from parsec_tpu_torch.prof.profiling import EV_END, EV_START, Profile
    p = Profile("t")
    pc, ns = p.set_clock_anchor()
    sb = p.stream(901, "device-901")
    k = p.add_event_class("dev:TRSM").key
    sb.trace(k, EV_START, 1, 7, 42, {"lid": 3, "width": 2,
                                      "clock": "device"}, timestamp=pc + 1.0)
    sb.trace(k, EV_END, 1, 7, 42, timestamp=pc + 1.5)
    meta, rows = read_trace(p.dump(str(tmp_path / "t.ptt")))
    spans = sp.from_profile(meta, rows, base_ns=ns)
    (cls, s, e, lid, clock), = spans.dev
    assert (cls, lid, clock) == ("TRSM", 3, "device")
    assert s == pytest.approx(1e6, abs=1e-3) and \
        e == pytest.approx(1.5e6, abs=1e-3)
    assert sp.from_profile({"info": {}}, rows, ns) is None


def test_spancheck_runs_the_cell_on_the_cpu():
    """The traced windows in turns, spans off and on, at test size."""
    res = spancheck.run(tiny_cell(POTRF), seed=3, seconds=0.05, rounds=1,
                        device="cpu")
    off, on = res["windows"]
    assert not off["spans"] and on["spans"] and res["failed"] == 0
    assert "readings" not in off
    r = on["readings"]
    assert 0.0 <= r["trsm_share.potrf"] <= 100.0
    assert r["launch_us.potrf"] > 0
    assert r["idle_dag.potrf"] >= 0.0
    assert on["clocks"] == ["host"]
    assert on["dev_spans"] >= 2 * 20       # two passes of nt=6's tasks
    assert res["cost"]["on_over_off"] > 0
