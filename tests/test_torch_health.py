"""The port's predictive health plane (prof/health.py): twins of the
single-rank tests of tests/test_health.py, and parity with the JAX
package's monitor on the same scripted observations.

The flight-recorder bundle's health snapshot is twinned; the fabric
(drain/undrain) and the auditor's H1 corpus wait for the service layer
and tools/.  The rate
limit is driven by an injected clock (a deliberate difference of the
port's monitor), so no assertion here rests on wall time under load.
"""

import re
import time

import pytest

from parsec_tpu_torch.prof.health import HealthMonitor, merge_health
from parsec_tpu_torch.prof.metrics import render_text
from parsec_tpu_torch.utils.mca import params


# ---------------------------------------------------------------------------
# merge_health: the cross-rank pessimistic fold
# ---------------------------------------------------------------------------

def _section(rank, scores, folds=0, transitions=0):
    return {"v": 1, "rank": rank, "folds": folds,
            "transitions": transitions,
            "scores": {str(r): {"score": s, "ewma": s, "trend": 0.0,
                                "state": "ok", "since_s": 0.0, "n": 1}
                       for r, s in scores.items()}}


def test_merge_health_counts_sum_exactly():
    doc = merge_health({
        0: _section(0, {0: 1.0}, folds=7, transitions=2),
        1: _section(1, {1: 1.0}, folds=5, transitions=1),
    })
    assert doc["folds"] == 12
    assert doc["transitions"] == 3


def test_merge_health_pessimistic_lowest_view_wins():
    """A wedged rank's rosy self-report must not mask what its peers
    measure: the LOWEST smoothed score any rank observed wins, and the
    observing rank is recorded as ``src``."""
    doc = merge_health({
        0: _section(0, {0: 1.0, 1: 0.4}),    # rank 0 sees peer 1 sick
        1: _section(1, {1: 0.95, 0: 0.99}),  # rank 1 self-reports fine
    })
    assert doc["ranks"][1]["ewma"] == 0.4
    assert doc["ranks"][1]["src"] == 0
    assert doc["ranks"][0]["ewma"] == 0.99
    assert doc["ranks"][0]["src"] == 1


def test_merge_health_tolerates_absent_and_malformed_sections():
    doc = merge_health({
        0: _section(0, {0: 0.9}),
        1: None,
        2: {},
        3: {"v": 1, "rank": 3, "scores": {"bogus": {"ewma": "NaNish"}}},
    })
    assert set(doc["ranks"]) == {0}
    assert merge_health(None) == {"ranks": {}, "folds": 0,
                                  "transitions": 0}
    assert merge_health({}) == {"ranks": {}, "folds": 0,
                                "transitions": 0}


def test_merge_health_agrees_with_the_jax_package():
    from parsec_tpu.prof.health import merge_health as ref_merge
    secs = {0: _section(0, {0: 0.8, 1: 0.3, 2: 0.9}, folds=4,
                        transitions=1),
            1: _section(1, {1: 0.7, 0: 0.75}, folds=2),
            2: _section(2, {2: 0.2}, transitions=5), 3: None}
    assert merge_health(secs) == ref_merge(secs)


# ---------------------------------------------------------------------------
# HealthMonitor: scoring, state machine, transition journal
# ---------------------------------------------------------------------------

class _JournalStub:
    def __init__(self):
        self.events = []

    def emit(self, etype, **fields):
        self.events.append({"e": etype, **fields})


class _CtxStub:
    def __init__(self):
        self.rank = 0
        self.journal = _JournalStub()


class _MetricsStub:
    def __init__(self):
        self.context = _CtxStub()


class _Clock:
    """A clock the test advances by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _mk_monitor(cls=HealthMonitor, **kw):
    m = _MetricsStub()
    return cls(m, **kw), m.context.journal


def test_monitor_state_machine_and_transition_journal():
    """Declining scores walk ok -> degraded -> critical, each hop
    journaled as a health_transition with the OBSERVED rank in
    ``peer``."""
    hm, jr = _mk_monitor()
    now = time.monotonic()
    with hm._lock:
        for s in (1.0, 0.9, 0.5, 0.3, 0.1, 0.05, 0.02, 0.01):
            hm._observe_locked(1, s, now)
    snap = hm.snapshot()[1]
    assert snap["state"] == "critical"
    assert snap["ewma"] < 0.5
    kinds = [(e["frm"], e["to"]) for e in jr.events
             if e["e"] == "health_transition"]
    assert ("ok", "degraded") in kinds
    assert ("degraded", "critical") in kinds
    assert all(e.get("peer") == 1 for e in jr.events)
    assert hm.transitions == len(kinds)
    assert snap["trend"] < 0.0


def test_monitor_hysteresis_damps_flapping():
    params.set("health_alpha", 1.0)      # ewma == last score: exact
    try:
        hm, jr = _mk_monitor()
        now = time.monotonic()
        thr_deg = hm._thr_deg
        hyst = hm._hyst
        with hm._lock:
            hm._observe_locked(1, thr_deg - 0.01, now)   # -> degraded
            assert hm._ranks[1].state == "degraded"
            hm._observe_locked(1, thr_deg + hyst / 2, now)
            assert hm._ranks[1].state == "degraded"
            hm._observe_locked(1, thr_deg + hyst + 0.01, now)
            assert hm._ranks[1].state == "ok"
        trans = [e for e in jr.events if e["e"] == "health_transition"]
        assert len(trans) == 2          # one down, one up — no flap
    finally:
        params.unset("health_alpha")


def test_monitor_evidence_and_series_shapes():
    clock = _Clock()
    hm, _ = _mk_monitor(clock=clock)
    with hm._lock:
        for s in (0.8, 0.6, 0.4):
            hm._observe_locked(2, s, clock())
            clock.t += 1.0
    ev = hm.evidence(2, k=2)
    assert len(ev) == 2
    assert [s for _age, s in ev] == [0.6, 0.4]      # newest last
    assert [age for age, _s in ev] == [2.0, 1.0]    # on the clock
    series = hm.series_snapshot()
    assert len(series[2]) == 3
    assert hm.evidence(99) == []                    # unknown rank


def test_monitor_refresh_rate_limit_reuses_last_fold():
    """Inside ``health_interval_s`` every refresh reuses the last fold;
    past it (on the monitor's clock) the next one folds again."""
    params.set("health_interval_s", 10.0)
    try:
        clock = _Clock()
        hm, _ = _mk_monitor(clock=clock)
        hm.refresh()
        clock.t += 9.9
        hm.refresh()
        hm.refresh()
        assert hm.folds == 1        # inside the window: one real fold
        clock.t += 0.2
        hm.refresh()
        assert hm.folds == 2        # the window passed
        hm.refresh(force=True)
        assert hm.folds == 3
        # a context-less self fold scores this rank healthy
        assert hm.snapshot()[0]["ewma"] == 1.0
        assert hm.snapshot()[0]["since_s"] == pytest.approx(10.1)
    finally:
        params.unset("health_interval_s")


def test_scripted_scores_match_the_jax_packages_monitor():
    """Parity: the same scripted observations through both packages'
    monitors give the same states, EWMAs, trends and journal."""
    from parsec_tpu.prof.health import HealthMonitor as Ref
    got, gj = _mk_monitor()
    ref, rj = _mk_monitor(Ref)
    now = 50.0
    script = [(1, 0.95), (1, 0.6), (2, 0.9), (1, 0.2), (1, 0.9),
              (2, 0.1), (1, 0.99), (1, 1.0), (2, 0.05), (2, 0.95)]
    for hm in (got, ref):
        with hm._lock:
            for r, s in script:
                hm._observe_locked(r, s, now)
    strip = lambda snap: {r: {k: v for k, v in d.items()  # noqa: E731
                              if k != "since_s"} for r, d in snap.items()}
    assert strip(got.snapshot()) == strip(ref.snapshot())
    assert gj.events == rj.events
    assert got.transitions == ref.transitions


# ---------------------------------------------------------------------------
# export surfaces: gauges + __health__ section on the port's Context
# ---------------------------------------------------------------------------

def _n_pool(n, name="h"):
    from parsec_tpu_torch.dsl.ptg import PTG, Range
    p = PTG(name, N=n)
    p.task("E", i=Range(0, n - 1)).flow("x", "CTL").body(lambda: None)
    return p.build()


def test_health_gauges_and_section_ride_samples():
    from parsec_tpu_torch.core.context import Context
    params.set("health_interval_s", 0.0)
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            assert ctx.metrics is not None
            assert ctx.metrics.health is not None
            ctx.add_taskpool(_n_pool(10))
            ctx.wait(timeout=60)
            samples = ctx.metrics.samples()
    finally:
        params.unset("health_interval_s")
    text = render_text(samples)
    assert re.search(r'parsec_rank_health\{rank="0"\} 1\b', text)
    assert "parsec_health_folds_total" in text
    sections = [s for s in samples if s.get("n") == "__health__"]
    assert len(sections) == 1
    doc = sections[0]["doc"]
    assert doc["scores"]["0"]["state"] == "ok"
    assert "__health__" not in text


def test_health_disarmed_by_knob():
    from parsec_tpu_torch.core.context import Context
    params.set("health_enable", 0)
    try:
        with Context(nb_cores=1, device="cpu") as ctx:
            assert ctx.metrics is not None
            assert ctx.metrics.health is None
            samples = ctx.metrics.samples()
    finally:
        params.unset("health_enable")
    assert not [s for s in samples if s.get("n") == "__health__"]


def test_health_folds_no_per_task_hook():
    """The monitor adds no PINS callback: the registry's three hooks are
    all a Context at its defaults registers."""
    from parsec_tpu_torch.core.context import Context
    with Context(nb_cores=1, device="cpu") as ctx:
        hooked = {ev for ev, cbs in ctx._pins.items() if cbs}
        assert ctx.metrics.health is not None
    assert hooked == {"complete_exec", "task_discard", "job_done"}


# ---------------------------------------------------------------------------
# flight recorder: the health snapshot in incident bundles
# ---------------------------------------------------------------------------

def test_flightrec_bundle_carries_health_and_comm_delta(tmp_path):
    """Twin of the JAX package's test: an incident bundle carries the
    health plane's scores and series beside the comm counters' window
    (empty on one rank).  The dump runs on its own thread: the test
    waits for the file."""
    import json
    import os
    from parsec_tpu_torch.core.context import Context
    params.set("flightrec_enabled", 1)
    params.set("flightrec_dir", str(tmp_path))
    params.set("flightrec_min_interval_s", 0.0)
    params.set("health_interval_s", 0.0)
    try:
        with Context(nb_cores=2, device="cpu") as ctx:
            ctx.add_taskpool(_n_pool(10))
            ctx.wait(timeout=60)
            ctx.metrics.health.refresh(force=True)
            bundle = ctx.telemetry_incident("unit-test incident")
            path = os.path.join(bundle, "health-rank0.json")
            deadline = time.monotonic() + 10
            while ctx._flightrec.incidents < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
    finally:
        for k in ("flightrec_enabled", "flightrec_dir",
                  "flightrec_min_interval_s", "health_interval_s"):
            params.unset(k)
    assert os.path.exists(path)
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["reason"] == "unit-test incident"
    assert doc["health"]["0"]["ewma"] == pytest.approx(1.0)
    assert doc["health_series"]["0"]
    assert "comm_delta" in doc and "comm_window_s" in doc

