"""The port's parseclint (parsec_tpu_torch/tools/parseclint) against the
reference's (tools/parseclint).

Twins of every case of tests/test_lint.py, on the same snippets with
their paths moved under ``parsec_tpu_torch/``: each pass flags the
known-bad shape of the bug class it encodes and accepts the
disciplined twin.  PCL-ALIAS is the port's own pass (torch stage-ins
that can alias a host buffer), so its four cases are rewritten for
torch.  A parity case runs the reference's and the port's
implementation of each of the eight shared passes over the same
snippets and the port's own sources (their waivers stripped, so they
have something to find) and compares (line, pass, message).  The gate
runs the port's lint over ``parsec_tpu_torch/`` against its baseline:
zero new findings is a tier-1 invariant, as the reference's gate is
over ``parsec_tpu/``.
"""

import os
import sys
import textwrap

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from parsec_tpu_torch.tools.parseclint import FileCtx, Finding  # noqa: E402
from parsec_tpu_torch.tools.parseclint.passes import (  # noqa: E402
    assert_hazard, device_put, evloop_blocking, except_hygiene, hot_path,
    journal_schema, lock_discipline, mca_knobs, prom_metrics)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ctx(src: str, rel: str = "parsec_tpu_torch/comm/snippet.py") -> FileCtx:
    return FileCtx("/" + rel, rel, textwrap.dedent(src))


def _ids(findings):
    return [f.pass_id for f in findings]


# ---------------------------------------------------------------------------
# PCL-LOCK: guarded-by discipline
# ---------------------------------------------------------------------------

_LOCKED_CLASS = """
    import threading

    class Engine:
        def __init__(self):
            self._lock = threading.Lock()
            self._handles = {}        # guarded-by: _lock
            self._seq = 0             # guarded-by: _lock

        def method(self):
            __BODY__
"""


def _lock_findings(body: str):
    src = _LOCKED_CLASS.replace("__BODY__", body)
    return lock_discipline.check(_ctx(src))


def test_lock_flags_unlocked_write():
    fs = _lock_findings("self._seq += 1")
    assert _ids(fs) == ["PCL-LOCK"] and "Engine._seq" in fs[0].message


def test_lock_flags_unlocked_container_mutation():
    assert _lock_findings("self._handles[1] = 2")       # subscript store
    assert _lock_findings("self._handles.pop(1, None)")  # mutator call
    assert _lock_findings("del self._handles[1]")        # subscript del


def test_lock_accepts_locked_write():
    assert not _lock_findings(
        "with self._lock:\n                self._seq += 1\n"
        "                self._handles[self._seq] = 1")


def test_lock_accepts_reads_unlocked():
    assert not _lock_findings("return self._handles.get(1)")


def test_lock_holds_lock_annotation():
    src = """
        import threading

        class Engine:
            def __init__(self):
                self._lock = threading.Lock()
                self._seq = 0   # guarded-by: _lock

            def _bump_locked(self):   # holds-lock: _lock
                self._seq += 1
    """
    assert not lock_discipline.check(_ctx(src))


def test_lock_condition_alias_either_suffices():
    """guarded-by: _lock, _cond — the Condition-wrapping-the-same-lock
    idiom (core/context.py): a write under EITHER passes."""
    src = """
        import threading

        class Ctx:
            def __init__(self):
                self._lock = threading.RLock()
                self._cond = threading.Condition(self._lock)
                self._errors = []   # guarded-by: _lock, _cond

            def record(self, exc):
                with self._cond:
                    self._errors.append(exc)

            def admit(self):
                with self._lock:
                    self._errors.append(None)
    """
    assert not lock_discipline.check(_ctx(src))


def test_lock_inline_suppression():
    fs = _lock_findings(
        "self._seq += 1   # lint: ignore[PCL-LOCK] init-only path")
    assert not fs


def test_lock_subclass_inherits_base_annotations():
    src = """
        import threading

        class Base:
            def __init__(self):
                self._lock = threading.Lock()
                self._peers = {}   # guarded-by: _lock

        class Derived(Base):
            def drop(self, r):
                self._peers.pop(r, None)
    """
    fs = lock_discipline.check(_ctx(src))
    assert _ids(fs) == ["PCL-LOCK"] and "Derived._peers" in fs[0].message


# ---------------------------------------------------------------------------
# PCL-EVLOOP: blocking calls reachable from loop callbacks
# ---------------------------------------------------------------------------

def test_evloop_flags_time_sleep_in_funnelled_method():
    src = """
        import time

        class EvCE:
            FUNNELLED = True

            def _on_timer(self):
                time.sleep(0.1)
    """
    fs = evloop_blocking.check(_ctx(src))
    assert _ids(fs) == ["PCL-EVLOOP"] and "time.sleep" in fs[0].message


def test_evloop_flags_blocking_heartbeat_sendmsg():
    """The EXACT pre-fix shape: the heartbeat path reaches a bare
    blocking sendmsg — the hung-peer detector wedges behind the very
    hang it exists to catch.  Reintroducing it must flag."""
    src = """
        class EvCE:
            FUNNELLED = True

            def heartbeat_tick(self):
                for r in self._peers:
                    self._hb_send(r)

            def _hb_send(self, r):
                s = self._peers[r]
                self._sendmsg_all(s, [b"hb"])

            def _sendmsg_all(self, s, parts):
                views = [memoryview(p) for p in parts]
                while views:
                    sent = s.sendmsg(views)
                    views = views[1:]
    """
    fs = evloop_blocking.check(_ctx(src))
    assert any("sendmsg" in f.message for f in fs), fs


def test_evloop_accepts_nonblocking_sendmsg_discipline():
    """The post-fix shape: sendmsg wrapped in the BlockingIOError
    try — the event loop's nonblocking contract — passes."""
    src = """
        class EvCE:
            FUNNELLED = True

            def _flush(self, peer):
                try:
                    sent = peer.sock.sendmsg(peer.wire)
                except (BlockingIOError, InterruptedError):
                    return
    """
    assert not evloop_blocking.check(_ctx(src))


def test_evloop_flags_select_select():
    """The fd>=1024 hazard: select.select in loop-reachable
    code dies on a resident service holding thousands of fds."""
    src = """
        import select

        class EvCE:
            FUNNELLED = True

            def _writable(self, s):
                return bool(select.select([], [s], [], 0)[1])
    """
    fs = evloop_blocking.check(_ctx(src))
    assert _ids(fs) == ["PCL-EVLOOP"] and "fd>=1024" in fs[0].message


def test_evloop_flags_blocking_acquire_allows_nonblocking():
    src = """
        class EvCE:
            FUNNELLED = True

            def bad(self):
                self._lk.acquire()

            def good(self):
                if self._lk.acquire(blocking=False):
                    self._lk.release()
    """
    fs = evloop_blocking.check(_ctx(src))
    assert len(fs) == 1 and ".acquire()" in fs[0].message


def test_evloop_on_loop_marker_and_reachability():
    """A method marked on-loop is a root even outside a FUNNELLED
    class, and the pass follows self-calls to find the sleep."""
    src = """
        import time

        class Handlers:
            # lint: on-loop (AM handler)
            def _activate_cb(self, src, msg):
                self._slow_path()

            def _slow_path(self):
                time.sleep(1.0)

            def off_loop_helper(self):
                time.sleep(1.0)   # not reachable from a root: no flag
    """
    fs = evloop_blocking.check(_ctx(src))
    assert len(fs) == 1 and "_slow_path" in fs[0].message


def test_evloop_off_loop_and_waiver():
    src = """
        import time

        class EvCE:
            FUNNELLED = True

            def _dial(self, dst):   # lint: off-loop (init thread)
                time.sleep(0.05)

            def _shutdown_drain(self):
                time.sleep(0.002)   # lint: allow-blocking (teardown)
    """
    assert not evloop_blocking.check(_ctx(src))


# ---------------------------------------------------------------------------
# PCL-ALIAS: torch stage-ins that can alias a host buffer
# ---------------------------------------------------------------------------

def test_alias_flags_geqrf_prefix_shape():
    """The geqrf wrong-R shape in torch: stage-in assigns a
    ``torch.from_numpy`` view of the host payload as the device copy, and
    the consumer later donates it (writes it in place) — the host tile
    changes under its owner.  Reintroducing it in devices/ must flag."""
    src = """
        import torch

        class CudaDevice:
            def stage_in(self, datum, copy, payload):
                dc = datum.copy_on(self.space)
                dc.payload = torch.from_numpy(payload)
                dc.version = copy.version
                return dc

            def donate(self, dc, delta):
                dc.payload.add_(delta)
    """
    fs = device_put.check(_ctx(src, rel="parsec_tpu_torch/devices/cuda.py"))
    assert _ids(fs) == ["PCL-ALIAS"] and "wrong-R" in fs[0].message
    assert "torch.from_numpy" in fs[0].message


def test_alias_flags_jnp_asarray_and_ici_scope():
    """The ICI transport is in scope: a same-device ``.to()`` (returns its
    source), ``.contiguous()`` and a pinned ``non_blocking`` copy each
    flag there."""
    src = """
        import torch

        def put(self, payload, dst):
            a = payload.to(dst.tdev)
            b = payload.contiguous()
            out = torch.empty(tuple(payload.shape), device=dst.tdev)
            out.copy_(payload, non_blocking=True)
            return a, b, out
    """
    fs = device_put.check(_ctx(src, rel="parsec_tpu_torch/comm/ici.py"))
    assert [f.line for f in fs] == [5, 6, 8]
    assert [m.split(" stage-in")[0] for m in (f.message for f in fs)] == [
        "raw .to()", "raw .contiguous()", "raw .copy_(non_blocking=...)"]


def test_alias_wrapper_and_waiver_accepted():
    src = """
        import torch

        def _to_device(self, payload):   # lint: alias-wrapper
            src = payload if isinstance(payload, torch.Tensor) \\
                else to_host(payload)
            dst = torch.empty(tuple(src.shape), device=self.tdev)
            dst.copy_(src, non_blocking=src.is_pinned())
            return dst

        def host_view(self, dc):
            return dc.payload.to("cpu")   # lint: private-ok (a host read)
    """
    assert not device_put.check(
        _ctx(src, rel="parsec_tpu_torch/devices/cuda.py"))


def test_alias_out_of_scope_files_untouched():
    src = ("import torch\n\ndef f(x, d):\n"
           "    return torch.from_numpy(x).to(d)\n")
    assert not device_put.check(
        _ctx(src, rel="parsec_tpu_torch/apps/gemm.py"))


# ---------------------------------------------------------------------------
# PCL-MCA: knob drift
# ---------------------------------------------------------------------------

def _mca_run(sources, tmp_path):
    """sources: {rel: code}.  tmp_path has no parsec_tpu_torch package, so
    the full-package gate is vacuously open (synthetic-tree mode)."""
    ctxs = {rel: _ctx(src, rel=rel) for rel, src in sources.items()}
    facts = [mca_knobs.facts(c) for c in ctxs.values()]
    return mca_knobs.tree_check(facts, str(tmp_path), ctxs)


def test_mca_flags_unregistered_read(tmp_path):
    fs = _mca_run({"parsec_tpu_torch/comm/x.py":
                   'params.register("comm_foo", 1, "h")\n'
                   'v = params.get("comm_fooo", 1)\n'}, tmp_path)
    assert any("UNREGISTERED" in f.message and "comm_fooo" in f.message
               for f in fs)


def test_mca_flags_unread_registration(tmp_path):
    fs = _mca_run({"parsec_tpu_torch/comm/x.py":
                   'params.register("comm_dead_knob", 1, "h")\n'},
                  tmp_path)
    assert any("never read" in f.message for f in fs)


def test_mca_flags_default_drift(tmp_path):
    """The drift class this pass caught FOR REAL on landing:
    comm_handle_timeout registered 600.0, read with fallback 120.0."""
    fs = _mca_run({"parsec_tpu_torch/comm/x.py":
                   'params.register("comm_ttl", 600.0, "h")\n'
                   'v = params.get("comm_ttl", 120.0)\n'}, tmp_path)
    assert any("drifted" in f.message for f in fs)


def test_mca_flags_env_typo(tmp_path):
    fs = _mca_run({"parsec_tpu_torch/comm/x.py":
                   'import os\n'
                   'params.register("comm_foo", 1, "h")\n'
                   'v = params.get("comm_foo")\n'
                   'w = os.environ.get("PARSEC_MCA_COMM_FOOO")\n'},
                  tmp_path)
    assert any("PARSEC_MCA_COMM_FOOO" in f.message for f in fs)


def test_mca_doc_table_cross_check(tmp_path):
    (tmp_path / "COMPONENTS.md").write_text(
        "| knob | `PARSEC_MCA_COMM_TYPO` selects it |\n")
    fs = _mca_run({"parsec_tpu_torch/comm/x.py":
                   'params.register("comm_foo", 1, "h")\n'
                   'v = params.get("comm_foo")\n'}, tmp_path)
    assert any(f.path == "COMPONENTS.md" and "doc drift" in f.message
               for f in fs)


def test_mca_clean_roundtrip(tmp_path):
    fs = _mca_run({"parsec_tpu_torch/comm/x.py":
                   'params.register("comm_foo", 4096, "h")\n'
                   'v = params.get("comm_foo", 4096)\n'}, tmp_path)
    assert fs == []


def test_mca_partial_scan_is_silent():
    """A subtree scan of the REAL repo (anything short of the whole
    parsec_tpu_torch package) keeps the cross-checks off — registrations live
    all over the package, so a partial view would emit false
    'unregistered'/'doc drift' findings for knobs registered outside
    the scanned subtree."""
    ctx = _ctx('v = params.get("anything_at_all")\n',
               rel="parsec_tpu_torch/comm/x.py")
    fs = mca_knobs.tree_check([mca_knobs.facts(ctx)], REPO,
                              {ctx.rel: ctx,
                               "parsec_tpu_torch/utils/mca.py": ctx})
    assert fs == []


# ---------------------------------------------------------------------------
# PCL-PROM: metric-family doc drift
# ---------------------------------------------------------------------------

def _prom_run(sources, docs, tmp_path):
    """sources: {rel: code} (exporter rel paths get written to disk so
    the existence gate sees them); docs: {name: text}."""
    ctxs = {}
    for rel, src in sources.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
        ctxs[rel] = _ctx(src, rel=rel)
    for name, text in docs.items():
        (tmp_path / name).write_text(text)
    facts = [prom_metrics.facts(c) for c in ctxs.values()]
    return prom_metrics.tree_check(facts, str(tmp_path), ctxs)


_EXPORTER = "parsec_tpu_torch/prof/metrics.py"


def test_prom_flags_undocumented_family(tmp_path):
    fs = _prom_run(
        {_EXPORTER: 'out.append(counter_sample('
                    '"parsec_widgets_total", 1))\n'},
        {"README.md": "telemetry families: none yet\n"}, tmp_path)
    assert [f.pass_id for f in fs] == ["PCL-PROM"]
    assert "parsec_widgets_total" in fs[0].message
    assert fs[0].path == _EXPORTER


def test_prom_flags_stale_doc_series(tmp_path):
    """The encoded bug class: parsec_tasks_enabled_total was dropped
    from the registry; a doc row still naming it must flag AT THE DOC
    LINE."""
    fs = _prom_run(
        {_EXPORTER: 's = counter_sample('
                    '"parsec_tasks_retired_total", n)\n'},
        {"README.md": "families: `parsec_tasks_retired_total` and "
                      "`parsec_tasks_enabled_total`\n"}, tmp_path)
    assert any(f.path == "README.md"
               and "parsec_tasks_enabled_total" in f.message
               for f in fs)
    assert not any(f.path == _EXPORTER for f in fs)


def test_prom_prefix_mention_and_template_clean(tmp_path):
    """A family-prefix doc mention (parsec_comm_) covers both plain
    literals and f-string templates; series-suffixed doc tokens that
    resolve against a template are clean too."""
    fs = _prom_run(
        {_EXPORTER: '''
            for key in ("frames_sent", "frames_recv"):
                out.append(counter_sample(
                    f"parsec_comm_{key}_total", 1))
            out.append(gauge_sample("parsec_comm_dead_peers", 0))
         '''},
        {"README.md": "comm families (`parsec_comm_...`): "
                      "`parsec_comm_frames_sent_total` etc.\n"},
        tmp_path)
    assert fs == []


def test_prom_partial_scan_is_silent(tmp_path):
    """An exporter file present on disk but outside the scanned set
    keeps the cross-check off (the export universe is incomplete)."""
    (tmp_path / "parsec_tpu_torch" / "prof").mkdir(parents=True)
    (tmp_path / _EXPORTER).write_text(
        'counter_sample("parsec_widgets_total", 1)\n')
    (tmp_path / "README.md").write_text("nothing\n")
    other = _ctx("x = 1\n", rel="parsec_tpu_torch/comm/x.py")
    assert prom_metrics.tree_check(
        [prom_metrics.facts(other)], str(tmp_path),
        {other.rel: other}) == []


def test_prom_non_series_doc_tokens_ignored(tmp_path):
    """Reference-C symbol mentions (parsec_matrix_block_cyclic_kview)
    carry no series suffix and never flag doc-side."""
    fs = _prom_run(
        {_EXPORTER: 's = counter_sample('
                    '"parsec_tasks_retired_total", n)\n'},
        {"COMPONENTS.md":
         "rebuilds parsec_matrix_block_cyclic_kview; families: "
         "`parsec_tasks_retired_total`\n"}, tmp_path)
    assert fs == []


def test_prom_inline_suppression(tmp_path):
    fs = _prom_run(
        {_EXPORTER: 'counter_sample("parsec_internal_probe_total", '
                    '1)  # lint: ignore[PCL-PROM]\n'},
        {"README.md": "none\n"}, tmp_path)
    assert fs == []


# ---------------------------------------------------------------------------
# PCL-EXCEPT: containment hygiene
# ---------------------------------------------------------------------------

def test_except_flags_context_global_record():
    """The containment class: a handler catching the structured
    PeerFailedError re-records it context-globally, poisoning every
    pool on the rank."""
    src = """
        from parsec_tpu_torch.core.errors import PeerFailedError

        class Layer:
            def push(self, dst, msg):
                try:
                    self.send(dst, msg)
                except PeerFailedError as exc:
                    self.context.record_error(exc, None)
    """
    fs = except_hygiene.check(_ctx(src))
    assert _ids(fs) == ["PCL-EXCEPT"] and "CONTEXT-GLOBALLY" in fs[0].message


def test_except_flags_broad_catch_global_record():
    src = """
        from parsec_tpu_torch.core.errors import PeerFailedError

        def drain(self):
            try:
                self.flush()
            except Exception as exc:
                self.context.record_error(exc, None)
    """
    assert except_hygiene.check(_ctx(src))


def test_except_flags_silent_swallow_and_accepts_waiver():
    bad = """
        from parsec_tpu_torch.core.errors import PeerFailedError

        def push(self):
            try:
                self.send()
            except PeerFailedError:
                pass
    """
    assert except_hygiene.check(_ctx(bad))
    waived = bad.replace(
        "pass",
        "# lint: contained (death already routed)\n                pass")
    assert not except_hygiene.check(_ctx(waived))


def test_except_accepts_pool_routed_handler():
    src = """
        from parsec_tpu_torch.core.errors import PeerFailedError

        def push(self, tp):
            try:
                self.send()
            except PeerFailedError as exc:
                self.context.record_pool_error(tp, exc)
    """
    assert not except_hygiene.check(_ctx(src))


def test_except_accepts_task_attributed_record():
    src = """
        from parsec_tpu_torch.core.errors import PeerFailedError

        def run(self, task):
            try:
                task.body()
            except Exception as exc:
                self.context.record_error(exc, task)
    """
    assert not except_hygiene.check(_ctx(src))


# ---------------------------------------------------------------------------
# PCL-HOT: per-task lock round-trips in the task hot path
# ---------------------------------------------------------------------------

def test_hot_flags_termdet_call_in_complete_execution():
    """The EXACT bug class batched termdet removed: the per-task locked
    termdet decrement inside the completion chain."""
    src = """
        def complete_execution(es, task, failed=False):
            tp = task.taskpool
            task.status = 4
            tp.termdet.taskpool_addto_nb_tasks(tp, -1)
    """
    fs = hot_path.check(_ctx(src, rel="parsec_tpu_torch/core/snippet.py"))
    assert _ids(fs) == ["PCL-HOT"] and \
        "taskpool_addto_nb_tasks" in fs[0].message


def test_hot_flags_lock_reached_through_helper():
    """Same-file reachability: a `with self._lock` two calls below
    task_progress still flags, naming the root it was reached from."""
    src = """
        def task_progress(es, task):
            _account(es, task)

        def _account(es, task):
            _bump(es.metrics, task)

        def _bump(m, task):
            with m._lock:
                m.count += 1
    """
    fs = hot_path.check(_ctx(src, rel="parsec_tpu_torch/core/snippet.py"))
    assert _ids(fs) == ["PCL-HOT"]
    assert "with _lock" in fs[0].message
    assert "reached from task_progress" in fs[0].message


def test_hot_flags_acquire_in_marked_ready_queue_callback():
    """ReadyQueue callbacks opt in via `# lint: hot-path` on the def
    line (the scheduler schedule/select convention)."""
    src = """
        class Sched:
            # lint: hot-path (per scheduling event)
            def schedule(self, es, tasks, distance=0):
                self._qlock.acquire()
                try:
                    self._q.extend(tasks)
                finally:
                    self._qlock.release()
    """
    fs = hot_path.check(_ctx(src, rel="parsec_tpu_torch/sched/snippet.py"))
    assert _ids(fs) == ["PCL-HOT"] and ".acquire()" in fs[0].message


def test_hot_flags_lock_construction():
    src = """
        import threading

        def task_progress(es, task):
            gate = threading.Lock()
            with gate:
                pass
    """
    fs = hot_path.check(_ctx(src, rel="parsec_tpu_torch/core/snippet.py"))
    assert any("threading.Lock() construction" in f.message for f in fs)


def test_hot_waiver_and_cold_functions_untouched():
    """The batch-boundary flush carries a waiver; functions not
    reachable from a hot root never flag."""
    src = """
        def worker_loop(es):
            while True:
                _flush(es)

        def _flush(es):
            for tp, ent in es._td_acc.items():
                tp.termdet.taskpool_addto_nb_tasks(  # lint: ignore[PCL-HOT] batch boundary
                    tp, -ent[1], epoch=ent[0])

        def cold_admin_path(tp):
            with tp._lock:
                tp.nb_tasks = 0
    """
    assert not hot_path.check(
        _ctx(src, rel="parsec_tpu_torch/core/snippet.py"))


# ---------------------------------------------------------------------------
# PCL-ASSERT: -O hazards
# ---------------------------------------------------------------------------

def test_assert_flags_module_level():
    """The TAG_NAMES class: an import-time wire-protocol invariant as
    an assert vanishes under python -O."""
    src = """
        TAGS = {"ACT": 1}
        assert TAGS["ACT"] == 1
    """
    fs = assert_hazard.check(_ctx(src))
    assert _ids(fs) == ["PCL-ASSERT"] and "module-level" in fs[0].message


def test_assert_flags_side_effecting_condition():
    src = """
        def f(q):
            assert q.pop() == 1
    """
    fs = assert_hazard.check(_ctx(src))
    assert _ids(fs) == ["PCL-ASSERT"] and ".pop" in fs[0].message


def test_assert_accepts_pure_conditions():
    src = """
        def f(xs, x):
            assert len(xs) > 0
            assert isinstance(x, int)
            assert x > 0, "message"
    """
    assert not assert_hazard.check(_ctx(src))


def test_assert_inline_suppression():
    src = """
        def f(q):
            assert q.flush()   # lint: ignore[PCL-ASSERT] test helper
    """
    assert not assert_hazard.check(_ctx(src))


# ---------------------------------------------------------------------------
# PCL-JRNL: control-plane journal schema drift
# ---------------------------------------------------------------------------

_JRNL_SCHEMA = """
    EVENT_SCHEMA = {
        "mode_decl": ("pool", "round", "mode", "peers"),
        "retired": ("pool",),
    }
"""

_JRNL_SCHEMA_REL = "parsec_tpu_torch/prof/journal.py"


def _jrnl_run(sources):
    """sources: {rel: code}; the schema module above is always in
    scope (the pass's existence gate)."""
    ctxs = {rel: _ctx(src, rel=rel) for rel, src in sources.items()}
    facts = [journal_schema.facts(c) for c in ctxs.values()]
    return journal_schema.tree_check(facts, REPO, ctxs)


def test_jrnl_flags_unknown_event_type():
    """The encoded bug class: an emit whose type never entered the
    schema table is an event journal_audit cannot attribute."""
    fs = _jrnl_run({
        _JRNL_SCHEMA_REL: _JRNL_SCHEMA,
        "parsec_tpu_torch/core/snip.py":
            'jr.emit("mode_declared", pool=1, round=2)\n'})
    assert _ids(fs) == ["PCL-JRNL"]
    assert "mode_declared" in fs[0].message


def test_jrnl_flags_round_scoped_emit_without_round():
    """Round-scoped protocol emits must carry round= — an emit the
    auditor cannot place in a round is one it cannot check."""
    fs = _jrnl_run({
        _JRNL_SCHEMA_REL: _JRNL_SCHEMA,
        "parsec_tpu_torch/core/snip.py":
            'jr.emit("mode_decl", pool=1, mode="full", peers=[0])\n'})
    assert _ids(fs) == ["PCL-JRNL"]
    assert "round" in fs[0].message


def test_jrnl_flags_starstar_hiding_required_fields():
    fs = _jrnl_run({
        _JRNL_SCHEMA_REL: _JRNL_SCHEMA,
        "parsec_tpu_torch/core/snip.py":
            'jr.emit("retired", **fields)\n'})
    assert _ids(fs) == ["PCL-JRNL"]
    assert "**kwargs" in fs[0].message


def test_jrnl_flags_non_literal_type_and_attr_receiver():
    """Computed event types flag; the attribute-chain receiver form
    (self.context.journal.emit) is recognized too."""
    fs = _jrnl_run({
        _JRNL_SCHEMA_REL: _JRNL_SCHEMA,
        "parsec_tpu_torch/core/snip.py": """
            self.context.journal.emit(etype, pool=1)
        """})
    assert _ids(fs) == ["PCL-JRNL"]
    assert "non-literal" in fs[0].message


def test_jrnl_accepts_schema_conformant_emits():
    fs = _jrnl_run({
        _JRNL_SCHEMA_REL: _JRNL_SCHEMA,
        "parsec_tpu_torch/core/snip.py": """
            jr.emit("mode_decl", pool=1, round=2, mode="minimal",
                    peers=[0, 1], extra="free-form is fine")
            ctx.journal.emit("retired", pool=1)
        """})
    assert fs == []


def test_jrnl_partial_scan_is_silent():
    """Without the schema module in the scanned set the cross-check
    stays off (the schema universe is incomplete)."""
    fs = _jrnl_run({
        "parsec_tpu_torch/core/snip.py": 'jr.emit("bogus_event", pool=1)\n'})
    assert fs == []


def test_jrnl_inline_suppression():
    fs = _jrnl_run({
        _JRNL_SCHEMA_REL: _JRNL_SCHEMA,
        "parsec_tpu_torch/core/snip.py":
            'jr.emit("oddball")  '
            '# lint: ignore[PCL-JRNL] prototype event\n'})
    assert fs == []


def test_jrnl_real_schema_covers_every_tree_emit():
    """Meta-gate on the REAL schema: every required-field tuple in
    prof/journal.py is well-formed and the live EVENT_SCHEMA parses
    out of the AST exactly as the runtime dict."""
    import ast as _ast
    from parsec_tpu_torch.prof.journal import EVENT_SCHEMA
    with open(os.path.join(REPO, _JRNL_SCHEMA_REL)) as fh:
        tree = _ast.parse(fh.read())
    parsed = journal_schema._schema_from_tree(tree)
    assert parsed == {k: list(v) for k, v in EVENT_SCHEMA.items()}


# ---------------------------------------------------------------------------
# driver: baseline + the clean-tree tier-1 gate
# ---------------------------------------------------------------------------

def test_baseline_roundtrip(tmp_path):
    from parsec_tpu_torch.tools.parseclint.engine import (load_baseline,
                                                          write_baseline)
    f1 = Finding("a.py", 10, "PCL-LOCK", "msg one")
    f2 = Finding("b.py", 20, "PCL-MCA", "msg two")
    path = str(tmp_path / "baseline.txt")
    write_baseline([f1, f2], path)
    allowed = load_baseline(path)
    assert allowed[f1.baseline_key()] == 1
    # line shifts keep the identity: same path/pass/message matches
    shifted = Finding("a.py", 99, "PCL-LOCK", "msg one")
    assert shifted.baseline_key() in allowed


def test_clean_tree_zero_findings():
    """THE gate: the real tree, against the checked-in baseline, has
    zero new findings.  Every guarded-by/on-loop annotation, waiver,
    and knob-table entry in the repo is live input to this test —
    tier-1 fails on any new violation, which is what makes parseclint
    a pre-merge invariant rather than advice."""
    from parsec_tpu_torch.tools.parseclint.engine import run
    new, baselined, errors = run(
        [os.path.join(REPO, "parsec_tpu_torch")], use_processes=False)
    assert errors == [], errors
    assert new == [], "\n".join(f.render() for f in new)


# ---------------------------------------------------------------------------
# the port's own PCL-ALIAS: every hazard, the wrappers, the stage-in sites
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call,flags", [
    ("torch.from_numpy(a)", True),
    ("torch.as_tensor(a)", True),
    ("to_host(a)", True),
    ("data.to_host(a)", True),
    ("a.to(self.tdev)", True),
    ("a.to(torch.float32)", True),
    ("a.contiguous()", True),
    ("out.copy_(a, non_blocking=True)", True),
    ("out.copy_(a, non_blocking=a.is_pinned())", True),
    ("out.copy_(a)", False),
    ("a.clone()", False),
    ("torch.empty_like(a)", False),
    ("datum.pull_to_host()", False),
])
def test_alias_flags_each_torch_hazard(call, flags):
    """Each aliasing call the pass names flags once in the device layer;
    an explicit copy into fresh storage does not."""
    src = f"import torch\n\ndef stage(self, a, out, data, datum):\n" \
          f"    return {call}\n"
    fs = device_put.check(_ctx(src, rel="parsec_tpu_torch/devices/x.py"))
    assert [f.line for f in fs] == ([4] if flags else [])


def _without_marker(path, marker):
    with open(path, encoding="utf-8") as fh:
        return fh.read().replace(f"lint: {marker}", "lint-off")


@pytest.mark.parametrize("rel,func", [
    ("parsec_tpu_torch/devices/cuda.py", "_to_device"),
    ("parsec_tpu_torch/devices/cuda.py", "copy_from"),
    ("parsec_tpu_torch/comm/ici.py", "_copy"),
])
def test_alias_stage_in_wrappers_are_marked(rel, func):
    """The port's three stage-in functions carry ``lint: alias-wrapper``,
    and the marker is what clears them: without it the pass flags
    calls inside each (their ``to_host`` and ``non_blocking`` copies)."""
    import ast
    path = os.path.join(REPO, rel)
    ctx = FileCtx(path, rel, open(path, encoding="utf-8").read())
    (fn,) = [n for n in ast.walk(ctx.tree)
             if isinstance(n, ast.FunctionDef) and n.name == func]
    assert ctx.has_marker(fn.lineno, "alias-wrapper")
    assert not device_put.check(ctx)
    bare = FileCtx(path, rel, _without_marker(path, "alias-wrapper"))
    inside = [f.line for f in device_put.check(bare)
              if fn.lineno <= f.line <= fn.end_lineno]
    assert inside, f"{func}: no hazardous call inside the wrapper"


# ---------------------------------------------------------------------------
# parity: the reference's and the port's implementation of each shared pass
# ---------------------------------------------------------------------------

from tools.parseclint import FileCtx as RefFileCtx  # noqa: E402
from tools.parseclint.passes import (  # noqa: E402
    assert_hazard as ref_assert_hazard, evloop_blocking as ref_evloop,
    except_hygiene as ref_except, hot_path as ref_hot,
    journal_schema as ref_journal, lock_discipline as ref_lock,
    mca_knobs as ref_mca, prom_metrics as ref_prom)

_PER_FILE = {
    "lock_discipline": (ref_lock, lock_discipline),
    "evloop_blocking": (ref_evloop, evloop_blocking),
    "hot_path": (ref_hot, hot_path),
    "except_hygiene": (ref_except, except_hygiene),
    "assert_hazard": (ref_assert_hazard, assert_hazard),
}
_TREE = {
    "mca_knobs": (ref_mca, mca_knobs),
    "prom_metrics": (ref_prom, prom_metrics),
    "journal_schema": (ref_journal, journal_schema),
}


def _port_sources():
    """(rel, source) of every module the port's lint scans, each also with
    its ``lint: ignore`` waivers disarmed (so the passes find something)
    under a ``.stripped`` rel."""
    out = []
    root = os.path.join(REPO, "parsec_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", "parseclint"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, REPO)
                with open(path, encoding="utf-8") as fh:
                    src = fh.read()
                out.append((rel, src))
                if "lint: ignore" in src:
                    out.append((rel[:-3] + "_stripped.py",
                                src.replace("lint: ignore", "lint-off")))
    return out


_PARSED = {}


def _parsed():
    """(rel, source, the reference's FileCtx, the port's FileCtx) of the
    corpus shapes and the port's sources, parsed once per session."""
    if not _PARSED:
        srcs = [(f"parsec_tpu_torch/core/snip{i}.py", textwrap.dedent(s))
                for i, s in enumerate(_SNIPPETS)] + _port_sources()
        _PARSED["all"] = [
            (rel, src, RefFileCtx("/" + rel, _ref_rel(rel), src),
             FileCtx("/" + rel, rel, src)) for rel, src in srcs]
    return _PARSED["all"]


def _ref_rel(rel):
    return "parsec_tpu/" + rel[len("parsec_tpu_torch/"):] \
        if rel.startswith("parsec_tpu_torch/") else rel


def _key(f, from_ref):
    path = f.path
    if from_ref and path.startswith("parsec_tpu/"):
        path = "parsec_tpu_torch/" + path[len("parsec_tpu/"):]
    return (path, f.line, f.pass_id, f.message)


_SNIPPETS = [
    _LOCKED_CLASS.replace("__BODY__", b) for b in (
        "self._seq += 1", "self._handles.pop(1, None)",
        "with self._lock:\n                self._seq += 1")] + [
    """
        import time, select

        class EvCE:
            FUNNELLED = True

            def heartbeat_tick(self):
                for r in self._peers:
                    self._hb_send(r)

            def _hb_send(self, r):
                self._peers[r].sendmsg([b"hb"])
                select.select([], [r], [], 0)
                time.sleep(0.1)
                self._lk.acquire()
    """,
    """
        def complete_execution(es, task, failed=False):
            tp = task.taskpool
            tp.termdet.taskpool_addto_nb_tasks(tp, -1)
            with es._lock:
                pass
    """,
    """
        import os
        from parsec_tpu_torch.core.errors import PeerFailedError

        params.register("comm_dead_knob", 1, "h")
        v = params.get("comm_fooo", 1)
        w = params.get("comm_ici_permute_min", 7)
        x = os.environ.get("PARSEC_MCA_COMM_FOOO")
        jr.emit("bogus_event", pool=1)
        self.context.journal.emit(etype, pool=1)

        TAGS = {"ACT": 1}
        assert TAGS["ACT"] == 1

        def push(self, q):
            assert q.pop() == 1
            try:
                self.send()
            except PeerFailedError:
                pass
            try:
                self.flush()
            except Exception as exc:
                self.context.record_error(exc, None)
    """,
]


@pytest.mark.parametrize("name", sorted(_PER_FILE) + sorted(_TREE))
def test_pass_parity_with_reference(name, tmp_path):
    """The port's copy of each shared pass reports exactly what the
    reference's does — same lines, pass ids and messages, paths mapped
    between ``parsec_tpu/`` and ``parsec_tpu_torch/`` — over the corpus
    shapes and the port's own sources (waivers disarmed).  The tree-level
    passes run on synthetic trees under ``tmp_path`` holding those
    sources and copies of the real README.md and COMPONENTS.md."""
    parsed = _parsed()
    if name in _PER_FILE:
        ref, port = _PER_FILE[name]
        got_ref, got_port = [], []
        for _rel, _src, ref_ctx, port_ctx in parsed:
            got_ref += [_key(f, True) for f in ref.check(ref_ctx)]
            got_port += [_key(f, False) for f in port.check(port_ctx)]
    else:
        ref, port = _TREE[name]
        results = []
        for impl, root, mapper in ((ref, tmp_path / "ref", _ref_rel),
                                   (port, tmp_path / "port", lambda r: r)):
            root.mkdir()
            for doc in ("README.md", "COMPONENTS.md"):
                with open(os.path.join(REPO, doc), encoding="utf-8") as fh:
                    (root / doc).write_text(fh.read(), encoding="utf-8")
            ctxs = {}
            for rel, src, ref_ctx, port_ctx in parsed:
                r = mapper(rel)
                if r.endswith(("prof/metrics.py", "prof/liveattr.py",
                               "core/recovery.py")):
                    (root / r).parent.mkdir(parents=True, exist_ok=True)
                    (root / r).write_text(src, encoding="utf-8")
                ctxs[r] = ref_ctx if impl is ref else port_ctx
            facts = [impl.facts(c) for c in ctxs.values()]
            results.append(sorted(_key(f, impl is ref) for f in
                                  impl.tree_check(facts, str(root), ctxs)))
        got_ref, got_port = results
    assert got_port == got_ref
    # the comparison saw findings, not two empty lists
    assert got_port, name


# ---------------------------------------------------------------------------
# the six findings the port's lint found on landing, each repaired
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rel,pass_mod", [
    ("parsec_tpu_torch/tools/chaos.py", assert_hazard),
    ("parsec_tpu_torch/parallel/dryrun.py", assert_hazard),
    ("parsec_tpu_torch/core/context.py", except_hygiene),
    ("parsec_tpu_torch/core/scheduling.py", hot_path),
], ids=["chaos-assert", "dryrun-assert", "context-except", "scheduling-hot"])
def test_repaired_sites_are_clean(rel, pass_mod):
    """chaos.py's pre-degrade wait and dryrun.py's two checks no longer
    call inside an assert; flush_ici routes a failed placement to its
    pools (no context-global record); the cancelled-pool discard carries
    the reference's waiver again."""
    path = os.path.join(REPO, rel)
    with open(path, encoding="utf-8") as fh:
        ctx = FileCtx(path, rel, fh.read())
    assert [f.render() for f in pass_mod.check(ctx)] == []


def test_scheduling_waiver_is_the_references_word_for_word():
    waiver = "# lint: ignore[PCL-HOT] cancelled-pool discard: cold path"
    for pkg in ("parsec_tpu", "parsec_tpu_torch"):
        with open(os.path.join(REPO, pkg, "core", "scheduling.py"),
                  encoding="utf-8") as fh:
            assert fh.read().count(waiver) == 1, pkg


def _call_names(fn_name, path, optimize):
    """Attribute names loaded in function ``fn_name`` of ``path`` compiled
    at ``optimize`` (2 = ``python -OO``: asserts and docstrings gone)."""
    import dis
    with open(path, encoding="utf-8") as fh:
        code = compile(fh.read(), path, "exec", optimize=optimize)
    todo, names = [code], []
    while todo:
        co = todo.pop()
        for c in co.co_consts:
            if hasattr(c, "co_code"):
                todo.append(c)
        if co.co_name == fn_name:
            names += [i.argval for i in dis.get_instructions(co)
                      if i.opname in ("LOAD_ATTR", "LOAD_METHOD")]
    return sorted(names)


@pytest.mark.parametrize("rel,fn,calls", [
    ("parsec_tpu_torch/tools/chaos.py", "degrade_workload", ("wait",)),
    ("parsec_tpu_torch/parallel/dryrun.py", "dryrun_multichip",
     ("all", "isfinite")),
    ("parsec_tpu_torch/parallel/dryrun.py", "_dense_factorizations",
     ("max", "abs", "tril")),
], ids=["chaos-degrade", "dryrun-halo", "dryrun-geqrf"])
def test_repaired_calls_survive_python_O(rel, fn, calls):
    """Under ``python -O`` the degrade workload still waits for its
    pre-degrade job before the drain audit reads that job's gang stamp,
    and the dryrun still computes what its checks read: each call is in
    the optimized bytecode as often as in the plain one."""
    path = os.path.join(REPO, rel)
    plain, opt = _call_names(fn, path, 0), _call_names(fn, path, 2)
    assert plain, f"{fn} not found in {rel}"
    for c in calls:
        assert opt.count(c) == plain.count(c) >= 1, (c, plain, opt)


# ---------------------------------------------------------------------------
# the port's baseline and CLI
# ---------------------------------------------------------------------------

def test_baseline_holds_only_reasoned_divergences():
    """Every key of the port's baseline sits under its reason lines, and
    today the one key is the COMPONENTS.md row naming the native
    fallback family the port deliberately does not serve."""
    from parsec_tpu_torch.tools.parseclint.engine import (
        DEFAULT_BASELINE, baseline_reasons, load_baseline)
    keys = load_baseline(DEFAULT_BASELINE)
    reasons = baseline_reasons(DEFAULT_BASELINE)
    assert set(keys) == set(reasons)
    for key in keys:
        assert reasons[key], f"baseline key without a reason: {key}"
        assert "ROADMAP Queue 3" in " ".join(reasons[key]), key
    assert [k.split("|")[:2] for k in keys] == [["COMPONENTS.md",
                                                 "PCL-PROM"]]
    assert "parsec_sched_native_fallbacks_total" in next(iter(keys))


def test_write_baseline_keeps_reasons(tmp_path):
    from parsec_tpu_torch.tools.parseclint.engine import (
        baseline_reasons, load_baseline, write_baseline)
    f1 = Finding("a.py", 10, "PCL-LOCK", "msg one")
    f2 = Finding("b.py", 20, "PCL-MCA", "msg two")
    path = str(tmp_path / "baseline.txt")
    write_baseline([f1], path)
    text = open(path, encoding="utf-8").read().replace(
        f1.baseline_key(), "# why one\n" + f1.baseline_key())
    open(path, "w", encoding="utf-8").write(text)
    write_baseline([f1, f2], path)
    reasons = baseline_reasons(path)
    assert reasons[f1.baseline_key()] == ["# why one"]
    assert reasons[f2.baseline_key()] == []
    assert set(load_baseline(path)) == {f1.baseline_key(),
                                        f2.baseline_key()}


def test_cli_default_path_is_the_port_and_imports_no_reference():
    """``python -m parsec_tpu_torch.tools.parseclint`` lints the port by
    default, exits 0 on the clean tree with its one baselined divergence,
    and loads nothing of jax, parsec_tpu or the root tools package."""
    import subprocess
    probe = ("import runpy, sys\n"
             "sys.argv = ['parseclint', '--serial']\n"
             "try:\n"
             "    runpy.run_module('parsec_tpu_torch.tools.parseclint',"
             " run_name='__main__')\n"
             "except SystemExit as e:\n"
             "    rc = e.code\n"
             "bad = sorted(m for m in sys.modules if m == 'jax' or"
             " m.startswith(('jax.', 'parsec_tpu.', 'tools.'))"
             " or m in ('parsec_tpu', 'tools'))\n"
             "print('RC', rc, 'BAD', bad)\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert "RC 0 BAD []" in out.stdout, (out.stdout, out.stderr)
    assert "parseclint: clean, 1 baselined" in out.stderr, out.stderr
