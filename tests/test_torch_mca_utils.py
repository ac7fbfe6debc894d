"""The port's MCA parameter system, component repository, zone allocator,
mempool, output streams, info registry and debug history against the
JAX package's.

Twins of every case of tests/test_mca_utils.py (reference:
utils/mca_param.c, class/info.{c,h}, debug_marks.{c,h}): each case
runs the reference test's steps on both packages' modules and compares
what both observe — values, sources, selections, offsets, the text the
streams wrote — besides holding each to the reference test's asserts.
"""

import importlib
import os

import pytest

PKGS = ("parsec_tpu", "parsec_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _both(case, *args):
    """``case(pkg, *args)`` on both packages; their observations must
    agree.  Returns the port's."""
    got = {pkg: case(pkg, *args) for pkg in PKGS}
    assert got["parsec_tpu_torch"] == got["parsec_tpu"]
    return got["parsec_tpu_torch"]


def test_param_register_and_default():
    def case(pkg):
        r = _mod(pkg, "utils.mca").ParamRegistry()
        r.register("sched_lfq_queue_size", 4, "queue size")
        return r.get("sched_lfq_queue_size"), \
            r.source_of("sched_lfq_queue_size")
    assert _both(case) == (4, "default")


def test_param_precedence_env_over_file():
    def case(pkg):
        mca = _mod(pkg, "utils.mca")
        r = mca.ParamRegistry()
        os.environ["PARSEC_MCA_TEST_PRECEDENCE"] = "7"
        try:
            r.register("test_precedence", 1)
            seen = [(r.get("test_precedence"), r.source_of("test_precedence"))]
            r.set("test_precedence", 3, src=mca.SRC_FILE)
            seen.append(r.get("test_precedence"))       # env beats file
            r.set("test_precedence", 9)                 # override beats env
            seen.append((r.get("test_precedence"),
                         r.source_of("test_precedence")))
        finally:
            del os.environ["PARSEC_MCA_TEST_PRECEDENCE"]
        return seen
    assert _both(case) == [(7, "env"), 7, (9, "override")]


def test_param_set_before_register():
    def case(pkg):
        r = _mod(pkg, "utils.mca").ParamRegistry()
        r.set("late_param", "5")
        r.register("late_param", 0)
        return r.get("late_param")
    assert _both(case) == 5       # coerced to the registered int type


def test_param_type_coercion_bool():
    def case(pkg):
        r = _mod(pkg, "utils.mca").ParamRegistry()
        r.register("device_tpu_enabled", True)
        r.set("device_tpu_enabled", "0")
        off = r.get("device_tpu_enabled")
        r.set("device_tpu_enabled", "yes")
        return off, r.get("device_tpu_enabled")
    off, on = _both(case)
    assert off is False and on is True


def test_param_cmdline_and_dump():
    def case(pkg):
        r = _mod(pkg, "utils.mca").ParamRegistry()
        r.register("sched", "", "scheduler selection")
        rest = r.parse_cmdline(["prog", "--mca", "sched", "spq",
                                "positional"])
        dumped = any("sched" in line for line in r.dump())
        with pytest.raises(ValueError):
            r.parse_cmdline(["--mca", "sched"])
        return rest, r.get("sched"), dumped, r.dump()
    rest, sched, dumped, _dump = _both(case)
    assert rest == ["prog", "positional"] and sched == "spq" and dumped


def test_param_keyval_file(tmp_path):
    f = tmp_path / "mca.conf"
    f.write_text("# comment\nsched = lfq\ndebug_verbose 5\n")

    def case(pkg):
        r = _mod(pkg, "utils.mca").ParamRegistry()
        n = r.load_keyval_file(str(f))
        r.register("sched", "")
        r.register("debug_verbose", 1)
        return n, r.get("sched"), r.get("debug_verbose"), \
            r.source_of("sched")
    assert _both(case) == (2, "lfq", 5, "file")


def test_component_repository_selection():
    def case(pkg):
        mca = _mod(pkg, "utils.mca")
        r = mca.ParamRegistry()
        repo = mca.ComponentRepository(r)
        repo.add("sched", "gd", "GD", priority=10)
        repo.add("sched", "lfq", "LFQ", priority=50)
        seen = [repo.available("sched"), repo.select("sched")]
        r.set("sched", "gd")
        seen.append(repo.select("sched"))
        seen.append(repo.select("sched", requested="nope,lfq")[0])
        with pytest.raises(KeyError):
            repo.select("sched", requested="missing")
        return seen
    assert _both(case) == [["lfq", "gd"], ("lfq", "LFQ"), ("gd", "GD"),
                           "lfq"]


def test_zone_allocator():
    def case(pkg):
        z = _mod(pkg, "utils.zone_alloc").ZoneAllocator(1024, unit_bytes=64)
        a = z.malloc(100)   # 2 units
        b = z.malloc(64)    # 1 unit
        seen = [a, b, z.used_bytes()]
        z.free(a)
        c = z.malloc(128)   # reuses the coalesced hole at 0
        seen.append(c)
        z.free(b)
        z.free(c)
        seen += [z.check_defrag(), z.malloc(2048)]
        with pytest.raises(ValueError):
            z.free(64)      # not a live segment start
        return seen
    assert _both(case) == [0, 128, 192, 0, True, None]


def test_mempool_reuse():
    def case(pkg):
        made = []
        pool = _mod(pkg, "utils.mempool").MemoryPool(
            factory=lambda: made.append(1) or {"x": 0},
            reset=lambda o: o.update(x=0))
        o1 = pool.alloc()
        o1["x"] = 5
        pool.release(o1)
        o2 = pool.alloc()
        return o2 is o1, o2["x"], len(made)
    assert _both(case) == (True, 0, 1)


def test_output_streams(tmp_path, capsys):
    def case(pkg):
        out = _mod(pkg, "utils.output").Output()
        logfile = tmp_path / f"{pkg}.log"
        sid = out.open(prefix="comm", verbosity=2, filename=str(logfile))
        out.emit(sid, 1, "inform", "hello")
        out.emit(sid, 9, "debug", "too verbose, dropped")
        out.set_verbosity(sid, 9)
        verb = out.get_verbosity(sid)
        out.emit(sid, 9, "debug", "now visible")
        out.close(sid)
        text = logfile.read_text()
        return verb, [w in text for w in ("hello", "now visible",
                                          "dropped")]
    assert _both(case) == (9, [True, True, False])


def test_fatal_raises():
    for pkg in PKGS:
        out = _mod(pkg, "utils.output")
        with pytest.raises(out.FatalError) as ei:
            out.fatal("boom %d", 7)
        assert "boom 7" in str(ei.value), pkg


def test_param_read_only_ignores_pending_and_env():
    def case(pkg):
        os.environ["PARSEC_MCA_COMM_RANK"] = "99"
        try:
            r = _mod(pkg, "utils.mca").ParamRegistry()
            r.set("comm_rank", 50)  # pre-registration override attempt
            r.register("comm_rank", 0, read_only=True)
            v = r.get("comm_rank")
            with pytest.raises(ValueError):
                r.set("comm_rank", 7)
        finally:
            del os.environ["PARSEC_MCA_COMM_RANK"]
        return v
    assert _both(case) == 0


def test_param_int_coercion_edge_cases():
    def case(pkg):
        r = _mod(pkg, "utils.mca").ParamRegistry()
        r.register("n_threads", 1)
        seen = []
        for v in ("010", "0x10", 2.7):
            r.set("n_threads", v)
            seen.append(r.get("n_threads"))
        return seen
    assert _both(case) == [10, 16, 2]


def test_zone_smaller_than_unit_rejected():
    for pkg in PKGS:
        with pytest.raises(ValueError):
            _mod(pkg, "utils.zone_alloc").ZoneAllocator(100, unit_bytes=512)


def test_logfile_has_no_ansi(tmp_path):
    def case(pkg):
        out = _mod(pkg, "utils.output").Output()
        path = tmp_path / f"{pkg}.log"
        sid = out.open(verbosity=5, filename=str(path))
        out.emit(sid, 1, "inform", "plain")
        out.close(sid)
        text = path.read_text()
        return "\x1b[" in text, "plain" in text
    assert _both(case) == (False, True)


# -- info registry (reference: class/info.{c,h}) ----------------------------

def test_info_space_and_object_array():
    def case(pkg):
        info = _mod(pkg, "utils.info")
        sp = info.InfoSpace("t")
        iid = sp.register("streams", constructor=lambda owner: {"n": owner})
        seen = [sp.register("streams") == iid]          # idempotent
        arr = info.InfoObjectArray(sp, owner=7)
        seen.append(arr.get("streams"))                 # lazy constructor
        arr.set("streams", "override")
        seen += [arr.get(iid), arr.get("unknown", default=3)]
        sp.unregister("streams")
        arr2 = info.InfoObjectArray(sp, owner=1)
        seen.append(arr2.get("streams", default="gone"))
        return seen
    assert _both(case) == [True, {"n": 7}, "override", 3, "gone"]


def test_info_on_taskpool_and_device():
    def case(pkg):
        info = _mod(pkg, "utils.info")
        info.taskpool_info.register("userdata")
        tp = _mod(pkg, "core.taskpool").Taskpool("t")
        tp.info.set("userdata", 42)
        info.device_info.register("workspace",
                                  constructor=lambda d: [d.name])
        host = _mod(pkg, "devices.device").HostDevice()
        return tp.info.get("userdata"), host.info.get("workspace")
    assert _both(case) == (42, ["cpu"])


# -- debug history + paranoia tiers (reference: debug_marks.{c,h},
# PARSEC_DEBUG_PARANOID) ----------------------------------------------------

def test_debug_history_ring_and_tiers():
    def case(pkg):
        dh = _mod(pkg, "utils.debug_history")
        params = _mod(pkg, "utils.mca").params
        dh.clear_history()
        dh.refresh_tier()
        seen = [dh.paranoid(1)]
        dh.mark("dropped %d", 1)               # tier 0: not recorded
        seen.append(dh.dump_history())
        params.set("debug_paranoid", 1)
        params.set("debug_history_size", 4)
        dh.refresh_tier()
        try:
            seen += [dh.paranoid(1), dh.paranoid(2)]
            for i in range(9):
                dh.mark("msg %d", i)
            hist = dh.dump_history()
            seen += [len(hist), "msg 8" in hist[-1],
                     ["msg %d" % i in h for i, h in zip(range(5, 9), hist)]]
        finally:
            params.unset("debug_paranoid")
            params.unset("debug_history_size")
            dh.refresh_tier()
            dh.clear_history()
        return seen
    assert _both(case) == [False, [], True, False, 4, True,
                           [True] * 4]


def test_show_help_templates(capfd):
    def case(pkg):
        out = _mod(pkg, "utils.output")
        text = out.show_help("device-oom", budget=64, nbytes=1024)
        err = capfd.readouterr().err
        out.register_help(f"custom-topic-{pkg}", "hello {who}")
        return ("64 MiB" in text, "1024-byte" in text, "device-oom" in err,
                out.show_help(f"custom-topic-{pkg}", warn=False,
                              who="world"),
                "no help text" in out.show_help("missing", warn=False))
    assert _both(case) == (True, True, True, "hello world", True)
