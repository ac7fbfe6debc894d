"""The port's VP map, thread placement and schedulers against the JAX
package's.

Twins of tests/test_vpmap_sched.py (reference: parsec/vpmap.{c,h},
bindthread.c, the sched_lhq/llp modules, the display_stats hook
sched.h:299): each map is built by both packages from the same spec and
compared stream by stream; each scheduler case runs the same chain on
both and compares the result and the statistics line's shape.  Past the
twins: the Context's streams take their ``vp_id`` from the map, worker
binding under ``runtime_bind_threads``, lhq's groups under a map the
synthetic grouping cannot produce (the port builds the map before the
scheduler installs; the JAX package after, so its lhq falls back to the
synthetic groups), and a sweep of three DAG shapes over every registered
scheduler component of the port against the JAX package's.  The port
runs with ``device="cpu"``.
"""

import contextlib
import os

import numpy as np
import pytest

import parsec_tpu.core.context as jax_context
import parsec_tpu.core.vpmap as jax_vpmap
import parsec_tpu.data.matrix as jax_matrix
import parsec_tpu.dsl.ptg.api as jax_ptg
import parsec_tpu_torch.core.context as port_context
import parsec_tpu_torch.core.vpmap as port_vpmap
import parsec_tpu_torch.data.matrix as port_matrix
import parsec_tpu_torch.dsl.ptg.api as port_ptg
from parsec_tpu.utils.mca import params as jax_params
from parsec_tpu_torch.utils.mca import components as port_components
from parsec_tpu_torch.utils.mca import params as port_params

import test_torch_runtime as RT

PKGS = {"jax": (jax_context, jax_vpmap, jax_matrix, jax_ptg, {}),
        "port": (port_context, port_vpmap, port_matrix, port_ptg,
                 {"device": "cpu"})}


@contextlib.contextmanager
def knobs(**kv):
    """Set MCA knobs in both packages for the duration."""
    for p in (jax_params, port_params):
        for k, v in kv.items():
            p.set(k, v)
    try:
        yield
    finally:
        for p in (jax_params, port_params):
            for k in kv:
                p.unset(k)


def placement(vm, n):
    return (vm.nb_threads, vm.nb_vps, [vm.vp_of(i) for i in range(n)],
            [vm.core_of(i) for i in range(n)])


def both_maps(build, n):
    """``build(VPMap)`` on each package: the placements must agree."""
    ref = placement(build(jax_vpmap.VPMap), n)
    got = placement(build(port_vpmap.VPMap), n)
    assert got == ref
    return got


def test_vpmap_flat():
    nb, nvp, vps, _ = both_maps(lambda M: M.from_flat(6), 6)
    assert (nb, nvp, vps) == (6, 1, [0] * 6)
    assert port_vpmap.VPMap.from_flat(6).threads_of_vp(0) == list(range(6))


def test_vpmap_from_parameters():
    _, nvp, vps, _ = both_maps(lambda M: M.from_parameters("2:2", 5), 5)
    assert (nvp, vps) == (2, [0, 0, 1, 1, 1])
    assert both_maps(lambda M: M.from_parameters("garbage", 3), 3)[1] == 1


def test_vpmap_from_hardware():
    nb, nvp, _, cores = both_maps(lambda M: M.from_hardware(4), 4)
    assert nb == 4 and nvp >= 1
    assert all(isinstance(c, (int, type(None))) for c in cores)


def test_bind_current_thread_roundtrip():
    if not hasattr(os, "sched_setaffinity"):
        pytest.skip("no sched_setaffinity on this platform")
    before = os.sched_getaffinity(0)
    core = sorted(before)[0]
    try:
        for mod in (jax_vpmap, port_vpmap):
            os.sched_setaffinity(0, before)
            assert mod.bind_current_thread(core)
            assert os.sched_getaffinity(0) == {core}
        assert port_vpmap.bind_current_thread(None) is False
    finally:
        os.sched_setaffinity(0, before)


def _chain_value(pkg, scheduler, nb_cores=4):
    """An RW chain of NT tasks over one vector tile, each adding 1:
    (final value, the scheduler's statistics line)."""
    ctx_mod, _vp, mat, ptg, kw = PKGS[pkg]
    NT = 12
    V = mat.VectorTwoDimCyclic(mb=2, lm=2 * NT)
    for m, _ in V.local_tiles():
        V.data_of(m).copy_on(0).payload[:] = 0.0
    p = ptg.PTG("chain", NT=NT)
    p.task("S", k=ptg.Range(0, NT - 1)) \
        .affinity(lambda k, V=V: V(k)) \
        .flow("T", "RW",
              ptg.IN(ptg.DATA(lambda k, V=V: V(k)), when=lambda k: k == 0),
              ptg.IN(ptg.TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
              ptg.OUT(ptg.TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k, NT=NT: k < NT - 1),
              ptg.OUT(ptg.DATA(lambda k, V=V: V(k)),
                      when=lambda k, NT=NT: k == NT - 1)) \
        .body(lambda T: T + 1.0)
    with ctx_mod.Context(nb_cores=nb_cores, scheduler=scheduler,
                         **kw) as ctx:
        ctx.add_taskpool(p.build())
        ctx.wait(timeout=60)
        stats = ctx.scheduler.display_stats(None)
    val = RT._as_numpy(V.data_of(NT - 1).pull_to_host().payload)
    return val, stats


def _stat_fields(stats):
    name, _, rest = stats.partition(":")
    return name, dict(kv.split("=") for kv in rest.split())


def test_llp_multi_vp():
    """llp with 2 VPs x 2 streams: per-VP ring LIFOs + cross-VP steal."""
    with knobs(vpmap="2:2"):
        (jv, js), (pv, ps) = (_chain_value(k, "llp") for k in PKGS)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_allclose(pv, 12.0)
    assert "llp" in ps and "local=" in ps
    assert _stat_fields(ps)[1].keys() == _stat_fields(js)[1].keys()


def test_lhq_hierarchy_runs_and_reports():
    (jv, js), (pv, ps) = (_chain_value(k, "lhq") for k in PKGS)
    np.testing.assert_array_equal(pv, jv)
    for stats in (js, ps):
        name, got = _stat_fields(stats)
        assert name == "lhq"
        assert int(got["local"]) + int(got["steals"]) + \
            int(got["system"]) >= 12


def test_lfq_stats_nonempty():
    (jv, js), (pv, ps) = (_chain_value(k, "lfq", nb_cores=2) for k in PKGS)
    np.testing.assert_array_equal(pv, jv)
    assert js.startswith("lfq:") and ps.startswith("lfq:")


def test_worker_binding_smoke():
    """runtime_bind_threads=1 must not break execution (binding is
    best-effort; reference: parsec_bindthread)."""
    with knobs(runtime_bind_threads=1, vpmap="hw"):
        (jv, _), (pv, _) = (_chain_value(k, "lfq", nb_cores=2)
                            for k in PKGS)
    np.testing.assert_array_equal(pv, jv)
    np.testing.assert_allclose(pv, 12.0)


def _write_map(path):
    path.write_text(
        "# comment\n"
        ":2:0-1\n"          # every rank: VP of 2 threads on cores 0,1
        "0:1:3\n"           # rank 0 only: VP of 1 thread on core 3
        "1:4:4,5\n"         # rank 1 only: skipped on rank 0
    )
    return str(path)


def test_vpmap_from_file(tmp_path):
    """Reference vpmap file format (vpmap_init_from_file, vpmap.c:219)."""
    f = _write_map(tmp_path / "vps.map")
    _, nvp, vps, cores = both_maps(lambda M: M.from_file(f, 3, rank=0), 3)
    assert (nvp, vps, cores) == (2, [0, 0, 1], [0, 1, 3])
    _, nvp, _, cores = both_maps(lambda M: M.from_file(f, 6, rank=1), 6)
    assert nvp == 2 and cores == [0, 1, 4, 5, 4, 5]
    assert both_maps(lambda M: M.from_file(f, 5, rank=0), 5)[0] == 5
    missing = str(tmp_path / "nope.map")
    assert both_maps(lambda M: M.from_file(missing, 4), 4)[1] == 1


def test_vpmap_file_mca_selection(tmp_path):
    f = tmp_path / "v.map"
    f.write_text(":2:\n:2:\n")
    with knobs(vpmap=f"file:{f}"):
        _, nvp, vps, _ = both_maps(lambda M: M.from_mca(4), 4)
    assert nvp == 2 and vps == [0, 0, 1, 1]


def test_lhq_groups_follow_vpmap_topology():
    """lhq's mid-level hierarchy follows the vpmap's VP structure
    (reference: per-hwloc-level hbbuffer chains,
    sched_lhq_module.c:30-44)."""
    with knobs(vpmap="2:2", sched="lhq"):
        for ctx_mod, *_r, kw in PKGS.values():
            with ctx_mod.Context(nb_cores=4, **kw) as ctx:
                assert ctx.vpmap.nb_vps == 2
                gids = [ctx.scheduler._gid(t) for t in range(4)]
                assert gids == [ctx.vpmap.vp_of(t) for t in range(4)] \
                    == [0, 0, 1, 1]


def test_lhq_groups_read_the_map_the_context_built():
    """A map the synthetic pairs cannot produce ("2:1" on 4 streams:
    VPs [0, 1, 1, 1]): the port's lhq groups follow it; the JAX
    package's Context builds its map after the scheduler installed, so
    its lhq keeps the synthetic pairs."""
    with knobs(vpmap="2:1", sched="lhq"):
        gids = {}
        for pkg, (ctx_mod, *_r, kw) in PKGS.items():
            with ctx_mod.Context(nb_cores=4, **kw) as ctx:
                assert [ctx.vpmap.vp_of(t) for t in range(4)] == \
                    [0, 1, 1, 1]
                gids[pkg] = [ctx.scheduler._gid(t) for t in range(4)]
    assert gids == {"jax": [0, 0, 1, 1], "port": [0, 1, 1, 1]}


@pytest.mark.parametrize("spec,n,want", [("flat", 3, [0, 0, 0]),
                                         ("2:2", 4, [0, 0, 1, 1]),
                                         ("3:1", 4, [0, 1, 2, 2])])
def test_streams_take_vp_id_from_the_map(spec, n, want):
    """The Context reads ``vpmap``: each stream's ``vp_id`` is the map's
    (a ``from_parameters`` map for "a:b" specs)."""
    with knobs(vpmap=spec):
        for ctx_mod, *_r, kw in PKGS.values():
            with ctx_mod.Context(nb_cores=n, **kw) as ctx:
                assert [es.vp_id for es in ctx.streams] == want
                assert ctx.vpmap.nb_vps == max(want) + 1


def test_bound_workers_run_on_their_cores(tmp_path):
    """Under ``runtime_bind_threads`` 1 each worker pins itself to its
    map's core before it runs a task (a vpmap file names the cores);
    both packages observe the same affinity per stream."""
    if not hasattr(os, "sched_getaffinity"):
        pytest.skip("no sched_getaffinity on this platform")
    allowed = sorted(os.sched_getaffinity(0))
    f = tmp_path / "bind.map"
    f.write_text(f":1:{allowed[0]}\n:1:{allowed[-1]}\n")
    seen = {}
    with knobs(vpmap=f"file:{f}", runtime_bind_threads=1):
        for pkg, (ctx_mod, _vp, mat, ptg, kw) in PKGS.items():
            got = {}
            V = mat.VectorTwoDimCyclic(mb=1, lm=16)

            def body(T, es, got=got):
                got.setdefault(es.th_id, set()).update(
                    os.sched_getaffinity(0))

            p = ptg.PTG("bind")
            p.task("B", i=ptg.Range(0, 15)) \
                .affinity(lambda i, V=V: V(i)) \
                .flow("T", "RW", ptg.IN(ptg.DATA(lambda i, V=V: V(i))),
                      ptg.OUT(ptg.DATA(lambda i, V=V: V(i)))) \
                .body(body)
            with ctx_mod.Context(nb_cores=2, **kw) as ctx:
                ctx.add_taskpool(p.build())
                ctx.wait(timeout=60)
            seen[pkg] = got
    assert seen["port"].keys() <= {0, 1}
    for th, cores in seen["port"].items():
        assert cores == {allowed[0] if th == 0 else allowed[-1]}
        if th in seen["jax"]:
            assert seen["jax"][th] == cores


def test_discover_topology_from_sysfs(tmp_path):
    root = _fake_sysfs(str(tmp_path))
    topo = port_vpmap.discover_topology(root)
    assert topo == jax_vpmap.discover_topology(root)
    assert topo["cpus"] == list(range(8))
    assert topo["package"] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert topo["l2"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert topo["l1"] == [[c] for c in range(8)]


def test_from_hardware_follows_packages(tmp_path):
    root = _fake_sysfs(str(tmp_path))
    _, nvp, vps, cores = both_maps(
        lambda M: M.from_hardware(8, sysfs_root=root), 8)
    assert nvp == 2
    for vp, core in zip(vps, cores):
        assert core in ([0, 1, 2, 3] if vp == 0 else [4, 5, 6, 7])
    assert sorted(vps) == [0] * 4 + [1] * 4


def test_from_hardware_no_sysfs_falls_back_flat(tmp_path):
    none = str(tmp_path / "none")
    nb, nvp, _, _ = both_maps(
        lambda M: M.from_hardware(4, sysfs_root=none), 4)
    assert nb == 4 and nvp >= 1


def test_lhq_groups_follow_hardware_topology(tmp_path):
    """lhq's hierarchy comes from vpmap groups; with hw discovery the
    groups ARE the cache/package domains (sched_lhq_module.c:30-44)."""
    root = _fake_sysfs(str(tmp_path))
    _, _, vps, _ = both_maps(
        lambda M: M.from_hardware(8, sysfs_root=root), 8)
    by_vp = {}
    for i, vp in enumerate(vps):
        by_vp.setdefault(vp, []).append(i)
    assert len(by_vp) == 2 and all(len(v) == 4 for v in by_vp.values())


def _fake_sysfs(root, ncpu=8, pkgs=2, l3_groups=2, l2_share=2):
    """Synthesize a /sys/devices/system/cpu tree: ``pkgs`` packages,
    ``l3_groups`` shared-L3 islands, L2 shared by pairs."""
    base = os.path.join(root, "devices/system/cpu")
    per_pkg = ncpu // pkgs
    per_l3 = ncpu // l3_groups
    for c in range(ncpu):
        topo = os.path.join(base, f"cpu{c}", "topology")
        os.makedirs(topo, exist_ok=True)
        p0 = (c // per_pkg) * per_pkg
        with open(os.path.join(topo, "package_cpus_list"), "w") as f:
            f.write(f"{p0}-{p0 + per_pkg - 1}\n")
        cache = os.path.join(base, f"cpu{c}", "cache")
        l2 = (c // l2_share) * l2_share
        l3 = (c // per_l3) * per_l3
        specs = [(1, "Data", (c, c)), (1, "Instruction", (c, c)),
                 (2, "Unified", (l2, l2 + l2_share - 1)),
                 (3, "Unified", (l3, l3 + per_l3 - 1))]
        for i, (lvl, ty, (lo, hi)) in enumerate(specs):
            d = os.path.join(cache, f"index{i}")
            os.makedirs(d, exist_ok=True)
            for name, val in (("level", str(lvl)), ("type", ty),
                              ("shared_cpu_list", f"{lo}-{hi}")):
                with open(os.path.join(d, name), "w") as f:
                    f.write(val + "\n")
    return root


# -- every registered scheduler component, three DAG shapes -----------------

SCHEDULERS = port_components.available("sched")
SHAPES = {"rw_chain": RT._rw_chain, "fan_out": RT._fan_out,
          "ctl_only": RT._ctl_only}


def test_sweep_covers_the_jax_package_components():
    from parsec_tpu.utils.mca import components as jax_components
    assert sorted(SCHEDULERS) == sorted(jax_components.available("sched"))


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("sched", SCHEDULERS)
def test_every_scheduler_same_dag_same_results(sched, shape):
    """The runtime twin's DAG shapes (test_torch_runtime.py) on one
    scheduler component, in both packages: results, completions per
    class, tasks per the streams and the termdet's final counters."""
    with knobs(sched=sched):
        ref = RT._run("jax", SHAPES[shape])
        got = RT._run("port", SHAPES[shape])
    for name in ref[0]:
        np.testing.assert_array_equal(got[0][name], ref[0][name])
    assert got[1] == ref[1]
    assert got[2] == ref[2] == sum(ref[1].values())
    assert got[3] == ref[3] == (0, 0)
