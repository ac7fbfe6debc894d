#!/bin/sh
# Pre-merge bench smoke of the port, on the CPU: the port's lint, its
# native sources built from a clean tree, then the host-side probes of
# the port's bench entry (python -m parsec_tpu_torch.bench --device cpu),
# each diffed by the port's bench guard against the last port-side
# artifact (BENCH_TORCH_r*.json at the repository's root), and the
# port's chaos tool on its seeded fault plans.
#
# The twin of tools/premerge_bench.sh (the JAX package's), with the same
# gates and defaults:
#   * the tracer-overhead gate: the tasks probe again with the task
#     profiler and the causal tracer installed (PARSEC_BENCH_TRACE=1),
#     bounded ABSOLUTE at $trace_bound us/task;
#   * the native-vs-python A/B on the tasks probe (native must be active
#     and beat the fallback by $native_margin) and on the data-carrying
#     ntasks probe ($ntasks_margin, and no bailout on the native path);
#   * the aggregate multi-rank probe over shm (no comm_buffered bailout);
#   * the shm transport's rtt probe;
#   * the telemetry gate (metrics registry + flight recorder + live
#     attribution armed, <= $telemetry_bound us/task) and the journal
#     gate (<= $journal_bound us/task);
#   * the fabric probe, and a carved-subset smoke: three tenants on
#     disjoint 2-module subsets of eight CPU-backed modules plus one
#     temporal-sharing job, the journal audited (F1-F3);
#   * chaos: the quick catalog with journal audits, the minimal-vs-full
#     replay A/B, a soak of four random recover schedules, the degrade
#     scenario.
# Deliberate differences: every probe runs on the CPU (--device cpu, the
# ranks too), and while no BENCH_TORCH_r*.json exists a probe's line is
# printed but not diffed (the JAX package's BENCH_r*.json are lines of
# another program; bench_guard refuses them).
#
# Usage:  sh parsec_tpu_torch/tools/premerge_bench.sh [threshold] \
#             [trace_bound_us] [telemetry_bound_us] [native_margin] \
#             [journal_bound_us] [ntasks_margin]
#         defaults 0.15, 8.0, 0.5, 1.05, 0.3, 1.3 (the reference's)
set -e
repo="$(cd "$(dirname "$0")/../.." && pwd)"
cd "$repo"
threshold="${1:-0.15}"
trace_bound="${2:-8.0}"
telemetry_bound="${3:-0.5}"
native_margin="${4:-1.05}"
journal_bound="${5:-0.3}"
ntasks_margin="${6:-1.3}"
rc=0
tmp="$(mktemp -d)"
trap 'rm -rf "$tmp"' EXIT
export PARSEC_BENCH_DEVICE=cpu

bench() {   # bench OUT [VAR=value ...]: one line of the bench entry
    out="$1"
    shift
    env "$@" python -m parsec_tpu_torch.bench --device cpu > "$out" \
        2> "$out.err"
}

guard() {   # guard FILE: diff a line against the last port-side artifact
    if ls "$repo"/BENCH_TORCH_r*.json > /dev/null 2>&1; then
        if ! python -m parsec_tpu_torch.tools.bench_guard "$1" \
                --repo "$repo" --threshold "$threshold"; then
            rc=1
        fi
    else
        echo "premerge: no BENCH_TORCH_r*.json under $repo: not diffed:"
        tail -n 1 "$1"
    fi
}

check() {   # check NAME FILE... <<EOF python: a gate over the lines
    name="$1"
    shift
    if ! python - "$@"; then
        echo "premerge: $name gate FAILED"
        rc=1
    fi
}

echo "== premerge gate: parseclint (static analysis) =="
if ! python -m parsec_tpu_torch.tools.parseclint; then
    echo "premerge: parseclint found violations (fix them, or baseline"
    echo "          a deliberate divergence in its baseline.txt)"
    exit 1
fi

echo "== premerge gate: native build-from-source =="
# the .so files build on demand (gitignored): a source that no longer
# compiles must fail here, not in a fresh checkout's first Context
nat="$repo/parsec_tpu_torch/native"
inc="$(python -c 'import sysconfig; print(sysconfig.get_paths()["include"])')"
if ! g++ -O2 -std=c++17 -fPIC -Wall -Wextra -shared "$nat/core.cpp" \
        -o "$tmp/core.so"; then
    echo "premerge: native build-from-source FAILED (core.cpp)"
    exit 1
fi
for ext in schedext commext pinsext; do
    if ! g++ -O2 -fPIC -shared "-I$inc" "$nat/$ext.c" -o "$tmp/$ext.so"; then
        echo "premerge: native build-from-source FAILED ($ext.c)"
        exit 1
    fi
done

for mode in tasks rtt bw; do
    echo "== premerge probe: $mode =="
    if bench "$tmp/$mode.json" PARSEC_BENCH_APP=$mode; then
        guard "$tmp/$mode.json"
    else
        echo "premerge: $mode probe FAILED to run"
        tail -n 5 "$tmp/$mode.json.err"
        rc=1
    fi
done

LAST='
import json, sys
def last(path):
    return json.loads(open(path).read().strip().splitlines()[-1])
'

echo "== premerge probe: tracer overhead (tasks, tracing on) =="
if bench "$tmp/tasks_on.json" PARSEC_BENCH_APP=tasks PARSEC_BENCH_TRACE=1
then
    check tracer "$tmp/tasks.json" "$tmp/tasks_on.json" "$trace_bound" <<EOF
$LAST
off, on = last(sys.argv[1])["value"], last(sys.argv[2])["value"]
cost = (1e6 / on - 1e6 / off) if on and off else float("inf")
print(f"premerge: tracer cost {cost:+.2f} us/task (bound {sys.argv[3]} "
      f"us; off {off:.0f} -> on {on:.0f} tasks/s)")
sys.exit(1 if cost > float(sys.argv[3]) else 0)
EOF
else
    echo "premerge: traced tasks probe FAILED to run"
    rc=1
fi

echo "== premerge probe: native-vs-python A/B (tasks) =="
if bench "$tmp/tasks_fb.json" PARSEC_BENCH_APP=tasks PARSEC_MCA_SCHED_NATIVE=0
then
    guard "$tmp/tasks_fb.json"
    check "native tasks A/B" "$tmp/tasks.json" "$tmp/tasks_fb.json" \
        "$native_margin" <<EOF
$LAST
nat, fb = last(sys.argv[1]), last(sys.argv[2])
active = (nat.get("native") or {}).get("sched_native")
ratio = nat["value"] / fb["value"] if fb["value"] else float("inf")
print(f"premerge: sched native A/B {fb['value']:.0f} -> "
      f"{nat['value']:.0f} tasks/s (x{ratio:.2f}, need >= "
      f"x{sys.argv[3]}; native active: {active})")
sys.exit(0 if active == 1 and ratio >= float(sys.argv[3]) else 1)
EOF
else
    echo "premerge: fallback tasks probe FAILED to run"
    rc=1
fi

echo "== premerge probe: native-vs-python A/B (ntasks, data-carrying) =="
if bench "$tmp/ntasks.json" PARSEC_BENCH_APP=ntasks && \
        bench "$tmp/ntasks_fb.json" PARSEC_BENCH_APP=ntasks \
            PARSEC_MCA_SCHED_NATIVE=0; then
    guard "$tmp/ntasks.json"
    check "native ntasks A/B" "$tmp/ntasks.json" "$tmp/ntasks_fb.json" \
        "$ntasks_margin" <<EOF
$LAST
nat, fb = last(sys.argv[1]), last(sys.argv[2])
active = (nat.get("native") or {}).get("sched_native")
bail = nat.get("bailouts") or {}
ratio = nat["value"] / fb["value"] if fb["value"] else float("inf")
print(f"premerge: non-trivial chain A/B {fb['value']:.0f} -> "
      f"{nat['value']:.0f} tasks/s (x{ratio:.2f}, need >= "
      f"x{sys.argv[3]}; native active: {active}; bailouts: "
      f"{bail or 'none'})")
sys.exit(0 if active == 1 and not bail and ratio >= float(sys.argv[3])
         else 1)
EOF
else
    echo "premerge: ntasks probe FAILED to run"
    rc=1
fi

echo "== premerge probe: aggregate multi-rank throughput (shm) =="
if bench "$tmp/aggregate.json" PARSEC_BENCH_APP=aggregate; then
    guard "$tmp/aggregate.json"
    check aggregate "$tmp/aggregate.json" <<EOF
$LAST
obj = last(sys.argv[1])
bail = obj.get("bailouts") or {}
print(f"premerge: aggregate {obj['value']:.0f} tasks/s over "
      f"{obj.get('ranks')} ranks (eff {obj.get('scaling_efficiency')}; "
      f"bailouts: {bail or 'none'}; skipped: {obj.get('skipped')})")
sys.exit(1 if bail.get("comm_buffered") else 0)
EOF
else
    echo "premerge: aggregate probe FAILED to run"
    rc=1
fi

echo "== premerge probe: shm transport rtt =="
if bench "$tmp/shm_rtt.json" PARSEC_BENCH_APP=rtt \
        PARSEC_MCA_COMM_TRANSPORT=shm; then
    guard "$tmp/shm_rtt.json"
else
    echo "premerge: shm rtt probe FAILED to run"
    rc=1
fi

for gate in telemetry journal; do
    echo "== premerge probe: $gate overhead =="
    if [ "$gate" = telemetry ]; then bound="$telemetry_bound"
    else bound="$journal_bound"; fi
    if bench "$tmp/$gate.json" PARSEC_BENCH_APP=$gate; then
        check "$gate" "$tmp/$gate.json" "$bound" "$gate" <<EOF
$LAST
obj = last(sys.argv[1])
cost = obj.get("overhead_us")
if cost is None:
    print(f"premerge: {sys.argv[3]} line carries no overhead_us")
    sys.exit(1)
print(f"premerge: {sys.argv[3]} cost {cost:.3f} us/task (bound "
      f"{sys.argv[2]} us; ratio {obj['value']:+.1%}; off "
      f"{obj.get('tasks_off')} -> armed {obj.get('tasks_on')} tasks/s)")
sys.exit(1 if cost > float(sys.argv[2]) else 0)
EOF
    else
        echo "premerge: $gate probe FAILED to run"
        rc=1
    fi
done

echo "== premerge probe: fabric serving (jobs/s + latency, self-audited) =="
if bench "$tmp/fabric.json" PARSEC_BENCH_APP=fabric; then
    guard "$tmp/fabric.json"
else
    echo "premerge: fabric probe FAILED to run"
    rc=1
fi

echo "== premerge probe: fabric carved-subset smoke (3 tenants, audited) =="
if ! python - <<'EOF'
import time
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.dsl.ptg import DATA, IN, OUT, PTG, Range, TASK
from parsec_tpu_torch.service.fabric import ServingFabric
from parsec_tpu_torch.tools import journal_audit

NT = 12


def chain_factory(i):
    def factory():
        A = TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
        A.data_of(0, 0).copy_on(0).payload[:] = 0.0
        p = PTG(f"smoke{i}", NT=NT)
        p.task("S", k=Range(0, NT - 1)) \
            .affinity(lambda k, A=A: A(0, 0)) \
            .flow("T", "RW",
                  IN(DATA(lambda A=A: A(0, 0)), when=lambda k: k == 0),
                  IN(TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
                  OUT(TASK("S", "T", lambda k: dict(k=k + 1)),
                      when=lambda k: k < NT - 1),
                  OUT(DATA(lambda A=A: A(0, 0)),
                      when=lambda k: k == NT - 1)) \
            .body(lambda T: (time.sleep(0.02), T + 1.0)[1])
        return p.build()
    return factory


with ServingFabric(device="cpu:8", nb_cores=4, max_active=8) as svc:
    mesh = len(svc.context.accelerator_spaces())
    if mesh < 7:
        raise SystemExit(f"premerge: fabric smoke wants 8 modules, got "
                         f"{mesh}")
    excl = [svc.submit(chain_factory(i), devices=2, name=f"excl{i}")
            for i in range(3)]
    shared = svc.submit(chain_factory(9), name="shared")
    for j in excl + [shared]:
        if not j.wait(timeout=120.0):
            raise SystemExit(f"premerge: fabric smoke job {j} hung")
    bundle = {0: [svc.context.journal.snapshot()]}

evs = bundle[0][0]["events"]
excl_ids = {j.job_id for j in excl}
placed, released = {}, []
for idx, ev in enumerate(evs):
    if (ev.get("e") == "fabric_place" and not ev.get("shared")
            and ev.get("job") in excl_ids):
        placed.setdefault(ev["job"], idx)
        if len(ev.get("devices") or ()) != 2:
            raise SystemExit(f"premerge: tenant {ev['job']} placed on "
                             f"{ev.get('devices')} (wanted 2 modules)")
    elif ev.get("e") == "fabric_release" and ev.get("job") in excl_ids:
        released.append(idx)
if len(placed) != 3:
    raise SystemExit(f"premerge: {len(placed)}/3 tenants placed "
                     "exclusively")
if not any(ev.get("e") == "fabric_place" and ev.get("shared")
           and ev.get("job") == shared.job_id for ev in evs):
    raise SystemExit("premerge: temporal-sharing job never placed")
if released and max(placed.values()) > min(released):
    raise SystemExit("premerge: tenants never held their subsets "
                     "concurrently (3rd placement after 1st release)")
violations = journal_audit.audit(bundle)
if violations:
    raise SystemExit("premerge: fabric journal audit FAILED: "
                     + "; ".join(violations[:3]))
print(f"premerge: fabric smoke 3 exclusive tenants + 1 shared on {mesh} "
      f"modules, concurrent placements, audit clean")
EOF
then
    echo "premerge: fabric carved-subset smoke FAILED"
    rc=1
fi

chaos() {
    if ! python -m parsec_tpu_torch.tools.chaos --device cpu "$@"; then
        rc=1
    fi
}
echo "== premerge probe: chaos (seeded fault plans, no-hang invariant) =="
chaos --seeds 8 --quick --audit-journal
echo "== premerge probe: recovery minimal-vs-full replay A/B =="
chaos --ab-minimal
echo "== premerge probe: chaos soak (random recover schedules) =="
chaos --soak 4
echo "== premerge probe: chaos degrade (drain-before-death, audited) =="
chaos --degrade
exit $rc
