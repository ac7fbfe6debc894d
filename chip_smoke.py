"""Drive the PyTorch/CUDA port (``parsec_tpu_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases (any failure propagates; the script then exits non-zero and prints
no result line):

1. card     — ``nvidia-smi`` name and power limit, ``torch.cuda`` device name;
2. build    — compile every kernel from ``parsec_tpu_torch/csrc`` with nvcc
              (one process per source, all started together);
3. kernels  — hold each kernel against its plain PyTorch version on the
              card at every shape, C and alpha the paths give it (and
              check which route K1 took; K1's transposed-B, bf16-C
              variant at 6144^3 and on each route at ragged shapes), and
              time kernel, plain version and one library call at every
              shape the paths give it (K1: 12288^3, 6144^3 for QR and for
              potrf, 2048^3, and f32 2048^3 with B as (k, n) and as (n, k)
              for the served GEMM and potrf jobs); K1's fma route at the
              edges of its tiles and float4 rows (ragged M, N and K, K < 4,
              N % 4 != 0, A misaligned: the scalar variant), each also
              bit-identical repeated and in place; K2 twice on one input
              must agree bit for bit.  K1's grouped launch (the device module's fused waves:
              8 members at each path's shape, and ragged) must give the
              bits of single launches and agree with the plain version,
              and its in-place form (``out=C``, donation) the bits of the
              out-of-place call; both are timed against single launches,
              the library and their bound (8 x 2048^3, 8 x 6144^3
              transposed-B; in place at 6144^3);
4. GEMM path — the tiled GEMM at the repo's bench geometry (mb=12288,
              mt=nt=3, kt=4; A and B bf16, C f32), tiles born on the card:
              one warm pass, three timed passes, C checked against a
              tile-by-tile plain-version product, kernel launches counted;
5. small tiles — the same app at mb=2048 over 16384^2 x 16384 (512 tasks),
              where the runtime's per-task host cost shows;
6. QR path  — the tiled QR at the repo's geqrf bench geometry (mb=6144,
              nt=8, bf16 tile storage, qr_ib=512: 204 tasks a pass), tiles
              regenerated on the card before each pass: one warm pass,
              three timed passes, task, incarnation and launch counts
              checked on every pass, then R's lower tiles, the
              factorization residual and the least-squares ladder;
7. potrf path — the tiled Cholesky at the JAX package's north-star
              geometry (mb=6144, nt=16, bf16 tile storage: 816 tasks a
              pass), the bench's operand regenerated on the card before
              each pass (lower tiles only): one warm pass, five timed
              passes (median, best and band of GFLOP/s), task, launch
              and Cholesky-flag checks on every pass, then the backward
              error and the iterative-refinement ladder once.
8. the remaining apps — ring attention at N = 32768 tokens, d = 128, one
              head, P = 8 parties (Tq = Tkv = 4096), f32 with TF32 off,
              non-causal then causal, each in a Context of its own: Q, K,
              V from the seed on the card, one warm pass and three timed
              (best, TFLOP/s of the executed visits, visits by class:
              64, or 28 past, 8 diagonal, 28 skipped), every output row
              within rtol 2e-4, atol 2e-5 of a float64 dense reference
              computed on the card in blocks of 4096 rows, one visit of
              each class timed alone; a recursive potrf: one 8192^2 f32
              tile factored inside a FACT body by an inner potrf over
              2048 subtiles on the card (20 inner tasks, 10 K1 launches
              on the fma route a pass), max|LL' - A| / max|A| < 1e-4 in
              float64 and CHECK reading the committed factor; the
              permute wave over P = 8 parties of (4096, 4096) f32, every
              W(q) exactly ``expected_wave_result``;
9. front-ends — the GEMM through DTD ``insert_task`` at the bench
              geometry (36 inserts a pass; one warm, three timed; C
              within 1e-3 of the plain product), then at mb=2048 (512
              inserts a pass) in turns with the PTG front-end on the same
              seeded operands, then as a JDF text (``JDF_GEMM``, bodies
              K1 and its plain version) in turns with the PTG front-end:
              per front the best pass, host CPU and submit us per task,
              the submitting thread's CPU us per task (DTD: discovery),
              estimated idle share, mean wave width, DTD window stalls,
              and C bit for bit against the PTG's; the DTD run's C tiles
              are kept for the 2-rank check;
10. host    — the runtime alone on the host's CPU (named with its core
              count): the twins of the JAX package's ``tasks`` probe
              (20000 empty tasks, 4 streams) and ``ntasks`` probe (500
              RW chains x 24, results checked), each at ``sched_native``
              1 and 0 in turns; the native ``ntasks`` run must hand no
              task back to Python (an empty bailout histogram).  Then the
              twins of the JAX package's overhead probes: interleaved
              pairs of the ``tasks`` probe armed and off, for the
              telemetry plane (``metrics_enabled`` + ``liveattr_enable``),
              the journal (``journal_enabled``) and the tracer (task
              profiler + causal tracer), each printed as its minimum pair
              ratio and us per task beside the JAX package's CPU gate;
11. 2-rank  — two ranks spawned on the one card (P=2 row grids): potrf,
              the PTG GEMM, the GEMM through DTD (every rank inserts every
              task, AFFINITY on C; the other rank's B tiles arrive as
              version-0 payloads over TAG_DTD; C after the flush home bit
              for bit against the single-rank DTD run, no DTD pull or
              backlogged frame left) and routed QR, the JAX package's
              pingpong probes on host bodies (8 B x 400 hops round trip,
              8 MiB x 32 hops bandwidth: host numbers), then potrf over
              shm in turns with evloop (one pass each, in fresh processes).
12. serving — the resident job service (``parsec_tpu_torch.service``):
              four GEMM jobs (n=8192, nb=2048, f32: K1 on its ``fma``
              route), two potrf jobs (n=8192, nb=2048, f32) and four
              stencil jobs (n=2^23, nb=2^20, 64 steps, one fused at 16)
              submitted together at mixed priorities to a warm
              ``JobService`` (4 streams, 4 active jobs), each result held
              to its own check on the card (GEMM C within 1e-3 of the
              plain product, potrf max|LL' - A| / max|A| within 1e-4, the
              stencil within 1e-5 of the float64 reference), jobs/s and
              the p50/p99 of admission -> completion, each app's job wall
              times, the per-job retired counts against each pool's tasks
              and ``parsec_jobs_done_total``; then one job of each app
              over the JobServer's framed-JSON wire (a bad-magic frame
              refused, the metrics and journal ops); then the
              ServingFabric: the JAX package's fabric bench (48 chain
              jobs of 8 host tasks), a GEMM job leasing the card beside
              two shared ones that wait for its release, a quoted second
              submit, and the journal audited clean (F1-F3) by the
              port's ``tools.journal_audit``.  K1 at 2048^3 f32 is timed
              in the kernels phase against ``torch.addmm`` with TF32 off,
              with B as (k, n) (GEMM jobs) and as (n, k) (potrf jobs).
              Before the fabric, the client tools against a JobServer over
              the same service: ``python -m parsec_tpu_torch.tools.
              job_client submit gemm --set n=8192 --set nb=2048 --wait``
              (its 64 K1 tiles on the ``fma`` route, its result held to
              the GEMM check), ``metrics_client`` showing
              ``parsec_jobs_done_total`` up by one, ``metrics_client
              --status --job`` and ``live_view --once`` rendering the job.
13. tools  — last: the trace tools on the traces the traced passes kept
              (GEMM mb=2048, potrf mb=6144: ``trace_info --stats --gaps``,
              whose per-class counts must hold one exec and one dev: span
              per task, 512 and 816, and ``trace2chrome``, whose X events
              must be the trace's intervals) and ``trace2chrome --merge``
              over the 2-rank potrf's rank traces (one flow arrow per
              matched activation, ranks 0 and 1); then ``python -m
              parsec_tpu_torch.tools.chaos --device cuda`` on
              ``CHAOS_CASES`` with two ranks time-sharing the card: exit
              0, each case passed.  Each tool runs in a process of its
              own; its seconds and the traces' sizes are printed.
  checkpoint + grapher (one Context): one GEMM mb=2048 pass (8 x 8 x 8,
              K1 on the card) with the DOT grapher installed (its file
              must hold the 512 task nodes and the pass's 448 dependency
              edges), then C (64 tiles of 2048^2 f32, 1 GiB, on the card)
              through ``utils.checkpoint``: flushed home and written, then
              restored into a freshly built collection of the same layout,
              bit for bit; the bytes and the write and read seconds.
  fault tolerance (2 ranks, after the 2-rank paths): the potrf at mb=6144,
              nt=16, bf16 storage on two ranks of this card with
              ``recovery_enable`` and the flight recorder armed (its
              bundle in a temporary directory); both ranks start the
              pool on rank 1's engine clock at ``RECOVERY_SETUP_S`` after
              its start (after the operand is made on the card and the
              pool attached, which takes the recovery snapshot of each
              rank's local tiles), and rank 1 kills itself
              (``kill_on_progress``: the close of ``kill_rank``) once it
              has completed ``RECOVERY_KILL_AT`` of its share of the
              pool's tasks, so the death lands inside the pool however
              long the pass takes under load.  Rank 1 must
              die (its slot None) and rank 0 complete: one recovery
              started and none failed, L within 1e-2 of the single-rank
              factor over every lower tile (the adopted ones remade on
              the card by ``A.set_init(potrf.bench_operand(...))``), the
              Cholesky flag clear, backward error <= 5e-2; it prints the
              survivor's time from the pool's start to its completion
              against the no-fault pass, the minimal and full replays and
              the re-executed tasks, the restored tiles by source, the
              snapshot's bytes and seconds, K1 on the survivor, its memory
              peak, and ``summarize_bundle`` of the flight-recorder
              bundle, which must hold rank 0's ring and a recovery-start
              incident and which ``critpath.merge_traces`` must open.
  rejoin + DTD recovery (2 ranks over shm, one spawn, after the killed
              potrf; recovery and the flight recorder armed): the GEMM
              mb=2048 8 x 8 x 8 (A, B bf16, C f32, tiles seeded per index
              on the card) for a pass A; rank 1's engine goes down
              (``rde.fini()``) and comes back as incarnation 1
              (``comm_epoch`` 1) through ``ctx.recovery.rejoin()`` over
              the shm rings rank 0 re-created; pass B on the rejoined
              rank.  It fails unless rank 0 counts one rejoin, the dead
              set is empty again, both passes' C check and the JobService
              on rank 0 went recovering -> healthy.  Then the same GEMM
              through DTD with ``recovery_replay`` and ``set_init`` (the
              seeded makers), started on both ranks ``FT_SETUP_S`` after
              rank 1's restarted engine came up; rank 1 kills itself
              (``fault_kill``, the close of ``kill_rank``) once it has
              completed ``RECOVERY_KILL_AT`` of its share of the pool's
              tasks, so the death lands inside the pool however long the
              pass takes.  Rank 1 must die, rank 0 complete with one recovery
              started and none failed, C within 1e-3 of the plain-version
              product over all 64 tiles, and the bundle hold rank 0's
              recovery-start incident for the DTD pool; it prints the
              agreed skip prefix (or the fallback's reason), the inserts
              ghosted, the held cut payloads, minimal and full replays, C
              bit for bit against K1's chain, the survivor's time against
              the no-fault pass, K1 on the survivor, its memory peak and
              the snapshot's bytes and seconds; and the seconds from the
              engine going down to the rejoin ACK, pass B against pass A.
  several modules (``device="cuda*8"``: eight device modules over the one
              card, each its own launch stream, memory space, LRU and
              1/8 budget; each path in a Context of its own, after the
              2-rank paths): the GEMM mb=2048 8 x 8 x 8 with
              ``panel_bcast`` (A, B on the host, C on the modules; best
              of 3, C within 1e-3 of the plain product, the ICI engine's
              broadcasts must fire), potrf mb=6144 nt=16 (median of 3,
              backward error <= 5e-2, the IR ladder), geqrf mb=6144 nt=8
              (one timed pass, the QR checks), the permute wave P=8 of
              4096^2 f32 (window 1000 ms: k edges on <= 2 launches a
              pass), the zig chain (a proactive placement must fire),
              ring attention N=32768 over the modules, and the SPMD trio
              (``parallel/spmd.py``: SUMMA on 2x4 and the reduce-scatter
              GEMM on 1x8 at n=16384 f32, TF32 off, within 1e-4 of the
              plain product; the halo stencil over 2^26 f32 within 1e-5
              of its serial form).  Each path prints its pass time beside
              the one-module pass's, its launches, the ICI engine's
              ``IciStats`` and each module's ledger peak; a warm pass
              precedes each timed one.

Telemetry.  Every path runs with the planes the reference installs at its
defaults: the metrics registry with live attribution and health, the
control-plane journal, the properties space, and the ready stamp.  After
each path a ``[telemetry <path>]`` line reads the registry's scrape:
the native pushes, pops and bailouts (equal to the path's scheduler
line), the sampled latency-histogram count and liveattr's per-class done
counts (held to the stride's arithmetic, see ``report_telemetry``), the
straggler count, the health score and the journal's event count.  The
GEMM mb=2048 and potrf paths run one more pass after their checks with
the task profiler and the causal tracer installed, read the trace back
through the port's reader and ``critpath.attribution``, and print the
critical path's exec, queue, comm and idle (summing to the makespan
within 5%), the device spans (one per task) and the in-flight share
(the union of dispatch->done device spans over the traced pass).  No
traced pass counts in the kernels line.

Every path runs on the native scheduler (``parsec_tpu_torch/native``:
the C ready queue, dep countdown and ``run_quantum``) unless the MCA
environment sets ``sched_native`` 0; at the default each path asserts it
and prints the ready queue's pushes, pops and maximum depth, the C
chain's bailouts by reason and the probe pops beside them (tasks a
worker took past ``run_quantum``); on a path whose every task ran on the
card, bailouts plus probe pops equal the tasks.  The small-tiles path
runs once more on the
Python ladder (``sched_native`` 0), right after its native run, and both
best passes and estimated idle shares are printed.

Every path runs the device module as configured — at its defaults (wave
fusion, chain fusion, buffer donation; ``device_max_faults`` 0, which it
asserts before anything else runs), or as the MCA environment sets it,
e.g. one launch per task with
``PARSEC_MCA_DEVICE_FUSE=1 PARSEC_MCA_DEVICE_FUSE_PANEL=0
PARSEC_MCA_DEVICE_DONATE=0``.  Each path prints its mean wave width
(fused tasks per fused launch), chained launches, donations and device
memory peak, and must count no device fault; at the defaults the potrf
path must fuse waves and chain panels, and the QR path chain panels.
Every kernel count is set to 0 just before a path runs and read just
after it; K1's tiles on a path are its single launches plus the members
of its grouped launches, and every one must have taken the wgmma route.
``nvidia-smi`` reads the SM clock and power draw before a path's first
pass and after its last timed one, outside the timed window.  It prints a
``{"device_module": {...}, "paths": {...}}`` line (the knobs in force and
each path's pass time, wave width, chained launches, donations and
memory peak), a ``{"kernels": [...]}`` line (launches summed over the
paths), the card's name and power limit, then as its last line
``{"ok": true, "device": {...}}``.  Without a CUDA device it fails before
doing anything.  It imports nothing of JAX and nothing of ``parsec_tpu``.
"""

from __future__ import annotations

import collections
import gc
import itertools
import json
import math
import os
import re
import resource
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

import parsec_tpu_torch
from parsec_tpu_torch.apps import (cuda_kernels, potrf, qr, ring_attention,
                                   wave)
from parsec_tpu_torch.apps.cuda_kernels import gemm_tile, \
    gemm_tile_grouped, gemm_tile_grouped_reference, gemm_tile_reference, \
    gram_tile, gram_tile_reference
from parsec_tpu_torch.apps.gemm import _tile_kernel, gemm_dtd_insert, \
    gemm_taskpool, total_flops
from parsec_tpu_torch.apps.potrf_check import backward_error, refine_solve
from parsec_tpu_torch.apps.qr_check import ls_refine, newest_payload
# the comm package registers the comm knobs printed below
from parsec_tpu_torch.comm import run_distributed
from parsec_tpu_torch.comm import shm as _shm  # noqa: F401
from parsec_tpu_torch.core.context import Context
from parsec_tpu_torch.core.recursive import recursive_call
from parsec_tpu_torch.data.matrix import TwoDimBlockCyclic
from parsec_tpu_torch.data.subtile import SubtileMatrix
# registers the device module's knobs, read before any Context exists
from parsec_tpu_torch.devices import cuda as _cuda  # noqa: F401
from parsec_tpu_torch.dsl.dtd import DTDTaskpool
from parsec_tpu_torch.dsl.ptg import DATA, IN, OUT, PTG, Range, TASK
from parsec_tpu_torch.dsl.ptg.jdf import jdf_taskpool
from parsec_tpu_torch.native import load_schedext
from parsec_tpu_torch.parallel import spmd
from parsec_tpu_torch.prof import critpath
from parsec_tpu_torch.prof.causal import install_causal_tracer
from parsec_tpu_torch.prof.flightrec import summarize_bundle
from parsec_tpu_torch.prof.grapher import DotGrapher
from parsec_tpu_torch.prof.pins import install_task_profiler
from parsec_tpu_torch.prof.profiling import Profile
from parsec_tpu_torch.prof.reader import intervals, read_trace
from parsec_tpu_torch.service import JobService
from parsec_tpu_torch.service.fabric import ServingFabric
from parsec_tpu_torch.service.server import APPS, JobServer, request
from parsec_tpu_torch.tools import journal_audit
from parsec_tpu_torch.utils.checkpoint import checkpoint, restore
from parsec_tpu_torch.utils.mca import params

SEED = 20261016

#: dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s, f32 FLOP/s
#: outside the tensor cores, device-memory bytes/s
PEAKS = {
    "H100 SXM": (989e12, 67e12, 3.35e12),
    "H100 PCIe": (756e12, 51e12, 2.0e12),
    "H100 NVL": (835e12, 60e12, 3.9e12),
}

#: kernel-vs-plain tolerance on max|kernel - plain| / max(1, max|plain|):
#: bf16 products are exact in f32, so only the summation order differs
TOL = {torch.bfloat16: 1e-4, torch.float32: 1e-5}

#: every kernel's launch count, by the name the kernels line gives it
COUNTERS = {"gemm_tile": cuda_kernels.gemm_tile_launches,
            "gemm_tile_grouped": cuda_kernels.gemm_tile_grouped_launches,
            "gram_tile": cuda_kernels.gram_tile_launches}
#: K1's single launches by route
ROUTES = cuda_kernels.gemm_tile_route_launches
#: the calls K1's grouped launches carried (all on the wgmma route)
GROUPED_MEMBERS = cuda_kernels.gemm_tile_grouped_members

#: the device module's counters a path reports
DEVICE_STATS = ("fused_launches", "fused_tasks", "chained_launches",
                "chained_tasks", "donated_tasks", "donations_refused",
                "faults")

#: QR path limits: the factorization residual ||R'Rz - A'Az|| / ||A'Az||
#: of a bf16-storage factor (the JAX package recorded 1.0e-2 for its own),
#: and the least-squares ladder's best relative error
QR_RESIDUAL_TOL = 3e-2
QR_LADDER_TOL = 1e-5

#: potrf path limits, the JAX package's own (tests/test_potrf_check.py):
#: the backward error ||A - LL'||_F / ||A||_F of a bf16-storage factor,
#: and the last residual of the f32 iterative-refinement ladder
POTRF_BWD_TOL = 5e-2
POTRF_IR_TOL = 1e-5

#: the critical path's buckets must sum to the makespan within this share
#: of it (the JAX package's own tolerance, tests/test_critpath.py)
CRITPATH_TOL = 0.05

#: the JAX package's CPU gates for its overhead probes, in us per task
#: (BENCH.md; bench.py ``_overhead_probe``): the telemetry plane <= 0.5,
#: the tracer <= 8, the journal ~0 (no per-task emit site; taken as 0.1)
OVERHEAD_GATES_US = {"telemetry": 0.5, "journal": 0.1, "tracer": 8.0}


def reset_counts() -> None:
    for c in (*COUNTERS.values(), *ROUTES.values(), GROUPED_MEMBERS):
        c.reset()


def k1_tiles() -> tuple:
    """(K1 tiles, of them on the wgmma route) so far: single launches plus
    grouped members."""
    return (cuda_kernels.gemm_tile_launches.value + GROUPED_MEMBERS.value,
            ROUTES["wgmma"].value + GROUPED_MEMBERS.value)


def device_settings() -> dict:
    """The device module's knobs in force (MCA defaults or environment)."""
    return {k: params.get(k) for k in (
        "device_fuse", "device_fuse_panel", "device_donate",
        "device_fuse_donate", "device_max_faults", "device_runahead")}


def check_no_degraded_mode() -> None:
    """Degraded mode hands a task that faulted on the card to its CPU
    body: the measured paths run with it off (``device_max_faults`` 0)."""
    if int(params.get("device_max_faults")) != 0:
        raise AssertionError(
            f"device_max_faults is {params.get('device_max_faults')}: "
            f"the measured paths must run with degraded mode off (0)")


def at_defaults() -> bool:
    return int(params.get("device_fuse")) > 1 and \
        int(params.get("device_fuse_panel")) == 1


def device_counts(dev) -> dict:
    return {k: getattr(dev.stats, k) for k in DEVICE_STATS}


class _SummedStats:
    """The counters of several modules, summed at each read."""

    def __init__(self, modules):
        self._modules = modules

    def __getattr__(self, name):
        return sum(getattr(m.stats, name) for m in self._modules)


class MeshView:
    """The modules of a several-module Context (``device="cuda*N"``) seen
    by the path drivers as one device: ``stats`` sums theirs, and a tile
    placed through ``place`` is born on the module ``distribute_devices``
    pins it to (owner-computes over the modules, as the JAX package's
    dryrun spreads its graphs over its devices)."""

    def __init__(self, ctx: Context):
        self.modules = list(ctx.device_registry.accelerators)
        self.spaces = [m.space for m in self.modules]
        first = self.modules[0]
        self.tdev, self.is_cuda = first.tdev, first.is_cuda
        self.name = f"{len(self.modules)} modules over {first.tdev}"
        self.stats = _SummedStats(self.modules)

    def owner(self, M, m: int, n: int):
        d = M.data_of(m, n)
        if d.preferred_device not in self.spaces:
            M.distribute_devices(self.spaces)
        return self.modules[self.spaces.index(d.preferred_device)]


def path_device(ctx: Context):
    """The device a path driver places its tiles on and reads its counters
    from: the one module, or a ``MeshView`` of several."""
    accs = ctx.device_registry.accelerators
    return accs[0] if len(accs) == 1 else MeshView(ctx)


def place(M, m: int, n: int, dev, tile: torch.Tensor) -> None:
    """Tile (m, n) of ``M`` born on ``dev`` (a mesh: on its owner)."""
    M.place_on_device(m, n, dev.owner(M, m, n)
                      if isinstance(dev, MeshView) else dev, tile)


def report_device(label: str, dev, before: dict, need_fused: bool = False,
                  need_chained: bool = False) -> dict:
    """The device module's counters over a path (against ``before``):
    printed with the mean wave width; a device fault fails the path, and
    at the defaults so does a missing fusion the path must show."""
    d = {k: v - before[k] for k, v in device_counts(dev).items()}
    width = d["fused_tasks"] / d["fused_launches"] \
        if d["fused_launches"] else 1.0
    d["mean_wave_width"] = width
    log(f"[{label}] device module {device_settings()}: fused launches "
        f"{d['fused_launches']} carrying {d['fused_tasks']} tasks (mean "
        f"wave width {width:.2f}), chained launches "
        f"{d['chained_launches']} carrying {d['chained_tasks']} tasks, "
        f"donated tasks {d['donated_tasks']}, donations refused "
        f"{d['donations_refused']}, faults {d['faults']}")
    if d["faults"]:
        raise AssertionError(f"[{label}] {d['faults']} device faults")
    if at_defaults():
        if need_fused and d["fused_launches"] <= 0:
            raise AssertionError(f"[{label}] no wave fused at the defaults")
        if need_chained and d["chained_launches"] <= 0:
            raise AssertionError(f"[{label}] no chained launch at the "
                                 f"defaults")
    return d


def read_counts() -> dict:
    return {name: c.value for name, c in COUNTERS.items()}


def read_routes() -> dict:
    return {name: c.value for name, c in ROUTES.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def peaks_for(name: str):
    if "H100" in name and "PCIe" in name:
        key = "H100 PCIe"
    elif "H100" in name and "NVL" in name:
        key = "H100 NVL"
    else:
        key = "H100 SXM"
    return key, PEAKS[key]


def sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def read_clock(label: str, when: str) -> None:
    """One ``nvidia-smi`` reading of the SM clock and power draw, taken
    outside every timed window: under a sustained load the card lowers its
    clock to hold its power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[{label}] SM clock, power draw {when}: {out}")


def time_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max(1, max|ref|).  For bf16 outputs each element's
    difference first loses one unit in the last place of ref: kernel and
    plain version each round an f32 sum once, and two sums in another
    order that straddle a rounding boundary land one bf16 ulp apart."""
    d = (got.float() - ref.float()).abs()
    if ref.dtype == torch.bfloat16:
        _, e = torch.frexp(ref.float())
        d = (d - torch.ldexp(torch.ones_like(d), e - 8)).clamp(min=0.0)
    return (d.max() / ref.float().abs().max().clamp(min=1.0)).item()


def _library_addmm(A, B, C, alpha, trans_b=False):
    """One PyTorch call computing C + alpha * A @ B (``A @ B^T`` with
    ``trans_b``, B read transposed in place) on the same operands
    (cuBLAS).  bf16 operands with an f32 C need ``out_dtype``; the port
    never calls this."""
    Bm = B.mT if trans_b else B
    if A.dtype == C.dtype:
        return torch.addmm(C, A, Bm, alpha=alpha), \
            "torch.addmm" + ("(C, A, B.mT)" if trans_b else "")
    return torch.addmm(C, A, Bm, alpha=alpha, out_dtype=C.dtype), \
        "torch.addmm(out_dtype=float32)"


def k1_bound(A, B, C, peak: float, mem_rate: float):
    """Least time of one K1 call: 2mnk flop at the operands' peak (bf16
    tensor cores, or f32 outside them) against A and B read once, C read
    and O written once."""
    m, k = A.shape
    n = C.shape[1]
    t_ops = 2.0 * m * n * k / peak * 1e3
    t_bytes = (A.numel() * A.element_size() + B.numel() * B.element_size()
               + 2 * C.numel() * C.element_size()) / mem_rate * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def in_turns(fns: dict, reps: int, rounds: int = 3) -> dict:
    """The least device time of each ``fns`` entry over ``rounds`` rounds
    taken in turns: the card lowers its clock to hold its power limit
    under a sustained load, so one version timed after another would pay
    for the other's heat."""
    got = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            got[name].append(time_ms(fn, reps=reps, warm=1))
    return {name: min(v) for name, v in got.items()}


def time_k1(A, B, C, alpha, trans_b, per_pass, peaks) -> dict:
    """K1, its plain version and one library call on the same operands,
    with the bound, at one shape; kernel and library in turns.
    ``per_pass``: the launches a pass makes at this shape, by path."""
    m, k = A.shape
    n = C.shape[1]
    reps = 5 if m >= 12288 else 20
    f32 = A.dtype == torch.float32
    # f32 operands: the f32 peak outside the tensor cores, and the library
    # call with TF32 off (a full f32 product, as the port's)
    if f32 and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 yardstick would not be "
                             "a full f32 product")
    bound, by = k1_bound(A, B, C, peaks[1] if f32 else peaks[0], peaks[2])
    plain_ms = time_ms(
        lambda: gemm_tile_reference(A, B, C, alpha, trans_b), reps=3)
    fns = {"kernel": lambda: gemm_tile(A, B, C, alpha, trans_b)}
    try:
        _, lib_name = _library_addmm(A, B, C, alpha, trans_b)
        fns["library"] = lambda: _library_addmm(A, B, C, alpha, trans_b)
    except (TypeError, RuntimeError) as exc:
        lib_name = f"none ({type(exc).__name__})"
    t = in_turns(fns, reps)
    ms, lib_ms = t["kernel"], t.get("library")
    what = f"A @ B^T, {str(C.dtype)[6:]} C" if trans_b else \
        f"A @ B, {str(C.dtype)[6:]} C"
    log(f"gemm_tile at {m}x{k}x{n} {str(A.dtype)[6:]} ({what}): kernel "
        f"{ms:.4f} ms "
        f"({2.0 * m * n * k / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} "
        f"ms, library_ms {lib_ms} ({lib_name}), bound {bound:.4f} ms ({by}),"
        f" share of bound {bound / ms:.3f}, kernel / library "
        f"{ms / lib_ms if lib_ms else float('nan'):.3f}, launches per pass "
        f"{per_pass}")
    return {"shape": [m, k, n], "trans_b": trans_b,
            "dtype": str(A.dtype)[6:], "c_dtype": str(C.dtype)[6:],
            "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "share_of_bound": bound / ms, "launches_per_pass": per_pass}


def phase_kernels(dev: torch.device, peaks) -> dict:
    """Kernel vs plain version on the card at the shapes and C/alpha forms
    every path gives it, with the route each call took; timings at every
    shape the paths give it."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, m, k, n, dtype, alpha, C is zero, trans_b, route, launches a
    # pass by path when timed); the QR path's calls at 6144^3: UNMQR and
    # TSMQR's Z take a zero C with alpha 1, TSMQR's other two a live C with
    # alpha 1 and -1; the potrf path's SYRK and GEMM take B as (n, k) and a
    # bf16 C with alpha -1 (with trans_b a bf16 A gets a bf16 C)
    cases = [("main", 12288, 12288, 12288, bf16, 1.0, False, False, "wgmma",
              {"GEMM mb=12288": 36}),
             ("QR UNMQR/TSMQR Z", 6144, 6144, 6144, bf16, 1.0, True, False,
              "wgmma", None),
             ("QR TSMQR inner", 6144, 6144, 6144, bf16, 1.0, False, False,
              "wgmma", {"QR mb=6144": 448}),
             ("QR TSMQR C2", 6144, 6144, 6144, bf16, -1.0, False, False,
              "wgmma", None),
             ("potrf SYRK/GEMM", 6144, 6144, 6144, bf16, -1.0, False, True,
              "wgmma", {"potrf mb=6144": 680}),
             ("GEMM mb=2048", 2048, 2048, 2048, bf16, 1.0, False, False,
              "wgmma", {"GEMM mb=2048": 512}),
             ("ragged", 1000, 520, 776, bf16, 0.5, False, False, "wgmma",
              None),
             ("ragged", 1000, 513, 777, bf16, -1.0, False, False, "wmma",
              None),
             ("ragged", 1000, 513, 777, f32, -1.0, False, False, "fma",
              None),
             # the served GEMM jobs' tiles (f32 operands: the fma route);
             # alpha 1 as gemm_taskpool gives it
             ("f32", 2048, 2048, 2048, f32, 1.0, False, False, "fma",
              {"serving GEMM job n=8192": 64}),
             # the served potrf jobs' SYRK/GEMM tiles: B as (n, k), alpha
             # -1, as potrf_taskpool gives them in f32
             ("f32", 2048, 2048, 2048, f32, -1.0, False, True, "fma",
              {"serving potrf job n=8192": 10}),
             ("ragged", 1000, 520, 778, bf16, -1.0, False, True, "wgmma",
              None),
             ("ragged", 1000, 513, 777, bf16, -1.0, False, True, "wmma",
              None),
             ("ragged", 1000, 513, 777, f32, -1.0, False, True, "fma",
              None)]
    entry, shapes = None, []
    for label, m, k, n, dt, alpha, zero_c, trans_b, route, per_pass in cases:
        A = torch.randn((m, k), generator=g, device=dev).to(dt)
        B = torch.randn((n, k) if trans_b else (k, n), generator=g,
                        device=dev).to(dt)
        C = torch.zeros((m, n), device=dev) if zero_c else \
            torch.randn((m, n), generator=g, device=dev)
        C = C.to(dt) if trans_b else C
        routes0 = read_routes()
        got = gemm_tile(A, B, C, alpha, trans_b)
        torch.cuda.synchronize()
        took = [r for r, v in read_routes().items() if v != routes0[r]]
        ref = gemm_tile_reference(A, B, C, alpha, trans_b)
        err = rel_err(got, ref)
        max_abs = (got.float() - ref.float()).abs().max().item()
        ok = err <= TOL[dt] and took == [route]
        form = f"B^T, {str(C.dtype)[6:]} C" if trans_b else "B"
        log(f"kernel vs plain {label} {m}x{k}x{n} {str(dt)[6:]} ({form}) "
            f"alpha={alpha}{' zero C' if zero_c else ''}: route {took}, rel "
            f"err {err:.3e} (tol {TOL[dt]:.0e}) max abs {max_abs:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if took != [route]:
            raise AssertionError(f"gemm_tile took route {took}, expected "
                                 f"{route}")
        if not ok:
            raise AssertionError(f"gemm_tile disagrees with its plain "
                                 f"version: {err} > {TOL[dt]}")
        del got, ref
        if per_pass:
            shapes.append(time_k1(A, B, C, alpha, trans_b, per_pass, peaks))
        if label == "main":
            t = shapes[-1]
            entry = {"name": "gemm_tile", "route": "cuda",
                     "source": "parsec_tpu_torch/csrc/gemm_tile.cu",
                     "replaces": "parsec_tpu/apps/pallas_kernels.py:74",
                     "launches": 0, "max_abs_err": max_abs, "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]}
        del A, B, C
        torch.cuda.empty_cache()
    check_fma_edges(dev, g)
    entry["shapes"] = shapes
    return entry


#: K1's fma route at the edges of its design (128 x 128 tiles, K slabs of
#: 8, float4 rows): (m, k, n, alpha, elements before A in its storage);
#: each runs with B as (k, n) and as (n, k).  The vector variant takes
#: K % 4 == N % 4 == 0 on 16-byte aligned bases, any other call the scalar
#: one.
FMA_EDGES = [(1000, 520, 776, -1.0, 0),    # M, N off the 128 grid: vector
             (130, 12, 260, 1.0, 0),       # K not a multiple of 8
             (77, 3, 95, 2.0, 0),          # K < 4, N % 4 != 0: scalar
             (1000, 513, 777, -1.0, 0),    # K % 4 and N % 4 != 0: scalar
             (256, 256, 258, 0.5, 0),      # N % 4 != 0: scalar
             (256, 256, 256, -1.0, 1)]     # A misaligned by one float


def check_fma_edges(dev: torch.device, g: torch.Generator) -> None:
    """Hold K1's fma route at every edge of FMA_EDGES, in both layouts,
    against its plain version (TOL[float32]), on the fma route; a second
    call and the in-place call (``out=C``) must give the first call's
    bits.  These launches check, they are not timed."""
    for m, k, n, alpha, offset in FMA_EDGES:
        for trans_b in (False, True):
            flat = torch.randn(m * k + offset, generator=g, device=dev)
            A = flat[offset:].view(m, k)
            B = torch.randn((n, k) if trans_b else (k, n), generator=g,
                            device=dev)
            C = torch.randn((m, n), generator=g, device=dev)
            routes0 = read_routes()
            got = gemm_tile(A, B, C, alpha, trans_b)
            again = gemm_tile(A, B, C, alpha, trans_b)
            C2 = C.clone()
            gemm_tile(A, B, C2, alpha, trans_b, out=C2)
            torch.cuda.synchronize()
            took = {r: v - routes0[r] for r, v in read_routes().items()
                    if v != routes0[r]}
            err = rel_err(got, gemm_tile_reference(A, B, C, alpha, trans_b))
            same = torch.equal(got, again)
            in_place = torch.equal(C2, got)
            ok = err <= TOL[torch.float32] and took == {"fma": 3} and \
                same and in_place
            log(f"kernel vs plain fma edge {m}x{k}x{n} float32 "
                f"({'B^T' if trans_b else 'B'}) alpha={alpha} A offset "
                f"{offset}: route {took}, rel err {err:.3e} (tol "
                f"{TOL[torch.float32]:.0e}), repeat bit-identical {same}, "
                f"in place bit-identical {in_place} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"gemm_tile's fma route fails at "
                                     f"{m}x{k}x{n} trans_b={trans_b} A "
                                     f"offset {offset}")


def _library_grouped(As, Bs, Cs, alpha, trans_b):
    """Library yardsticks of a grouped call on the same operands: a loop
    of ``_library_addmm`` calls, and one ``torch.baddbmm`` on operands
    stacked beforehand (None where it does not take the types).  The port
    never calls either."""
    def loop():
        return [_library_addmm(A, B, C, alpha, trans_b)[0]
                for A, B, C in zip(As, Bs, Cs)]
    fns = {"library loop": loop}
    Ast, Bst, Cst = (torch.stack(x) for x in (As, Bs, Cs))
    Bm = Bst.mT if trans_b else Bst
    try:
        if Ast.dtype == Cst.dtype:
            torch.baddbmm(Cst, Ast, Bm, alpha=alpha)
            fns["library baddbmm"] = lambda: torch.baddbmm(Cst, Ast, Bm,
                                                           alpha=alpha)
        else:
            torch.baddbmm(Cst, Ast, Bm, alpha=alpha, out_dtype=Cst.dtype)
            fns["library baddbmm"] = lambda: torch.baddbmm(
                Cst, Ast, Bm, alpha=alpha, out_dtype=Cst.dtype)
    except (TypeError, RuntimeError) as exc:
        log(f"torch.baddbmm does not take {str(Ast.dtype)[6:]} x "
            f"{str(Cst.dtype)[6:]}: {type(exc).__name__}")
    return fns


def phase_k1_forms(dev: torch.device, peaks, entry: dict) -> dict:
    """K1's grouped launch and in-place form on the card.

    Grouped: 8 members at every shape, C and alpha the paths' fused waves
    give it, and 3 ragged members: each member bit-identical to its single
    launch, within tolerance of the plain version, and again bit-identical
    written into C (``out=C``); one grouped launch counted with its
    members.  Timed at 8 x 2048^3 (bf16, bf16, f32) and 8 x 6144^3
    transposed-B with a bf16 C against 8 single launches, the library
    (a loop of addmm, one baddbmm on pre-stacked operands) and 8 x the
    single call's bound.  In place: ``out=C`` bit-identical to the
    out-of-place call at the QR and potrf 6144^3 forms, timed at the
    potrf one against out of place (recorded in ``entry``, K1's entry).
    Returns the grouped launch's kernels-line entry."""
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    bf16 = torch.bfloat16
    # (label, members, m, k, n, alpha, C is zero, trans_b, timed)
    cases = [("GEMM mb=12288 wave", 8, 12288, 12288, 12288, 1.0, False,
              False, False),
             ("GEMM mb=2048 wave", 8, 2048, 2048, 2048, 1.0, False, False,
              True),
             ("QR UNMQR/TSMQR Z wave", 8, 6144, 6144, 6144, 1.0, True,
              False, False),
             ("QR TSMQR inner/C2 wave", 8, 6144, 6144, 6144, -1.0, False,
              False, False),
             ("potrf SYRK/GEMM wave", 8, 6144, 6144, 6144, -1.0, False,
              True, True),
             ("ragged", 3, 1000, 520, 776, 0.5, False, False, False),
             ("ragged", 3, 1000, 520, 778, -1.0, False, True, False)]
    grouped, shapes = None, []
    for label, n, m, k, nn, alpha, zero_c, trans_b, timed in cases:
        As = [torch.randn((m, k), generator=g, device=dev).to(bf16)
              for _ in range(n)]
        Bs = [torch.randn((nn, k) if trans_b else (k, nn), generator=g,
                          device=dev).to(bf16) for _ in range(n)]
        Cs = [(torch.zeros((m, nn), device=dev) if zero_c else
               torch.randn((m, nn), generator=g, device=dev))
              .to(bf16 if trans_b else torch.float32) for _ in range(n)]
        launches0 = cuda_kernels.gemm_tile_grouped_launches.value
        members0 = GROUPED_MEMBERS.value
        got = gemm_tile_grouped(As, Bs, Cs, alpha, trans_b)
        torch.cuda.synchronize()
        counted = (cuda_kernels.gemm_tile_grouped_launches.value - launches0,
                   GROUPED_MEMBERS.value - members0)
        errs, max_abs, same = [], 0.0, True
        for i in range(n):
            single = gemm_tile(As[i], Bs[i], Cs[i], alpha, trans_b)
            same = same and torch.equal(got[i], single)
            ref = gemm_tile_reference(As[i], Bs[i], Cs[i], alpha, trans_b)
            errs.append(rel_err(got[i], ref))
            max_abs = max(max_abs,
                          (got[i].float() - ref.float()).abs().max().item())
            del single, ref
        outs = [c.clone() for c in Cs]
        inplace = gemm_tile_grouped(As, Bs, outs, alpha, trans_b, out=outs)
        torch.cuda.synchronize()
        same_inplace = all(o is x and torch.equal(o, y)
                           for o, x, y in zip(inplace, outs, got))
        del outs, inplace
        ok = counted == (1, n) and same and same_inplace and \
            max(errs) <= TOL[bf16]
        form = f"B^T, {'bf16' if trans_b else 'f32'} C" if trans_b else \
            "B, f32 C"
        log(f"grouped kernel vs plain {label}: {n} x {m}x{k}x{nn} ({form}) "
            f"alpha={alpha}{' zero C' if zero_c else ''}: counted (launches,"
            f" members) {counted}, bit-identical to single launches {same}, "
            f"in place (out=C) bit-identical {same_inplace}, worst rel err "
            f"{max(errs):.3e} (tol {TOL[bf16]:.0e}) max abs {max_abs:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gemm_tile_grouped {label} failed its "
                                 f"check")
        if timed:
            reps = 5 if m >= 6144 else 20
            bound, by = k1_bound(As[0], Bs[0], Cs[0], peaks[0], peaks[2])
            bound *= n
            plain_ms = time_ms(lambda: gemm_tile_grouped_reference(
                As, Bs, Cs, alpha, trans_b), reps=1)
            fns = {"grouped": lambda: gemm_tile_grouped(As, Bs, Cs, alpha,
                                                        trans_b),
                   "singles": lambda: [gemm_tile(a, b, c, alpha, trans_b)
                                       for a, b, c in zip(As, Bs, Cs)]}
            fns.update(_library_grouped(As, Bs, Cs, alpha, trans_b))
            t = in_turns(fns, reps)
            lib_ms = t.get("library baddbmm", t["library loop"])
            log(f"gemm_tile_grouped at {n} x {m}x{k}x{nn} bf16 ({form}): "
                f"grouped {t['grouped']:.4f} ms, {n} single launches "
                f"{t['singles']:.4f} ms, plain {plain_ms:.4f} ms, library "
                f"loop of {n} addmm {t['library loop']:.4f} ms, library "
                f"baddbmm {t.get('library baddbmm')}, bound {bound:.4f} ms "
                f"({by}, {n} x one call's), share of bound "
                f"{bound / t['grouped']:.3f}, grouped / singles "
                f"{t['grouped'] / t['singles']:.3f}, grouped / library "
                f"{t['grouped'] / lib_ms:.3f}")
            shapes.append({"members": n, "shape": [m, k, nn],
                           "trans_b": trans_b,
                           "c_dtype": "bfloat16" if trans_b else "float32",
                           "ms": t["grouped"], "singles_ms": t["singles"],
                           "plain_ms": plain_ms,
                           "library_loop_ms": t["library loop"],
                           "library_baddbmm_ms": t.get("library baddbmm"),
                           "bound_ms": bound, "bound_by": by,
                           "share_of_bound": bound / t["grouped"]})
            if label.startswith("potrf"):
                grouped = {"name": "gemm_tile_grouped", "route": "cuda",
                           "source": "parsec_tpu_torch/csrc/gemm_tile.cu",
                           "replaces": "parsec_tpu/apps/pallas_kernels.py:74",
                           "launches": 0, "max_abs_err": max_abs,
                           "ms": t["grouped"], "plain_ms": plain_ms,
                           "bound_ms": bound, "bound_by": by,
                           "library_ms": lib_ms}
        del As, Bs, Cs, got
        torch.cuda.empty_cache()
    grouped["shapes"] = shapes

    # in place: out=C against out of place, at the QR and potrf forms
    for label, trans_b, c_dtype, timed in (
            ("QR 6144^3 (B, f32 C)", False, torch.float32, False),
            ("potrf 6144^3 (B^T, bf16 C)", True, bf16, True)):
        A = torch.randn((6144, 6144), generator=g, device=dev).to(bf16)
        B = torch.randn((6144, 6144), generator=g, device=dev).to(bf16)
        C = torch.randn((6144, 6144), generator=g, device=dev).to(c_dtype)
        want = gemm_tile(A, B, C, -1.0, trans_b)
        C2 = C.clone()
        ptr = C2.data_ptr()
        got = gemm_tile(A, B, C2, -1.0, trans_b, out=C2)
        torch.cuda.synchronize()
        ref = gemm_tile_reference(A, B, C, -1.0, trans_b)
        err = rel_err(C2, ref)
        ok = got is C2 and C2.data_ptr() == ptr and torch.equal(C2, want) \
            and err <= TOL[bf16]
        log(f"in-place kernel {label}: O written into C's storage "
            f"{C2.data_ptr() == ptr}, bit-identical to out of place "
            f"{torch.equal(C2, want)}, rel err vs plain {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"in-place gemm_tile {label} failed its "
                                 f"check")
        if timed:
            # in place on C2 (its values drift pass after pass; the time
            # does not depend on them)
            t = in_turns({"out of place":
                          lambda: gemm_tile(A, B, C, -1.0, trans_b),
                          "in place":
                          lambda: gemm_tile(A, B, C2, -1.0, trans_b,
                                            out=C2)}, reps=20)
            bound, by = k1_bound(A, B, C, peaks[0], peaks[2])
            log(f"gemm_tile in place at 6144^3 bf16 ({label}): in place "
                f"{t['in place']:.4f} ms, out of place "
                f"{t['out of place']:.4f} ms, bound {bound:.4f} ms ({by}), "
                f"in place / out of place "
                f"{t['in place'] / t['out of place']:.3f}")
            entry["in_place"] = {"shape": [6144, 6144, 6144], "trans_b": True,
                                 "c_dtype": "bfloat16", "ms": t["in place"],
                                 "out_of_place_ms": t["out of place"],
                                 "bound_ms": bound, "bound_by": by}
        del A, B, C, C2, want, ref
        torch.cuda.empty_cache()
    return grouped


class _Incarnations:
    """Counts, per task class, device launches handed to the device
    module (``exec_async``) and bodies run inline (``exec_end``)."""

    def __init__(self, ctx):
        self._lock = threading.Lock()
        self.counts = {}
        ctx.pins_register("exec_async", self._hit)
        ctx.pins_register("exec_end", self._hit)

    def _hit(self, es, event, task):
        key = (task.task_class.name, event)
        with self._lock:
            self.counts[key] = self.counts.get(key, 0) + 1

    def take(self):
        with self._lock:
            out, self.counts = self.counts, {}
        return out


def completing_streams(ctx: Context) -> list:
    """Every execution stream that completes tasks: the workers, and each
    device module's own stream (its completer thread completes the card
    tasks)."""
    return list(ctx.streams) + [d.es for d in
                                ctx.device_registry.accelerators
                                if d.es is not None]


def sampled_completions(ctx: Context) -> int:
    """The completions the metrics plane has sampled so far.  In its
    default single-hook mode ``RuntimeMetrics._complete`` observes a
    completion when ``es.nb_tasks_done % metrics_sample == 0`` just
    before the stream's counter moves on, so a stream that completed n
    tasks sampled ceil(n / stride) of them."""
    stride = ctx.metrics._sample
    return sum(-(-es.nb_tasks_done // stride)
               for es in completing_streams(ctx))


def span_union(spans) -> float:
    """Total length of the union of (begin, end) intervals."""
    total, end = 0.0, None
    for b, e in sorted(spans):
        if end is None or b > end:
            total += e - b
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def slug(label: str) -> str:
    """A file name for ``label``."""
    return "".join(c if c.isalnum() else "_" for c in label)


def traced_pass(ctx: Context, run_pass, label: str, ntasks: int,
                best_s: float, trace_dir: str = None) -> dict:
    """One more pass (``run_pass()`` runs it and returns its wall time)
    with the task profiler and the causal tracer installed; the trace is
    written to a temporary directory and read back through the port's
    reader and critpath.  Checks one exec and one device span per task,
    and the critical path's buckets: they must exceed the makespan by
    exactly the path's overlap (``overlap`` in ``attribute``'s result)
    and, on the card, sum to it within CRITPATH_TOL (on the CPU-backed
    module a task is short
    against the host's scheduling delays, which the overlap absorbs).
    Returns the buckets, the in-flight share (the union of the
    dispatch->done device spans over the pass's wall time: host stamps
    at both ends, the dispatch stamp taken once the wave is queued, so
    it approximates the card's busy share — from above, less the time a
    wave's first kernel runs before its span opens) and the
    completions the metrics plane sampled during the pass (the tracer
    consumes their ready stamps, so none reached the latency
    histogram).  With ``trace_dir`` the trace is kept there (its path
    under ``ptt``) for the tools phase."""
    prof = Profile(label)
    mods = [install_task_profiler(ctx, prof),
            install_causal_tracer(ctx, prof)]
    sampled0 = sampled_completions(ctx)
    try:
        wall = run_pass()
    finally:
        for mod in mods:
            mod.uninstall(ctx)
    sampled = sampled_completions(ctx) - sampled0
    tmp = trace_dir or tempfile.mkdtemp(prefix="parsec_trace_")
    try:
        path = prof.dump(os.path.join(tmp, slug(label) + ".ptt"))
        t0 = time.perf_counter()
        rows, _metas = critpath.merge_traces([path])
        tasks, preds, ready = critpath.build_dag(rows)
        cpath = critpath.critical_path(tasks, preds)
        att = critpath.attribute(cpath, tasks, ready)
        over = att["overlap"]
        read_s = time.perf_counter() - t0
        size = os.path.getsize(path)
    finally:
        if trace_dir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    ivs = intervals(rows)
    dev = [(iv["ts_begin"], iv["ts_end"]) for iv in ivs
           if iv["name"].startswith("dev:")]
    exe = [iv for iv in ivs if iv["name"] != "queue_wait"
           and not iv["name"].startswith("dev:")]
    b = att["buckets"]
    total = sum(b.values())
    inflight = span_union(dev) / wall
    log(f"[{label}] traced pass (task profiler + causal tracer): "
        f"{wall * 1e3:.1f} ms against the untraced best "
        f"{best_s * 1e3:.1f} ms ({wall / best_s:.3f}x); {len(rows)} events "
        f"({size / 2**20:.2f} MiB, read back and attributed in "
        f"{read_s:.2f} s), {len(exe)} exec spans, {len(dev)} dev: spans "
        f"for {ntasks} tasks; critical path of {len(att['path'])} tasks: "
        f"exec {b['exec'] * 1e3:.3f} ms, queue {b['queue'] * 1e3:.3f} ms, "
        f"comm {b['comm'] * 1e3:.3f} ms, idle {b['idle'] * 1e3:.3f} ms, "
        f"sum {total * 1e3:.3f} ms against the makespan "
        f"{att['makespan'] * 1e3:.3f} ms (tol {CRITPATH_TOL:.0%}; "
        f"overlapping steps {over * 1e3:.3f} ms); "
        f"in-flight share {inflight:.3f} (union of dispatch->done device "
        f"spans over the pass; approximates the card's busy share from above, "
        f"less what a wave runs before its span opens)")
    if len(dev) != ntasks or len(exe) != ntasks:
        raise AssertionError(f"[{label}] traced pass: {len(exe)} exec and "
                             f"{len(dev)} dev: spans, expected {ntasks}")
    # the buckets are rounded to 1e-6 s each
    if abs(total - att["makespan"] - over) > 1e-5:
        raise AssertionError(f"[{label}] critical-path buckets {b} sum to "
                             f"{total}, not the makespan {att['makespan']} "
                             f"plus the overlap {over}")
    on_card = ctx.device_registry.accelerators[0].is_cuda
    if on_card and abs(total - att["makespan"]) \
            > CRITPATH_TOL * att["makespan"]:
        raise AssertionError(f"[{label}] critical-path buckets {b} sum to "
                             f"{total}, the makespan is {att['makespan']}")
    return {"wall_ms": wall * 1e3, "untraced_best_ms": best_s * 1e3,
            "events": len(rows), "dev_spans": len(dev),
            "buckets_ms": {k: v * 1e3 for k, v in b.items()},
            "makespan_ms": att["makespan"] * 1e3,
            "overlap_ms": over * 1e3,
            "critical_path_tasks": len(att["path"]),
            "inflight_share": inflight, "sampled": sampled,
            "ntasks": ntasks, "ptt": path if trace_dir is not None else None}


#: the tiled GEMM of apps/gemm.py written as a JDF text: one task class,
#: C(m, n) chained over k, K1 as its device body (bound at build time)
JDF_GEMM = r"""
extern "C" %{
/* C += A B, tile by tile: the k chain of C(m, n) */
%}

descA  [ type = "parsec_tiled_matrix_t*" ]
descB  [ type = "parsec_tiled_matrix_t*" ]
descC  [ type = "parsec_tiled_matrix_t*" ]

GEMM(m, n, k)

m = 0 .. descC->mt - 1
n = 0 .. descC->nt - 1
k = 0 .. descA->nt - 1

: descC( m, n )

READ Ai <- descA( m, k )
READ Bi <- descB( k, n )
RW   Ci <- (k == 0) ? descC( m, n ) : Ci GEMM( m, n, k-1 )
        -> (k < descA->nt - 1) ? Ci GEMM( m, n, k+1 ) : descC( m, n )

BODY [ type = CUDA ]
{
    gemm_tile(Ai, Bi, Ci, 1.0);
}
END
"""

#: the front-ends a GEMM pass can be submitted through
FRONTS = ("ptg", "dtd", "jdf")


def gemm_pass(ctx: Context, front: str, A, B, C) -> dict:
    """One C += A @ B pass through ``front``: the PTG API, DTD
    ``insert_task`` (a pool of its own, waited) or the JDF text; returns
    its wall time, the host time until the front-end handed the pass over
    (PTG and JDF: built and added; DTD: every task inserted), the calling
    thread's CPU time over that hand-over (DTD: discovery at insert time,
    without the waits for the GIL the wall time holds) and the
    process's CPU time over the pass (every thread's, spinning workers
    included)."""
    t0, cpu0 = time.perf_counter(), time.process_time()
    tcpu0 = time.thread_time()
    stalls = 0
    if front == "ptg":
        ctx.add_taskpool(gemm_taskpool(A, B, C))
    elif front == "dtd":
        tp = DTDTaskpool("gemm")
        ctx.add_taskpool(tp)
        gemm_dtd_insert(tp, A, B, C)
    elif front == "jdf":
        ctx.add_taskpool(jdf_taskpool(
            JDF_GEMM, name="gemm_jdf",
            data={"descA": A, "descB": B, "descC": C},
            bodies={"GEMM": (_tile_kernel(1.0),
                             lambda Ai, Bi, Ci:
                             gemm_tile_reference(Ai, Bi, Ci, 1.0))}))
    else:
        raise ValueError(f"front {front!r} not in {FRONTS}")
    submit = time.perf_counter() - t0
    submit_cpu = time.thread_time() - tcpu0
    if front == "dtd":
        tp.wait()
        stalls = tp.window_stalls
        # one class for every insert (the body is one closure), so the
        # device module can fuse the pool's waves
        if len(tp.task_classes) != 1:
            raise AssertionError(f"DTD GEMM pass made "
                                 f"{len(tp.task_classes)} task classes")
    ctx.wait()
    return {"s": time.perf_counter() - t0, "submit_s": submit,
            "submit_cpu_s": submit_cpu,
            "cpu_s": time.process_time() - cpu0, "stalls": stalls}


def clock_step_us(clock=time.thread_time, spin_s: float = 0.05) -> float:
    """The least step seen in ``clock`` while this thread spins for
    ``spin_s`` of wall time, in us: the resolution the CPU-time readings
    really have (a kernel that counts CPU time in scheduler ticks steps
    by milliseconds whatever ``time.get_clock_info`` says)."""
    step, last = float("inf"), clock()
    end = time.perf_counter() + spin_s
    while time.perf_counter() < end:
        now = clock()
        if now != last:
            step, last = min(step, now - last), now
    return step * 1e6


def seeded_tile(name: str, m: int, n: int, mb: int, t: int,
                dtype: torch.dtype, tdev: torch.device) -> torch.Tensor:
    """Tile (m, n) of operand ``name`` from a generator seeded by its
    index: any rank, and any run, rebuilds it bit for bit."""
    g = torch.Generator(device=tdev).manual_seed(
        SEED + 7 + 1000 * ord(name) + m * t + n)
    return torch.randn((mb, mb), generator=g, device=tdev).to(dtype)


def drive_gemm(ctx: Context, mb: int, mt: int, nt: int, kt: int,
               passes: int, gen: torch.Generator, label: str,
               traced: bool = False, fronts=("ptg",),
               seeded: bool = False, keep: dict = None,
               trace_dir: str = None) -> dict:
    """The tiled GEMM through the runtime: tiles born on the device, one
    warm pass then ``passes`` timed passes of insert + wait through each
    of ``fronts`` in turns (each on a C of its own, from the same C0, A
    and B); checks C, kernel launches, executed tasks and incarnations
    per pass, and with several fronts every C bit for bit against the
    first front's.  ``seeded`` draws the tiles from ``seeded_tile``
    instead of ``gen``; ``keep`` receives the last front's final C tiles
    (on the card).  Returns numbers: the first front's at the top level,
    each front's under ``fronts``."""
    dev = ctx.device_registry.accelerators[0]
    on_card = dev.is_cuda
    A = TwoDimBlockCyclic(mb, mb, mt * mb, kt * mb, dtype=torch.bfloat16,
                          name="A")
    B = TwoDimBlockCyclic(mb, mb, kt * mb, nt * mb, dtype=torch.bfloat16,
                          name="B")
    Cs = {f: TwoDimBlockCyclic(mb, mb, mt * mb, nt * mb,
                               dtype=torch.float32, name=f"C_{f}")
          for f in fronts}
    t0 = time.perf_counter()
    c0 = {}
    for M in (A, B, Cs[fronts[0]]):
        for (m, n) in M.local_tiles():
            if seeded:
                tile = seeded_tile(M.name[0], m, n, mb, max(mt, nt, kt),
                                   M.dtype, dev.tdev)
            else:
                tile = torch.randn(M.tile_shape(m, n), generator=gen,
                                   device=dev.tdev).to(M.dtype)
            if M.name.startswith("C"):
                c0[(m, n)] = tile
                for C in Cs.values():
                    C.place_on_device(m, n, dev, tile.clone())
            else:
                M.place_on_device(m, n, dev, tile)
    if on_card:
        torch.cuda.synchronize()
    log(f"[{label}] tiles born on {dev.name}: "
        f"{time.perf_counter() - t0:.2f} s")
    ntasks = mt * nt * kt
    flops = total_flops(mt * mb, nt * mb, kt * mb)
    inc = _Incarnations(ctx)
    # counts go to 0 just before the path runs and are read just after
    reset_counts()
    inc.take()
    dev0 = device_counts(dev)
    per = {f: {"passes": [], "device": dict.fromkeys(DEVICE_STATS, 0)}
           for f in fronts}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        read_clock(label, "before the passes")
    for p in range(passes + 1):
        for front in fronts:
            tiles0, wgmma0 = k1_tiles()
            executed0 = dev.stats.executed_tasks
            d0 = device_counts(dev)
            run = gemm_pass(ctx, front, A, B, Cs[front])
            for k, v in device_counts(dev).items():
                per[front]["device"][k] += v - d0[k]
            launched = k1_tiles()[0] - tiles0
            wgmma = k1_tiles()[1] - wgmma0
            executed = dev.stats.executed_tasks - executed0
            counts = inc.take()
            device_runs = counts.get(("GEMM", "exec_async"), 0)
            cpu_runs = sum(v for (_c, event), v in counts.items()
                           if event == "exec_end")
            if executed != ntasks or device_runs != ntasks or cpu_runs:
                raise AssertionError(
                    f"[{label}] {front} pass {p}: executed_tasks "
                    f"{executed}, device incarnations {device_runs}, CPU "
                    f"incarnations {cpu_runs}; expected {ntasks}, "
                    f"{ntasks}, 0")
            if on_card and (launched != ntasks or wgmma != ntasks):
                raise AssertionError(
                    f"[{label}] {front} pass {p}: gemm_tile computed "
                    f"{launched} tiles, {wgmma} on the wgmma route, "
                    f"expected {ntasks} and {ntasks}")
            kind = "warm" if p == 0 else "timed"
            dt = run["s"]
            log(f"[{label}] {front} pass {p} ({kind}): {dt * 1e3:.1f} ms, "
                f"{flops / dt / 1e9:.1f} GFLOP/s, {launched} K1 tiles "
                f"({wgmma} wgmma), {executed} device tasks, {cpu_runs} CPU "
                f"incarnations; submitted in {run['submit_s'] * 1e3:.1f} "
                f"ms, host CPU {run['cpu_s'] * 1e6 / ntasks:.1f} us/task"
                + (f", window stalls {run['stalls']}"
                   if front == "dtd" else ""))
            if p:
                per[front]["passes"].append(run)
    if on_card:
        read_clock(label, "after the last timed pass")
    launches = read_counts()
    log(f"[{label}] kernel launches on this path: {launches}; K1 single "
        f"launches by route {read_routes()}, grouped members "
        f"{GROUPED_MEMBERS.value}"
        + (f"; peak device memory "
           f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
           if on_card else ""))
    device = report_device(label, dev, dev0)
    # C = C0 + (passes + 1) * A @ B, against the plain version tile by
    # tile (the first front); every other front's C bit for bit
    first = Cs[fronts[0]]
    worst = 0.0
    identical = {f: True for f in fronts[1:]}
    for (m, n) in first.local_tiles():
        prod = torch.zeros_like(c0[(m, n)])
        for k in range(kt):
            a = A.data_of(m, k).copy_on(dev.space).payload
            b = B.data_of(k, n).copy_on(dev.space).payload
            prod = gemm_tile_reference(a, b, prod, 1.0)
        ref = c0[(m, n)] + (passes + 1) * prod
        got = newest_payload(first, m, n).to(dev.tdev)
        if not torch.isfinite(got).all():
            raise AssertionError(f"[{label}] C({m},{n}) is not finite")
        worst = max(worst, rel_err(got, ref))
        for f in identical:
            other = newest_payload(Cs[f], m, n).to(dev.tdev)
            identical[f] = identical[f] and torch.equal(other, got)
        if keep is not None:
            keep[(m, n)] = newest_payload(Cs[fronts[-1]], m, n).to(
                dev.tdev).clone()
    log(f"[{label}] {fronts[0]} C vs tile-by-tile plain product: rel err "
        f"{worst:.3e} (tol 1e-3)"
        + "".join(f"; {f} C bit-identical to the {fronts[0]} C: {ok}"
                  for f, ok in identical.items()))
    if worst > 1e-3:
        raise AssertionError(f"[{label}] C disagrees: {worst}")
    if not all(identical.values()):
        raise AssertionError(f"[{label}] C differs between front-ends: "
                             f"{identical}")
    out_fronts = {}
    for f, r in per.items():
        best = min(q["s"] for q in r["passes"])
        d = r["device"]
        out_fronts[f] = {
            "best_s": best, "gflops": flops / best / 1e9,
            "host_us_per_task": min(q["cpu_s"] for q in r["passes"])
            * 1e6 / ntasks,
            "submit_us_per_task": min(q["submit_s"] for q in r["passes"])
            * 1e6 / ntasks,
            # mean over the timed passes: the thread clock may step
            # coarsely (clock_step_us), and a sum holds more of its steps
            "submit_cpu_us_per_task": sum(q["submit_cpu_s"]
                                          for q in r["passes"])
            * 1e6 / (ntasks * len(r["passes"])),
            "window_stalls": sum(q["stalls"] for q in r["passes"]),
            "mean_wave_width": d["fused_tasks"] / d["fused_launches"]
            if d["fused_launches"] else 1.0,
            "donated_tasks": d["donated_tasks"]}
    best = out_fronts[fronts[0]]["best_s"]
    trace = None
    if traced:
        def one_pass() -> float:
            executed0 = dev.stats.executed_tasks
            dt = gemm_pass(ctx, fronts[0], A, B, first)["s"]
            if dev.stats.executed_tasks - executed0 != ntasks:
                raise AssertionError(f"[{label}] traced pass: executed "
                                     f"{dev.stats.executed_tasks - executed0}"
                                     f" tasks, expected {ntasks}")
            return dt
        trace = traced_pass(ctx, one_pass, label, ntasks, best, trace_dir)
    return {"launches": launches, "best_s": best,
            "gflops": flops / best / 1e9, "ntasks": ntasks,
            "device": device, "trace": trace, "fronts": out_fronts}


def path_summary(res: dict, pass_s: float) -> dict:
    """What a path reports for the device module's A/B: its pass time, wave
    width, chains, donations and device memory peak."""
    d = res["device"]
    return {"launches": res["launches"], "pass_ms": pass_s * 1e3,
            "mean_wave_width": d["mean_wave_width"],
            "fused_launches": d["fused_launches"],
            "chained_launches": d["chained_launches"],
            "donated_tasks": d["donated_tasks"],
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def tile_kernel_ms(gen: torch.Generator, mb: int) -> float:
    """K1's device time on one mb^3 tile (CUDA events, single launches)."""
    A = torch.randn((mb, mb), generator=gen, device="cuda").bfloat16()
    B = torch.randn((mb, mb), generator=gen, device="cuda").bfloat16()
    C = torch.randn((mb, mb), generator=gen, device="cuda")
    return time_ms(lambda: gemm_tile(A, B, C, 1.0), reps=20)


def idle_share(ntasks: int, k_ms: float, pass_s: float) -> float:
    """The card's idle share over a pass, estimated: the kernel time of
    one tile times the tiles of the pass, against the pass's wall time."""
    return max(0.0, 1.0 - ntasks * k_ms * 1e-3 / pass_s)


def phase_small_tiles(ctx: Context, gen: torch.Generator,
                      traced: bool = False, trace_dir: str = None) -> dict:
    mb, t = 2048, 8
    res = drive_gemm(ctx, mb, t, t, t, passes=3, gen=gen, label="mb=2048",
                     traced=traced, trace_dir=trace_dir)
    k_ms = tile_kernel_ms(gen, mb)
    idle = idle_share(res["ntasks"], k_ms, res["best_s"])
    log(f"[mb=2048] sched_native {params.get('sched_native')}: best pass "
        f"{res['best_s'] * 1e3:.1f} ms, {res['gflops']:.1f} GFLOP/s; kernel "
        f"{k_ms * 1e3:.1f} us/tile; estimated device idle share {idle:.3f}")
    summary = path_summary(res, res["best_s"])
    summary["idle_share"] = idle
    if res["trace"] is not None:
        log(f"[mb=2048] in-flight share of the traced pass "
            f"{res['trace']['inflight_share']:.3f} (approximates the "
            f"card's busy share) beside the estimated busy share "
            f"{1.0 - idle:.3f} (estimated idle share {idle:.3f})")
        summary["trace"] = res["trace"]
    return summary


def phase_gram(dev: torch.device, peaks) -> dict:
    """gram_tile vs its plain version on the card at the QR path's shape
    and at ragged ones; timings and bound at the path's shape."""
    _, f32_peak, mem_rate = peaks
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    cases = [("path", 6144, 512), ("ragged", 100, 36),
             ("ragged", 1000, 36), ("ragged", 513, 257),
             ("ragged", 6145, 512), ("narrow", 333, 1), ("narrow", 333, 33),
             ("tall", 12288, 512)]
    entry = None
    for label, m, n in cases:
        X = torch.randn((m, n), generator=g, device=dev)
        got = gram_tile(X)
        torch.cuda.synchronize()
        ref = gram_tile_reference(X)
        err = rel_err(got, ref)
        max_abs = (got - ref).abs().max().item()
        ok = err <= TOL[torch.float32]
        log(f"gram_tile vs plain {label} {m}x{n}: rel err {err:.3e} "
            f"(tol {TOL[torch.float32]:.0e}) max abs {max_abs:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"gram_tile disagrees with its plain "
                                 f"version: {err} > {TOL[torch.float32]}")
        if label == "path":
            again = gram_tile(X)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError("gram_tile: two calls on one input "
                                     "differ")
            log(f"gram_tile at {m}x{n}: two calls bit-identical; split plan "
                f"(splits, rows) "
                f"{cuda_kernels.gram_split_plan(m, n, sm_count(dev))}")
            del again
            # least work: the upper triangle, m*n*(n+1) flop; X read and
            # G written once
            flops = float(m) * n * (n + 1)
            nbytes = 4.0 * (m * n + n * n)
            t_ops = flops / f32_peak * 1e3
            t_bytes = nbytes / mem_rate * 1e3
            bound = max(t_ops, t_bytes)
            torch.backends.cuda.matmul.allow_tf32 = False
            t = in_turns({"kernel": lambda: gram_tile(X),
                          "plain": lambda: gram_tile_reference(X),
                          "library": lambda: torch.mm(X.T, X)}, reps=200)
            ms, plain_ms, lib_ms = t["kernel"], t["plain"], t["library"]
            log(f"gram_tile at {m}x{n} f32: kernel {ms:.4f} ms "
                f"({2 * flops / ms / 1e9:.2f} TFLOP/s counted as 2mn^2), "
                f"plain {plain_ms:.4f} ms, library_ms {lib_ms:.4f} "
                f"(torch.mm(X.T, X), TF32 off), bound {bound:.4f} ms "
                f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
                f"share of bound {bound / ms:.3f}; kernel / library "
                f"{ms / lib_ms:.3f}")
            entry = {"name": "gram_tile", "route": "cuda",
                     "source": "parsec_tpu_torch/csrc/gram_tile.cu",
                     "replaces": "parsec_tpu/apps/pallas_kernels.py:169",
                     "launches": 0, "max_abs_err": max_abs, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes",
                     "library_ms": lib_ms}
        del X, got, ref
    return entry


def qr_tile_maker(A: TwoDimBlockCyclic, tdev: torch.device, seed: int,
                  conditioned: bool = False):
    """The QR operand, tile by tile, each tile from its own seeded
    generator and rounded to the storage dtype — so it regenerates exactly
    without a second resident copy.

    The geqrf bench operand (``conditioned=False``): 0.05 * N(0, 1) + I in
    every tile.  Its identity blocks make it near-singular at scale
    (cond 1e3 already at n = 96), so the least-squares ladder, which
    contracts only while cond^2 * eps_bf16 < 1, diverges on its bf16
    factor — in the JAX package too.  The conditioned operand I +
    (0.25 / sqrt(n)) * N(0, 1) keeps every singular value in [0.5, 1.5],
    where the ladder's contract holds."""
    n = A.lm
    scale = 0.25 / n ** 0.5 if conditioned else 0.05

    def tile(m: int, k: int) -> torch.Tensor:
        g = torch.Generator(device=tdev).manual_seed(seed + m * A.nt + k)
        t = scale * torch.randn(A.tile_shape(m, k), generator=g, device=tdev)
        if m == k or not conditioned:
            t.diagonal().add_(1.0)
        return t.to(A.dtype)
    return tile


def qr_residual(A: TwoDimBlockCyclic, orig) -> float:
    """Stochastic factorization check without Q: an orthogonal QR has
    R^T R = A^T A, so compare the two quadratic forms on a random probe
    (O(n^2) matvecs, tile-streamed; R from A's tiles, the operand
    regenerated)."""
    nt, mb = A.mt, A.mb
    dev = orig(0, 0).device
    rng = np.random.default_rng(123)
    z = [torch.from_numpy(rng.standard_normal(mb).astype(np.float32))
         .to(dev) for _ in range(nt)]
    w = [torch.zeros(mb, device=dev) for _ in range(nt)]
    v = [torch.zeros(mb, device=dev) for _ in range(nt)]
    tiles = A.local_tiles()
    for m, n in tiles:
        w[m] += orig(m, n).float() @ z[n]
        if m <= n:
            v[m] += newest_payload(A, m, n).float() @ z[n]
    y1 = [torch.zeros(mb, device=dev) for _ in range(nt)]
    y2 = [torch.zeros(mb, device=dev) for _ in range(nt)]
    for m, n in tiles:
        y2[n] += orig(m, n).float().T @ w[m]
        if m <= n:
            y1[n] += newest_payload(A, m, n).float().T @ v[m]
    num = float(torch.sqrt(sum(torch.sum((a - b) ** 2)
                               for a, b in zip(y1, y2))))
    den = float(torch.sqrt(sum(torch.sum(b ** 2) for b in y2)))
    return num / den


def qr_task_counts(nt: int) -> dict:
    panel = nt * (nt - 1) // 2
    return {"GEQRT": nt, "UNMQR": panel, "TSQRT": panel,
            "TSMQR": sum((nt - 1 - k) ** 2 for k in range(nt))}


def drive_qr(ctx: Context, mb: int, nt: int, dtype: torch.dtype,
             passes: int, label: str, ladder_steps: int = 4,
             require_fusion: bool = False, keep: dict = None) -> dict:
    """The tiled QR through the runtime at the ``qr_ib`` in force: the
    bench operand regenerated on the device before every pass (outside
    the timed window), one warm pass then ``passes`` timed passes of
    insert + wait, tasks, incarnations and kernel launches checked on
    every pass; then R's lower tiles and the factorization residual.  One
    more pass factors the conditioned operand, on which the least-squares
    ladder is held to its limit (the bench operand's ladder is printed: it
    cannot converge, see ``qr_tile_maker``).  ``require_fusion``: at the
    device module's defaults the timed passes must chain panels.  ``keep``
    receives the conditioned operand's R tiles (the 2-rank path's
    reference).  Returns numbers."""
    dev = path_device(ctx)
    on_card = dev.is_cuda
    n = nt * mb
    A = TwoDimBlockCyclic(mb, mb, n, n, dtype=dtype, name="A")
    want = qr_task_counts(nt)
    ntasks = sum(want.values())
    ib = qr.effective_ib(mb)
    blocks = mb // ib if ib else 1
    want_k1 = want["UNMQR"] + 3 * want["TSMQR"]
    want_k2 = 2 * blocks * want["GEQRT"]
    flops = qr.geqrf_flops(n, n)
    inc = _Incarnations(ctx)

    def factor(orig, what: str) -> float:
        """Regenerate A from ``orig``, factor it once, check the counts;
        returns the pass's wall time (insert + wait + synchronize)."""
        t0 = time.perf_counter()
        for (m, k) in A.local_tiles():
            place(A, m, k, dev, orig(m, k))
        if on_card:
            torch.cuda.synchronize()
        regen_s = time.perf_counter() - t0
        launches0 = read_counts()
        tiles0, wgmma0 = k1_tiles()
        executed0 = dev.stats.executed_tasks
        falls0 = qr.qr_guard_fallbacks.value
        t0 = time.perf_counter()
        ctx.add_taskpool(qr.qr_taskpool(A))
        ctx.wait()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = {k: v - launches0[k] for k, v in read_counts().items()}
        tiles = k1_tiles()[0] - tiles0
        wgmma = k1_tiles()[1] - wgmma0
        executed = dev.stats.executed_tasks - executed0
        counts = inc.take()
        device_runs = {c: counts.get((c, "exec_async"), 0) for c in want}
        cpu_runs = sum(counts.get((c, "exec_end"), 0) for c in want)
        if executed != ntasks or device_runs != want or cpu_runs:
            raise AssertionError(
                f"[{label}] {what}: executed_tasks {executed}, device "
                f"incarnations {device_runs}, CPU incarnations {cpu_runs}; "
                f"expected {ntasks}, {want}, 0")
        if on_card and (tiles != want_k1 or wgmma != want_k1
                        or launched["gram_tile"] != want_k2):
            raise AssertionError(f"[{label}] {what}: launched {launched}, "
                                 f"{tiles} K1 tiles, {wgmma} on the wgmma "
                                 f"route, expected {want_k1} K1 tiles, all "
                                 f"on wgmma, and {want_k2} K2 launches")
        log(f"[{label}] {what}: {dt * 1e3:.1f} ms, "
            f"{flops / dt / 1e9:.1f} GFLOP/s, launches {launched} ({tiles} "
            f"K1 tiles, {wgmma} wgmma), "
            f"{executed} device tasks {device_runs}, {cpu_runs} CPU "
            f"incarnations, guard fallbacks "
            f"{qr.qr_guard_fallbacks.value - falls0}; tiles regenerated "
            f"in {regen_s * 1e3:.1f} ms (untimed)")
        return dt

    def lower_tiles_zero() -> None:
        nonzero = [(m, k) for (m, k) in A.local_tiles() if m > k
                   and bool(newest_payload(A, m, k).any())]
        if nonzero:
            raise AssertionError(f"[{label}] tiles below the diagonal are "
                                 f"not zero: {nonzero}")

    log(f"[{label}] mb={mb} nt={nt} n={n} {str(dtype)[6:]} storage, "
        f"qr_ib={ib}: {ntasks} tasks a pass {want}, {flops:.4e} flop")
    bench = qr_tile_maker(A, dev.tdev, SEED + 3)
    conditioned = qr_tile_maker(A, dev.tdev, SEED + 4, conditioned=True)
    # counts go to 0 just before the path runs and are read just after
    reset_counts()
    inc.take()
    fallbacks0 = qr.qr_guard_fallbacks.value
    dev0 = device_counts(dev)
    if on_card:
        read_clock(label, "before the passes")
    times = [factor(bench, f"pass {p} ({'timed' if p else 'warm'})")
             for p in range(passes + 1)][1:]
    if on_card:
        read_clock(label, "after the last timed pass")
    device = report_device(label, dev, dev0, need_chained=require_fusion)

    t0 = time.perf_counter()
    lower_tiles_zero()
    residual = qr_residual(A, bench)
    bench_ladder = ls_refine(A, bench, steps=ladder_steps)
    log(f"[{label}] bench operand: lower tiles zero; factorization "
        f"residual ||R'Rz-A'Az||/||A'Az|| = {residual:.3e} (limit "
        f"{QR_RESIDUAL_TOL:.0e}); LS-refine errors, held to no limit (the "
        f"operand is too ill-conditioned for the ladder, see "
        f"qr_tile_maker): "
        f"{['%.3e' % h for h in bench_ladder]}; checks took "
        f"{time.perf_counter() - t0:.1f} s")
    if not residual <= QR_RESIDUAL_TOL:
        raise AssertionError(f"[{label}] residual {residual} > "
                             f"{QR_RESIDUAL_TOL}")

    factor(conditioned, "ladder pass (conditioned operand, untimed)")
    lower_tiles_zero()
    cond_residual = qr_residual(A, conditioned)
    ladder = ls_refine(A, conditioned, steps=ladder_steps)
    log(f"[{label}] conditioned operand: lower tiles zero; factorization "
        f"residual {cond_residual:.3e}; LS-refine errors (CSNE direct, "
        f"then one refinement step each): {['%.3e' % h for h in ladder]} "
        f"(limit {QR_LADDER_TOL:.0e})")
    if not cond_residual <= QR_RESIDUAL_TOL:
        raise AssertionError(f"[{label}] conditioned residual "
                             f"{cond_residual} > {QR_RESIDUAL_TOL}")
    if not min(ladder) <= QR_LADDER_TOL:
        raise AssertionError(f"[{label}] LS ladder {ladder} never reached "
                             f"{QR_LADDER_TOL}")
    if keep is not None:
        keep.update({(m, k): newest_payload(A, m, k).to(dev.tdev)
                     for (m, k) in A.local_tiles() if m <= k})
    launches = read_counts()
    fallbacks = qr.qr_guard_fallbacks.value - fallbacks0
    log(f"[{label}] kernel launches on this path: {launches}; K1 single "
        f"launches by route {read_routes()}, grouped members "
        f"{GROUPED_MEMBERS.value}; guard fallbacks {fallbacks}")
    best = min(times)
    return {"launches": launches, "best_s": best,
            "gflops": flops / best / 1e9, "ntasks": ntasks,
            "fallbacks": fallbacks, "residual": residual,
            "bench_ladder": bench_ladder, "ladder": ladder,
            "device": device}


def qr_class_times(dev: torch.device, mb: int, ib: int,
                   dtype: torch.dtype) -> dict:
    """Device time of one body of each QR task class at the path's shapes
    (CUDA events, mean of 3 calls after a warm one), on the bench
    operand's tiles: the breakdown of a pass, outside any path run."""
    tile = qr_tile_maker(TwoDimBlockCyclic(mb, mb, 2 * mb, 2 * mb,
                                           dtype=dtype), dev, SEED + 5)
    T, B, C1, C2 = tile(0, 0), tile(1, 0), tile(0, 1), tile(1, 1)
    q1 = torch.zeros((mb, mb), dtype=dtype, device=dev)
    q2 = torch.zeros((2 * mb, mb), dtype=dtype, device=dev)
    geqrt, tsqrt = qr._mk_geqrt(ib), qr._mk_tsqrt(ib)
    unmqr, tsmqr = qr._mk_unmqr(), qr._mk_tsmqr()
    out = geqrt(T, q1)
    R, Q1 = out["T"], out["Q"]
    Q2 = tsqrt(R, B, q2)["Q"]
    return {"GEQRT": time_ms(lambda: geqrt(T, q1), reps=3),
            "UNMQR": time_ms(lambda: unmqr(Q1, C1), reps=3),
            "TSQRT": time_ms(lambda: tsqrt(R, B, q2), reps=3),
            "TSMQR": time_ms(lambda: tsmqr(Q2, C1, C2), reps=3)}


def phase_qr(ctx: Context, keep: dict = None) -> dict:
    mb, nt = 6144, 8
    ib = qr.effective_ib(mb)        # the registered qr_ib, 512
    torch.cuda.reset_peak_memory_stats()
    res = drive_qr(ctx, mb, nt, torch.bfloat16, passes=3,
                   label="QR path mb=6144", require_fusion=True, keep=keep)
    log(f"[QR path mb=6144] best pass {res['best_s'] * 1e3:.1f} ms, "
        f"{res['gflops']:.1f} GFLOP/s (geqrf_flops(n, n) / best pass); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
        f" GiB; peak host RSS of the process so far "
        f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.2f}"
        f" GiB")
    summary = path_summary(res, res["best_s"])
    # where the time goes, estimated: one body of each class timed alone,
    # times the class's tasks in a pass, against the best pass
    ms = qr_class_times(torch.device("cuda", 0), mb, ib, torch.bfloat16)
    counts = qr_task_counts(nt)
    busy = sum(ms[c] * counts[c] for c in counts) * 1e-3
    log("[QR path mb=6144] device ms per task: "
        + ", ".join(f"{c} {ms[c]:.2f} x {counts[c]} = "
                    f"{ms[c] * counts[c]:.0f}" for c in counts)
        + f"; sum {busy * 1e3:.0f} ms against the best pass "
        f"{res['best_s'] * 1e3:.0f} ms: estimated device idle share "
        f"{max(0.0, 1.0 - busy / res['best_s']):.3f}")
    return summary


def live_cuda_tensors(top: int = 6) -> list:
    """The largest groups of live CUDA tensors by shape and dtype, as
    (GiB, count, shape, dtype), after a cyclic collection."""
    gc.collect()
    groups = collections.Counter()
    counts = collections.Counter()
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            key = (tuple(o.shape), str(o.dtype)[6:])
            groups[key] += o.numel() * o.element_size()
            counts[key] += 1
    return [(round(b / 2**30, 2), counts[k], *k)
            for k, b in groups.most_common(top)]


def potrf_task_counts(nt: int) -> dict:
    panel = nt * (nt - 1) // 2
    return {"POTRF": nt - 1, "POTRFL": 1, "TRSM": panel, "SYRK": panel,
            "GEMM": sum(n * (nt - 1 - n) for n in range(1, nt - 1))}


def potrf_tile_maker(A: TwoDimBlockCyclic, tdev: torch.device):
    """The JAX package's potrf bench operand (``bench.py::_tile_generator``
    as ``run_potrf_bench`` stages it) over ``A``, a one-rank square tile
    grid, tile by tile on ``tdev``: ``apps/potrf.bench_operand``, the
    re-runnable source the fault-tolerance path gives ``set_init``, so a
    tile recovery remakes equals the one made here bit for bit."""
    return potrf.bench_operand(A.lm, A.mb, A.dtype, tdev)


def drive_potrf(ctx: Context, mb: int, nt: int, dtype: torch.dtype,
                passes: int, label: str, ir_steps: int = 3,
                require_fusion: bool = False, traced: bool = False,
                keep: dict = None, trace_dir: str = None) -> dict:
    """The tiled Cholesky through the runtime: the bench operand's lower
    tiles regenerated on the device before every pass (outside the timed
    window), one warm pass then ``passes`` timed passes of insert + wait +
    synchronize; tasks, incarnations, kernel launches and the pool's
    Cholesky flag checked on every pass (the flag is read after the timed
    window).  Then, once, the backward error and the refinement ladder of
    the last factor.  ``require_fusion``: at the device module's defaults
    the passes must fuse waves and chain panels.  ``keep`` receives the
    last factor's lower tiles (the 2-rank path's reference).  Returns
    numbers."""
    dev = path_device(ctx)
    on_card = dev.is_cuda
    n = nt * mb
    A = TwoDimBlockCyclic(mb, mb, n, n, dtype=dtype, name="A")
    want = potrf_task_counts(nt)
    ntasks = sum(want.values())
    want_k1 = want["SYRK"] + want["GEMM"]
    flops = potrf.potrf_flops(n)
    orig = potrf_tile_maker(A, dev.tdev)
    lower = [(m, k) for (m, k) in A.local_tiles() if m >= k]
    inc = _Incarnations(ctx)
    executed_flops = 0.0

    def factor(what: str) -> float:
        nonlocal executed_flops
        t0 = time.perf_counter()
        for (m, k) in lower:
            place(A, m, k, dev, orig(m, k))
        if on_card:
            torch.cuda.synchronize()
        regen_s = time.perf_counter() - t0
        launches0 = read_counts()
        tiles0, wgmma0 = k1_tiles()
        executed0 = dev.stats.executed_tasks
        t0 = time.perf_counter()
        tp = potrf.potrf_taskpool(A)
        ctx.add_taskpool(tp)
        ctx.wait()
        if on_card:
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        failed = tp.cholesky_check.failed()
        launched = {k: v - launches0[k] for k, v in read_counts().items()}
        tiles = k1_tiles()[0] - tiles0
        wgmma = k1_tiles()[1] - wgmma0
        executed = dev.stats.executed_tasks - executed0
        counts = inc.take()
        device_runs = {c: counts.get((c, "exec_async"), 0) for c in want}
        cpu_runs = sum(counts.get((c, "exec_end"), 0) for c in want)
        executed_flops = sum(tp.task_classes[c].properties["flops"] * want[c]
                             for c in want)
        if executed != ntasks or device_runs != want or cpu_runs:
            raise AssertionError(
                f"[{label}] {what}: executed_tasks {executed}, device "
                f"incarnations {device_runs}, CPU incarnations {cpu_runs}; "
                f"expected {ntasks}, {want}, 0")
        if on_card and (tiles != want_k1 or wgmma != want_k1
                        or launched["gram_tile"]):
            raise AssertionError(f"[{label}] {what}: launched {launched}, "
                                 f"{tiles} K1 tiles, {wgmma} on the wgmma "
                                 f"route, expected {want_k1} K1 tiles, all "
                                 f"on wgmma, and no K2")
        if failed:
            raise AssertionError(f"[{label}] {what}: a Cholesky factor "
                                 f"failed (info != 0 or not finite)")
        mem = ""
        if on_card:
            # W tiles die in Data <-> DataCopy reference cycles, which only
            # the cyclic collector frees: collect between passes (outside
            # the timed window) and show what that freed
            held = torch.cuda.memory_allocated()
            gc.collect()
            mem = (f"; device memory {held / 2**30:.2f} GiB allocated after "
                   f"the pass, {torch.cuda.memory_allocated() / 2**30:.2f} "
                   f"GiB once reference cycles are collected, peak "
                   f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[{label}] {what}: {dt * 1e3:.1f} ms, "
            f"{flops / dt / 1e9:.1f} GFLOP/s (n^3/3), executed "
            f"{executed_flops / dt / 1e9:.1f} GFLOP/s, launches {launched} "
            f"({tiles} K1 tiles, {wgmma} wgmma), {executed} device tasks "
            f"{device_runs}, "
            f"{cpu_runs} CPU incarnations, Cholesky flag clear; tiles "
            f"regenerated in {regen_s * 1e3:.1f} ms (untimed){mem}")
        return dt

    log(f"[{label}] mb={mb} nt={nt} n={n} {str(dtype)[6:]} storage: "
        f"{ntasks} tasks a pass {want}, {len(lower)} lower tiles, "
        f"{flops:.4e} flop (n^3/3)")
    # counts go to 0 just before the path runs and are read just after
    reset_counts()
    inc.take()
    dev0 = device_counts(dev)
    if on_card:
        read_clock(label, "before the passes")
    times = [factor(f"pass {p} ({'timed' if p else 'warm'})")
             for p in range(passes + 1)][1:]
    if on_card:
        read_clock(label, "after the last timed pass")
        log(f"[{label}] live CUDA tensors after the passes (GiB, count, "
            f"shape, dtype): {live_cuda_tensors()}")
    launches = read_counts()
    log(f"[{label}] kernel launches on this path: {launches}; K1 single "
        f"launches by route {read_routes()}, grouped members "
        f"{GROUPED_MEMBERS.value}")
    device = report_device(label, dev, dev0, need_fused=require_fusion,
                           need_chained=require_fusion)

    t0 = time.perf_counter()
    bwd = backward_error(A, orig)
    t1 = time.perf_counter()
    ir = refine_solve(A, orig, steps=ir_steps)
    log(f"[{label}] backward error ||A-LL'||_F/||A||_F = {bwd:.4e} (limit "
        f"{POTRF_BWD_TOL:.0e}, {t1 - t0:.1f} s); IR residuals (direct, then "
        f"one refinement step each): {['%.3e' % h for h in ir]} (last "
        f"limit {POTRF_IR_TOL:.0e}, {time.perf_counter() - t1:.1f} s)")
    if not bwd <= POTRF_BWD_TOL:
        raise AssertionError(f"[{label}] backward error {bwd} > "
                             f"{POTRF_BWD_TOL}")
    if not ir[-1] <= POTRF_IR_TOL:
        raise AssertionError(f"[{label}] last IR residual {ir[-1]} > "
                             f"{POTRF_IR_TOL}")
    gflops = [flops / t / 1e9 for t in times]
    trace = None
    if traced:
        trace = traced_pass(ctx, lambda: factor("pass traced"), label,
                            ntasks, min(times), trace_dir)
    if keep is not None:
        keep.update({(m, k): newest_payload(A, m, k).to(dev.tdev)
                     for (m, k) in lower})
    return {"launches": launches, "times": times, "gflops": gflops,
            "median_gflops": statistics.median(gflops),
            "executed_flops": executed_flops, "ntasks": ntasks,
            "backward_error": bwd, "ir": ir, "device": device,
            "trace": trace}


def potrf_class_times(dev: torch.device, mb: int,
                      dtype: torch.dtype) -> dict:
    """Device time of one body of each potrf task class at the path's
    shapes (CUDA events, mean of 3 calls after a warm one), on the bench
    operand's tiles: the breakdown of a pass, outside any path run."""
    tile = potrf_tile_maker(TwoDimBlockCyclic(mb, mb, 2 * mb, 2 * mb,
                                              dtype=dtype), dev)
    T, C, D = tile(0, 0), tile(1, 0), tile(1, 1)
    check = potrf.CholeskyCheck()
    factor, last = potrf._mk_potrf(check), potrf._mk_potrf_last(check)
    w = torch.zeros((mb, mb), device=dev)
    W = factor(T, w)["W"]
    R = potrf._k_trsm(W, C)
    ms = {"POTRF": time_ms(lambda: factor(T, w), reps=3),
          "POTRFL": time_ms(lambda: last(D), reps=3),
          "TRSM": time_ms(lambda: potrf._k_trsm(W, C), reps=3),
          "SYRK": time_ms(lambda: potrf._k_syrk(D, R), reps=3),
          "GEMM": time_ms(lambda: potrf._k_gemm(D, R, R), reps=3)}
    if check.failed():
        raise AssertionError("potrf class times: a Cholesky factor failed")
    return ms


def phase_potrf(ctx: Context, keep: dict = None,
                trace_dir: str = None) -> dict:
    mb, nt = 6144, 16
    label = "potrf path mb=6144"
    torch.cuda.reset_peak_memory_stats()
    res = drive_potrf(ctx, mb, nt, torch.bfloat16, passes=5, label=label,
                      require_fusion=True, traced=True, keep=keep,
                      trace_dir=trace_dir)
    g = res["gflops"]
    med_s = statistics.median(res["times"])
    log(f"[{label}] tiled_potrf_mp_gflops: median {res['median_gflops']:.1f}"
        f" GFLOP/s over {len(g)} timed passes (median-of-{len(g)}), best "
        f"{max(g):.1f}, band [{min(g):.1f}, {max(g):.1f}]; executed-flop "
        f"rate {res['executed_flops'] / med_s / 1e9:.1f} GFLOP/s at the "
        f"median pass; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    summary = path_summary(res, med_s)
    # where the time goes, estimated: one body of each class timed alone,
    # times the class's tasks in a pass, against the median pass
    ms = potrf_class_times(torch.device("cuda", 0), mb, torch.bfloat16)
    counts = potrf_task_counts(nt)
    busy = sum(ms[c] * counts[c] for c in counts) * 1e-3
    log(f"[{label}] device ms per task: "
        + ", ".join(f"{c} {ms[c]:.2f} x {counts[c]} = "
                    f"{ms[c] * counts[c]:.0f}" for c in counts)
        + f"; sum {busy * 1e3:.0f} ms against the median pass "
        f"{med_s * 1e3:.0f} ms: estimated device idle share "
        f"{max(0.0, 1.0 - busy / med_s):.3f}")
    idle = max(0.0, 1.0 - busy / med_s)
    log(f"[{label}] in-flight share of the traced pass "
        f"{res['trace']['inflight_share']:.3f} (approximates the "
        f"card's busy share) beside the estimated busy share "
        f"{1.0 - idle:.3f} (estimated idle share {idle:.3f})")
    summary["idle_share"] = idle
    summary["trace"] = res["trace"]
    return summary


# -- the remaining apps: ring attention, a recursive potrf, the wave ---------

#: ring attention's limits: the JAX package's test tolerance
#: (tests/test_apps_ring.py) against a float64 dense reference
ATTN_RTOL, ATTN_ATOL = 2e-4, 2e-5
#: query rows per block of the float64 dense reference
ATTN_REF_ROWS = 4096
#: the recursive potrf's limit, the served potrf job's check:
#: max|LL' - A| / max|A|, here in float64
RECURSIVE_POTRF_TOL = 1e-4


def attn_visit_ms(tdev: torch.device, T: int, d: int,
                  gen: torch.Generator) -> dict:
    """Device time of one visit of each class at the path's shapes (CUDA
    events, mean of 3 calls after a warm one), outside any path run:
    unmasked, the diagonal block's masked visit, the skipped visit."""
    acc = ring_attention.pack_query(torch.randn((T, d), generator=gen,
                                                device=tdev))
    blk = torch.randn((2 * T, d), generator=gen, device=tdev)
    causal = ring_attention._combine_torch_causal(T, T)
    return {"unmasked": time_ms(
        lambda: ring_attention._combine_torch(acc, blk), reps=3),
        "diagonal": time_ms(lambda: causal(acc, blk, 1), reps=3),
        "skipped": time_ms(lambda: causal(acc, blk, 0), reps=3)}


def drive_ring_attention(ctx: Context, P: int, T: int, d: int,
                         causal: bool, passes: int, gen: torch.Generator,
                         label: str) -> dict:
    """Ring attention through the runtime: Q, K and V of N = P*T tokens
    drawn from ``gen`` on the device, the packed KV blocks born there
    once and the accumulators re-packed before every pass (outside the
    timed window); one warm pass then ``passes`` timed passes of insert +
    wait + synchronize, each holding its tasks and their visit classes
    (the causal ring's ``vc``) to the ring's arithmetic.  Then every
    output row against the float64 dense reference, computed on the
    device ``ATTN_REF_ROWS`` query rows at a time."""
    dev = path_device(ctx)
    on_card = dev.is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tdev = dev.tdev
    # what the card holds before this path (the 2-rank paths' reference
    # tiles, kept since the potrf and QR paths): the path's own peak is
    # read above it
    held = torch.cuda.memory_allocated() / 2**30 if on_card else 0.0
    N = P * T
    Q, K, V = (torch.randn((N, d), generator=gen, device=tdev)
               for _ in range(3))
    KV = TwoDimBlockCyclic(2 * T, d, 2 * N, d, name="KV")
    ACC = TwoDimBlockCyclic(T, 2 * d + 2, N, 2 * d + 2, name="ACC")
    for q in range(P):
        rows = slice(q * T, (q + 1) * T)
        place(KV, q, 0, dev, ring_attention.pack_kv(K[rows], V[rows]))
    vc = ring_attention._causal_visit_class(P) if causal else None
    want = collections.Counter(vc(q, t) if causal else None
                               for q in range(P) for t in range(P))
    executed_visits = P * P - want.get(0, 0)
    # an executed visit: the two T x T x d products (q k^T, p v)
    flops = executed_visits * 4.0 * T * T * d
    visits = collections.Counter()
    lock = threading.Lock()

    def seen(es, event, task):
        with lock:
            visits[task.locals.get("vc")] += 1
    ctx.pins_register("complete_exec", seen)
    inc = _Incarnations(ctx)

    def run_pass(what: str) -> float:
        for q in range(P):
            place(ACC, q, 0, dev, ring_attention.pack_query(
                Q[q * T:(q + 1) * T]))
        sync()
        launches0 = read_counts()
        executed0 = dev.stats.executed_tasks
        visits.clear()
        t0 = time.perf_counter()
        ctx.add_taskpool(ring_attention.ring_attention_taskpool(
            KV, ACC, device="cuda", causal=causal))
        ctx.wait()
        sync()
        dt = time.perf_counter() - t0
        executed = dev.stats.executed_tasks - executed0
        counts = inc.take()
        launched = {k: v - launches0[k] for k, v in read_counts().items()}
        if executed != P * P or visits != want or \
                counts.get(("R", "exec_async"), 0) != P * P or \
                counts.get(("R", "exec_end"), 0) or any(launched.values()):
            raise AssertionError(
                f"[{label}] {what}: {executed} device tasks, visits by "
                f"class {dict(visits)}, incarnations {counts}, launches "
                f"{launched}; expected {P * P} device tasks, {dict(want)}, "
                f"no kernel of csrc/")
        log(f"[{label}] {what}: {dt * 1e3:.1f} ms, "
            f"{flops / dt / 1e12:.2f} TFLOP/s executed, visits by class "
            f"{dict(visits)}")
        return dt

    log(f"[{label}] N={N} tokens, d={d}, P={P} parties (Tq = Tkv = {T}), "
        f"f32, {'causal' if causal else 'non-causal'}; KV blocks "
        f"({2 * T}, {d}) and accumulators ({T}, {2 * d + 2}): "
        f"{(2 * N * d + N * (2 * d + 2)) * 4 / 2**20:.1f} MiB in all; a "
        f"visit's score and probability blocks {T * T * 4 / 2**20:.0f} MiB "
        f"each; {executed_visits} executed visits, {flops:.4e} flop a pass "
        f"(4 N^2 d = {4.0 * N * N * d:.4e}); allow_tf32 "
        f"{torch.backends.cuda.matmul.allow_tf32}")
    reset_counts()
    inc.take()
    dev0 = device_counts(dev)
    if on_card:
        read_clock(label, "before the passes")
    times = [run_pass(f"pass {p} ({'timed' if p else 'warm'})")
             for p in range(passes + 1)][1:]
    if on_card:
        read_clock(label, "after the last timed pass")
    peak = torch.cuda.max_memory_allocated() / 2**30 - held \
        if on_card else 0.0
    launches = read_counts()
    device = report_device(label, dev, dev0)

    t0 = time.perf_counter()
    ref = ring_attention.dense_reference(Q.double(), K.double(), V.double(),
                                         causal=causal, rows=ATTN_REF_ROWS)
    worst_abs, worst_excess = 0.0, -math.inf
    for q in range(P):
        got = ring_attention.unpack_output(
            newest_payload(ACC, q, 0), d).double()
        want_rows = ref[q * T:(q + 1) * T]
        err = (got - want_rows).abs()
        if not torch.isfinite(got).all():
            raise AssertionError(f"[{label}] party {q}: non-finite output")
        worst_abs = max(worst_abs, float(err.max()))
        worst_excess = max(worst_excess, float(
            (err - (ATTN_ATOL + ATTN_RTOL * want_rows.abs())).max()))
    best = min(times)
    log(f"[{label}] best of {len(times)} timed passes {best * 1e3:.1f} ms, "
        f"{flops / best / 1e12:.2f} TFLOP/s executed; peak device memory "
        f"over the passes {peak:.2f} GiB above the {held:.2f} GiB held "
        f"when the path began; output against the float64 dense "
        f"reference (rows of {ATTN_REF_ROWS}, "
        f"{time.perf_counter() - t0:.1f} s): max abs err {worst_abs:.3e}, "
        f"worst excess over {ATTN_ATOL:.0e} + {ATTN_RTOL:.0e}|ref| "
        f"{worst_excess:.3e} (must be <= 0)")
    if worst_excess > 0:
        raise AssertionError(f"[{label}] output outside rtol {ATTN_RTOL}, "
                             f"atol {ATTN_ATOL}: {worst_excess}")
    return {"launches": launches, "times": times, "best_s": best,
            "tflops": flops / best / 1e12, "visits": dict(want),
            "max_abs_err": worst_abs, "own_peak_gib": peak, "device": device}


def phase_ring_attention(ctx: Context, gen: torch.Generator,
                         causal: bool) -> dict:
    P, T, d = 8, 4096, 128
    label = f"ring attention{' causal' if causal else ''} N={P * T}"
    res = drive_ring_attention(ctx, P, T, d, causal, passes=3, gen=gen,
                               label=label)
    ms = attn_visit_ms(torch.device("cuda", 0), T, d, gen)
    v = res["visits"]
    per = {None: "unmasked", 2: "unmasked", 1: "diagonal", 0: "skipped"}
    busy = sum(ms[per[c]] * k for c, k in v.items()) * 1e-3
    idle = max(0.0, 1.0 - busy / res["best_s"])
    log(f"[{label}] device ms per visit: "
        + ", ".join(f"{k} {x:.3f}" for k, x in ms.items())
        + f"; the pass's {sum(v.values())} visits {busy * 1e3:.1f} ms "
        f"against the best pass {res['best_s'] * 1e3:.1f} ms: estimated "
        f"device idle share {idle:.3f}")
    summary = path_summary(res, res["best_s"])
    summary.update({"tflops": res["tflops"], "idle_share": idle,
                    "visit_ms": ms, "max_abs_err": res["max_abs_err"],
                    "own_peak_gib": res["own_peak_gib"]})
    return summary


def recursive_fact_pool(A: TwoDimBlockCyclic, inner_mb: int,
                        seen: list, inner: list):
    """FACT(A(0, 0)) factors the tile by an inner tiled-Cholesky pool on
    the device module over its ``inner_mb`` subtiles (the recursive
    device); CHECK, FACT's successor, records the diagonal and last row
    of the tile it reads into ``seen``.  ``inner`` receives the inner
    pools (their Cholesky flags)."""
    def body(T, es, task):
        sub = SubtileMatrix(task.data["T"].data, mb=inner_mb, nb=inner_mb)
        tp = potrf.potrf_taskpool(sub, device="cuda")
        inner.append(tp)
        return recursive_call(es, task, tp, callback=lambda _t: sub.commit())

    p = PTG("recursive_potrf")
    p.task("FACT") \
        .affinity(lambda A=A: A(0, 0)) \
        .flow("T", "RW",
              IN(DATA(lambda A=A: A(0, 0))),
              OUT(TASK("CHECK", "T", lambda: dict())),
              OUT(DATA(lambda A=A: A(0, 0)))) \
        .body(body)
    p.task("CHECK") \
        .affinity(lambda A=A: A(0, 0)) \
        .flow("T", "READ", IN(TASK("FACT", "T", lambda: dict()))) \
        .body(lambda T: seen.append((T.diagonal().clone(), T[-1].clone())))
    return p.build()


def drive_recursive_potrf(ctx: Context, n: int, inner_mb: int, passes: int,
                          gen: torch.Generator, label: str) -> dict:
    """One n x n f32 tile factored by ``recursive_fact_pool``: the SPD
    operand b b' + n I (b from ``gen``, formed on the device as the served
    potrf job forms it) copied into the host tile before every pass
    (outside the timed window), one warm pass then ``passes`` timed
    passes; per pass the inner pool's tasks on the device, K1's launches
    by route and the Cholesky flags.  Then the factor against the operand
    in float64 (``RECURSIVE_POTRF_TOL``), and CHECK's reading against the
    committed factor."""
    dev = ctx.device_registry.accelerators[0]
    on_card = dev.is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    b = torch.randn((n, n), generator=gen, device=dev.tdev)
    spd = b @ b.T + n * torch.eye(n, device=dev.tdev)
    del b
    A = TwoDimBlockCyclic(n, n, n, n, name="A").from_array(
        torch.empty((n, n)))
    nt = n // inner_mb
    want = potrf_task_counts(nt)
    want_k1 = want["SYRK"] + want["GEMM"]
    inc = _Incarnations(ctx)
    seen = []

    def run_pass(what: str) -> float:
        inner = []
        seen.clear()
        A.data_of(0, 0).overwrite_host(spd)
        sync()
        launches0, routes0 = read_counts(), read_routes()
        executed0 = dev.stats.executed_tasks
        t0 = time.perf_counter()
        ctx.add_taskpool(recursive_fact_pool(A, inner_mb, seen, inner))
        ctx.wait()
        sync()
        dt = time.perf_counter() - t0
        executed = dev.stats.executed_tasks - executed0
        counts = inc.take()
        launched = {k: v - launches0[k] for k, v in read_counts().items()}
        routes = {k: v - routes0[k] for k, v in read_routes().items()}
        device_runs = {c: counts.get((c, "exec_async"), 0) for c in want}
        # FACT's body hands the task to its inner pool (ASYNC); CHECK's
        # runs inline
        outer = {"FACT": counts.get(("FACT", "exec_async"), 0),
                 "CHECK": counts.get(("CHECK", "exec_end"), 0)}
        if executed != sum(want.values()) or device_runs != want or \
                outer != {"FACT": 1, "CHECK": 1} or len(seen) != 1:
            raise AssertionError(
                f"[{label}] {what}: {executed} device tasks {device_runs}, "
                f"outer tasks {outer}, CHECK ran {len(seen)} times; "
                f"expected {want}, FACT and CHECK once")
        if on_card and (routes.get("fma") != want_k1 or
                        launched["gemm_tile"] != want_k1 or
                        launched["gram_tile"] or
                        launched["gemm_tile_grouped"]):
            raise AssertionError(f"[{label}] {what}: launches {launched}, "
                                 f"K1 by route {routes}; expected "
                                 f"{want_k1} K1 on fma")
        if inner[0].cholesky_check.failed():
            raise AssertionError(f"[{label}] {what}: a Cholesky factor "
                                 f"failed")
        log(f"[{label}] {what}: {dt * 1e3:.1f} ms, "
            f"{potrf.potrf_flops(n) / dt / 1e9:.1f} GFLOP/s (n^3/3), inner "
            f"tasks {device_runs}, K1 by route {routes}, Cholesky flag "
            f"clear")
        return dt

    log(f"[{label}] one {n} x {n} f32 tile ({n * n * 4 / 2**20:.0f} MiB), "
        f"factored by an inner potrf over {inner_mb} subtiles (nt={nt}: "
        f"{sum(want.values())} inner tasks {want}) from FACT's body; CHECK "
        f"reads the committed tile")
    reset_counts()
    inc.take()
    dev0 = device_counts(dev)
    if on_card:
        read_clock(label, "before the passes")
    times = [run_pass(f"pass {p} ({'timed' if p else 'warm'})")
             for p in range(passes + 1)][1:]
    if on_card:
        read_clock(label, "after the last timed pass")
    launches = read_counts()
    routes = read_routes()
    device = report_device(label, dev, dev0)
    L = torch.tril(A.to_array()).to(dev.tdev, torch.float64)
    ref = spd.double()
    err = float((L @ L.T - ref).abs().max() / ref.abs().max())
    diag, last = seen[0]     # CHECK's reading in the last pass
    check_saw_factor = bool(torch.equal(diag.to(dev.tdev, torch.float64),
                                        L.diagonal())
                            and torch.equal(last.to(dev.tdev,
                                                    torch.float64), L[-1]))
    log(f"[{label}] best of {len(times)} timed passes "
        f"{min(times) * 1e3:.1f} ms; max|LL' - A|/max|A| in float64 "
        f"{err:.3e} (limit {RECURSIVE_POTRF_TOL:.0e}); CHECK read the "
        f"committed factor (its diagonal and last row bit for bit): "
        f"{check_saw_factor}; K1 launches {launches['gemm_tile']} by route "
        f"{routes}")
    if not err <= RECURSIVE_POTRF_TOL or not check_saw_factor:
        raise AssertionError(f"[{label}] residual {err}, CHECK saw the "
                             f"factor {check_saw_factor}")
    return {"launches": launches, "times": times, "best_s": min(times),
            "residual": err, "k1_fma": routes.get("fma", 0),
            "cpu_tasks": 2 * (passes + 1), "device": device}


def phase_recursive_potrf(ctx: Context, gen: torch.Generator) -> dict:
    res = drive_recursive_potrf(ctx, 8192, 2048, passes=3, gen=gen,
                                label="recursive potrf n=8192")
    summary = path_summary(res, res["best_s"])
    summary.update({"residual": res["residual"], "k1_fma": res["k1_fma"],
                    "cpu_tasks": res["cpu_tasks"]})
    return summary


def drive_wave(ctx: Context, P: int, n: int, passes: int,
               label: str, after_pass=None) -> dict:
    """The permute wave over P parties of n x n f32 tiles born on the
    device (V(q) := q, W(q) := 0, ``fill_wave_inputs``' values) before
    every pass, outside the timed window; one warm pass then ``passes``
    timed ones.  Every W(q) must equal ``expected_wave_result`` exactly.
    ``after_pass(what)`` runs after each pass's checks."""
    dev = path_device(ctx)
    on_card = dev.is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    V = TwoDimBlockCyclic(n, n, P * n, n, name="V")
    W = TwoDimBlockCyclic(n, n, P * n, n, name="W")
    inc = _Incarnations(ctx)
    want = {("P", "exec_async"): P, ("C", "exec_async"): P,
            ("GATE", "exec_end"): 1}

    def run_pass(what: str) -> float:
        for q in range(P):
            place(V, q, 0, dev, torch.full(
                (n, n), float(q), device=dev.tdev))
            place(W, q, 0, dev, torch.zeros((n, n), device=dev.tdev))
        sync()
        t0 = time.perf_counter()
        ctx.add_taskpool(wave.permute_wave_taskpool(V, W, device="cuda"))
        ctx.wait()
        sync()
        dt = time.perf_counter() - t0
        counts = inc.take()
        wrong = [q for q in range(P) if not bool(torch.all(
            newest_payload(W, q, 0) == wave.expected_wave_result(P, q)))]
        if counts != want or wrong:
            raise AssertionError(f"[{label}] {what}: incarnations {counts}"
                                 f" (expected {want}); W wrong at {wrong}")
        log(f"[{label}] {what}: {dt * 1e3:.2f} ms, every W(q) = 2 ((q - 1) "
            f"mod {P})")
        if after_pass is not None:
            after_pass(what)
        return dt

    log(f"[{label}] P={P} parties of ({n}, {n}) f32 "
        f"({n * n * 4 / 2**20:.0f} MiB a tile): {2 * P + 1} tasks a pass")
    reset_counts()
    inc.take()
    dev0 = device_counts(dev)
    times = [run_pass(f"pass {p} ({'timed' if p else 'warm'})")
             for p in range(passes + 1)][1:]
    launches = read_counts()
    device = report_device(label, dev, dev0)
    log(f"[{label}] best of {len(times)} timed passes "
        f"{min(times) * 1e3:.2f} ms; mean wave width "
        f"{device['mean_wave_width']:.2f}")
    return {"launches": launches, "times": times, "best_s": min(times),
            "cpu_tasks": passes + 1, "device": device}


def phase_wave(ctx: Context) -> dict:
    res = drive_wave(ctx, 8, 4096, passes=3, label="permute wave P=8")
    summary = path_summary(res, res["best_s"])
    summary["cpu_tasks"] = res["cpu_tasks"]
    return summary


def drive_checkpoint_grapher(ctx: Context, mb: int, t: int,
                             label: str) -> dict:
    """One GEMM pass (t x t x t tiles of mb^2, A and B bf16, C f32, tiles
    born on the device, ``seeded_tile``) with the DOT grapher installed,
    then C through ``checkpoint`` and ``restore`` into a fresh collection
    of the same layout.  Holds the DOT to t^3 task nodes and the pass's
    t^2 (t - 1) dependency edges (each C chain GEMM(m, n, k) ->
    GEMM(m, n, k + 1); A and B come from the collections), and the
    restored C to the checkpointed one bit for bit.  Returns numbers."""
    dev = ctx.device_registry.accelerators[0]
    sync = torch.cuda.synchronize if dev.is_cuda else (lambda: None)
    n = t * mb
    mats = {}
    for name, dtype in (("A", torch.bfloat16), ("B", torch.bfloat16),
                        ("C", torch.float32)):
        M = mats[name] = TwoDimBlockCyclic(mb, mb, n, n, dtype=dtype,
                                           name=name)
        for (m, k) in M.local_tiles():
            M.place_on_device(m, k, dev, seeded_tile(
                name, m, k, mb, t, dtype, dev.tdev))
    A, B, C = mats["A"], mats["B"], mats["C"]
    sync()
    # counts go to 0 just before the path runs and are read just after
    reset_counts()
    grapher = DotGrapher(ctx.rank)
    grapher.install(ctx)
    try:
        res = gemm_pass(ctx, "ptg", A, B, C)
        sync()
    finally:
        ctx.grapher = None
        ctx.pins_unregister("complete_exec", grapher._complete)
    launches = read_counts()
    tmp = tempfile.mkdtemp(prefix="parsec_ckpt_")
    try:
        dot = grapher.dump(os.path.join(tmp, "gemm.dot"))
        with open(dot) as fh:
            lines = fh.read().splitlines()
        nodes = sum(1 for ln in lines if "[label=" in ln and "->" not in ln)
        edges = sum(1 for ln in lines if "->" in ln)
        want_edges = t * t * (t - 1)
        log(f"[{label}] GEMM pass {res['s'] * 1e3:.1f} ms with the DOT "
            f"grapher; {os.path.getsize(dot)} B of DOT, {nodes} task nodes "
            f"(expected {t ** 3}), {edges} dependency edges (expected "
            f"{want_edges}); launches {launches}")
        if nodes != t ** 3 or edges != want_edges:
            raise AssertionError(f"[{label}] DOT holds {nodes} nodes and "
                                 f"{edges} edges")
        t0 = time.perf_counter()
        shard = checkpoint(ctx, [C], os.path.join(tmp, "C"))
        write_s = time.perf_counter() - t0
        nbytes = os.path.getsize(shard)
        fresh = TwoDimBlockCyclic(mb, mb, n, n, dtype=torch.float32,
                                  name="C")
        t0 = time.perf_counter()
        restored = restore(ctx, [fresh], os.path.join(tmp, "C"))
        read_s = time.perf_counter() - t0
        identical = restored == len(C.local_tiles()) and all(
            torch.equal(newest_payload(C, m, k).cpu(),
                        newest_payload(fresh, m, k).cpu())
            for (m, k) in C.local_tiles())
        log(f"[{label}] checkpoint of C ({len(C.local_tiles())} tiles of "
            f"{mb}^2 f32, device copies flushed home): {nbytes / 2**30:.3f}"
            f" GiB written in {write_s:.3f} s "
            f"({nbytes / write_s / 2**30:.2f} GiB/s), restored into a fresh "
            f"collection in {read_s:.3f} s "
            f"({nbytes / read_s / 2**30:.2f} GiB/s): {restored} tiles, "
            f"bit-identical {identical}")
        if not identical:
            raise AssertionError(f"[{label}] the restored C differs")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"launches": launches, "pass_ms": res["s"] * 1e3,
            "dot_nodes": nodes, "dot_edges": edges,
            "checkpoint_bytes": nbytes, "write_s": write_s,
            "read_s": read_s, "bit_identical": identical,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30
            if dev.is_cuda else 0.0}


def phase_checkpoint_grapher(ctx: Context) -> dict:
    return drive_checkpoint_grapher(ctx, 2048, 8,
                                    "checkpoint + grapher mb=2048")


def phase_gemm(ctx: Context, gen: torch.Generator) -> dict:
    res = drive_gemm(ctx, 12288, 3, 3, 4, passes=3, gen=gen,
                     label="GEMM path mb=12288")
    log(f"[GEMM path mb=12288] best pass {res['best_s'] * 1e3:.1f} ms, "
        f"{res['gflops']:.1f} GFLOP/s")
    return path_summary(res, res["best_s"])


def phase_dtd_gemm(ctx: Context, gen: torch.Generator) -> dict:
    """The bench geometry through DTD ``insert_task`` (36 inserts a
    pass, K1 the device body)."""
    label = "DTD GEMM mb=12288"
    res = drive_gemm(ctx, 12288, 3, 3, 4, passes=3, gen=gen, label=label,
                     fronts=("dtd",))
    r = res["fronts"]["dtd"]
    log(f"[{label}] best pass {r['best_s'] * 1e3:.1f} ms, "
        f"{r['gflops']:.1f} GFLOP/s; host CPU {r['host_us_per_task']:.1f} "
        f"us/task, inserted in {r['submit_us_per_task']:.1f} us/task "
        f"({r['submit_cpu_us_per_task']:.1f} us/task of the inserting "
        f"thread's CPU, mean of the timed passes; thread clock step "
        f"{clock_step_us():.1f} us); window stalls {r['window_stalls']}")
    summary = path_summary(res, r["best_s"])
    summary["fronts"] = res["fronts"]
    return summary


def phase_front_small(ctx: Context, gen: torch.Generator, front: str,
                      label: str, keep: dict = None) -> dict:
    """The mb=2048 GEMM (512 tasks a pass, seeded operands) through
    ``front`` in turns with the PTG API on the same operands: both
    best passes, host us per task and estimated idle shares, the mean
    wave widths, and C bit for bit against the PTG's."""
    mb, t = 2048, 8
    res = drive_gemm(ctx, mb, t, t, t, passes=3, gen=gen, label=label,
                     fronts=("ptg", front), seeded=True, keep=keep)
    k_ms = tile_kernel_ms(gen, mb)
    for f, r in res["fronts"].items():
        r["idle_share"] = idle_share(res["ntasks"], k_ms, r["best_s"])
    p, d = res["fronts"]["ptg"], res["fronts"][front]
    log(f"[{label}] {front} against ptg (in turns): best pass "
        f"{d['best_s'] * 1e3:.1f} ms against {p['best_s'] * 1e3:.1f} ms; "
        f"host CPU {d['host_us_per_task']:.1f} against "
        f"{p['host_us_per_task']:.1f} us/task (submitted in "
        f"{d['submit_us_per_task']:.1f} against "
        f"{p['submit_us_per_task']:.1f} us/task; the submitting thread's "
        f"CPU {d['submit_cpu_us_per_task']:.2f} against "
        f"{p['submit_cpu_us_per_task']:.2f} us/task, mean of the timed "
        f"passes, thread clock step {clock_step_us():.1f} us); estimated "
        f"idle share "
        f"{d['idle_share']:.3f} against {p['idle_share']:.3f} (kernel "
        f"{k_ms * 1e3:.1f} us/tile); mean wave width "
        f"{d['mean_wave_width']:.2f} against {p['mean_wave_width']:.2f}; "
        f"donated tasks {d['donated_tasks']} against {p['donated_tasks']}"
        + (f"; window stalls {d['window_stalls']}" if front == "dtd"
           else ""))
    summary = path_summary(res, d["best_s"])
    summary["fronts"] = res["fronts"]
    summary["idle_share"] = d["idle_share"]
    return summary


def bailouts() -> dict:
    """The C chain's cumulative bailouts by reason (tasks it handed back
    to Python)."""
    return dict(load_schedext().bailout_stats())


def bailout_delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in bailouts().items()
            if v != before.get(k, 0)}


def probe_pops(ctx: Context) -> int:
    """Tasks the context's native workers popped past ``run_quantum`` (the
    doorbell's probe, the comm spin poll): no bailout counts them."""
    return sum(es.probe_pops for es in ctx.streams)


def report_scheduler(label: str, ctx: Context, bail0: dict) -> dict:
    """The scheduler a path ran on, its native ready-queue counters, the
    C chain's bailouts by reason over the path and the probe pops beside
    them.  With ``sched_native`` on (the default) the path must have run
    on the native scheduler."""
    name = ctx.scheduler.name
    queue = ctx.scheduler.stats() if name == "native" else None
    bail = bailout_delta(bail0)
    probed = probe_pops(ctx)
    log(f"[{label}] scheduler {name} (sched_native "
        f"{params.get('sched_native')}): ready queue {queue}; C chain "
        f"bailouts by reason {bail}; probe pops {probed}")
    if int(params.get("sched_native")) and name != "native":
        raise AssertionError(f"[{label}] ran on {name}, not the native "
                             f"scheduler")
    return {"name": name, "queue": queue, "bailouts": bail,
            "probe_pops": probed}


def report_telemetry(label: str, ctx: Context, bail0: dict,
                     traced_sampled: int = 0, cpu_tasks: int = 0) -> dict:
    """The metrics registry's scrape after a path, held to what the path
    counted itself:

    - the native pushes, pops and bailouts (``_collect_sched``) equal the
      ready queue's own counters and the C chain's bailout delta (the
      scheduler line); at ``sched_native`` 0 the registry reports none;
    - liveattr's sampled completions S (its per-class done counts over
      the stride) equal sum over the completing streams of
      ceil(n_s / stride), the sampling rule of ``RuntimeMetrics._complete``;
      hence N / stride <= S <= N / stride + E for the path's N tasks over
      E streams (the workers plus the device module's completer stream);
    - the latency histogram's count is S less the completions sampled in
      a traced pass, whose ready stamps the causal tracer consumed;
    - the card's tasks plus the path's ``cpu_tasks`` (its tasks with a
      CPU body only) are the completions; on a path whose every task ran
      on the card, each task reached Python either as a C chain bailout
      or as a probe pop: bailouts plus probe pops equal the tasks,
      exactly;
    - the health score lies in [0, 1] and the ready stamp is on.
    Prints the straggler count and the journal's event count."""
    m = ctx.metrics
    if m is None or m.liveattr is None or m.health is None \
            or ctx.journal is None or not ctx._ready_stamp:
        raise AssertionError(f"[telemetry {label}] the default planes are "
                             f"not all armed: metrics {m}, journal "
                             f"{ctx.journal}, ready stamp "
                             f"{ctx._ready_stamp}")
    samples = [x for x in m.samples() if x["t"] != "section"]
    by = collections.defaultdict(list)
    for x in samples:
        by[x["n"]].append(x)

    def value(name):
        return by[name][0]["v"] if by.get(name) else None

    native = ctx.scheduler.name == "native"
    pushes = value("parsec_sched_native_pushes_total")
    pops = value("parsec_sched_native_pops_total")
    bail_now = {x["l"]["reason"]: x["v"] for x in
                by.get("parsec_sched_native_bailouts_total", [])}
    bail = {r: v - bail0.get(r, 0) for r, v in bail_now.items()
            if v != bail0.get(r, 0)}
    if native:
        queue = ctx.scheduler.stats()
        if (pushes, pops) != (queue["pushes"], queue["pops"]) \
                or bail != bailout_delta(bail0):
            raise AssertionError(
                f"[telemetry {label}] registry pushes {pushes}, pops "
                f"{pops}, bailouts {bail}; the scheduler line: {queue}, "
                f"{bailout_delta(bail0)}")
    elif pushes is not None or pops is not None or bail:
        raise AssertionError(f"[telemetry {label}] native counters "
                             f"reported off the native scheduler")
    stride = m._sample
    streams = completing_streams(ctx)
    n = sum(es.nb_tasks_done for es in streams)
    executed = sum(d.stats.executed_tasks
                   for d in ctx.device_registry.accelerators)
    rows = m.liveattr.section()["recs"]
    done = {r["cls"]: r["done"] for r in rows}
    sampled = sum(done.values()) // stride
    want = sampled_completions(ctx)
    hist = by["parsec_task_latency_seconds"][0]["cnt"]
    lo, hi = n / stride, n / stride + len(streams)
    strag = sum(x["v"] for x in by.get("parsec_stragglers_total", []))
    health = value("parsec_rank_health")
    events = len(ctx.journal)
    log(f"[telemetry {label}] native pushes {pushes}, pops {pops}, "
        f"bailouts {bail} (the scheduler line's) and {probe_pops(ctx)} "
        f"probe pops; {n} tasks completed "
        f"({executed} on the card) over {len(streams)} streams; liveattr "
        f"sampled {sampled} completions (sum of ceil(n_s/{stride}) over "
        f"the streams: {want}; bound [{lo:.2f}, {hi:.2f}]), per-class "
        f"done (x{stride}) {done}; latency histogram count {hist} "
        f"({sampled} less {traced_sampled} sampled in a traced pass); "
        f"stragglers {strag:g}; health score {health}; journal events "
        f"{events}; ready stamp {ctx._ready_stamp}")
    if sampled != want or not lo <= sampled <= hi:
        raise AssertionError(f"[telemetry {label}] liveattr sampled "
                             f"{sampled}, expected {want} in [{lo}, {hi}]")
    if executed and executed + cpu_tasks != n:
        raise AssertionError(f"[telemetry {label}] {executed} card tasks "
                             f"and {cpu_tasks} CPU tasks but {n} "
                             f"completions")
    probed = probe_pops(ctx)
    if native and executed and not cpu_tasks and \
            sum(bail.values()) + probed != n:
        raise AssertionError(f"[telemetry {label}] bailouts {bail} plus "
                             f"{probed} probe pops, but {n} card tasks")
    if hist != sampled - traced_sampled:
        raise AssertionError(f"[telemetry {label}] latency histogram "
                             f"count {hist}, expected "
                             f"{sampled - traced_sampled}")
    if health is None or not 0.0 <= health <= 1.0 or strag < 0:
        raise AssertionError(f"[telemetry {label}] health {health}, "
                             f"stragglers {strag}")
    return {"pushes": pushes, "pops": pops, "bailouts": bail,
            "probe_pops": probed, "tasks": n, "sampled": sampled, "latency_count": hist, "done": done,
            "stragglers": strag, "health": health, "journal_events": events}


def in_context(phase, label: str, sched_native=None,
               device: str = None) -> dict:
    """Run one path in a Context of its own (``sched_native``: the knob
    for this path only, else as configured; ``device``: the Context's
    layout, else the MCA default).  Once the Context has ended, what the
    path held (its tiles die in reference cycles) is freed before the next
    path starts, so that each path's peak memory is its own."""
    on_card = device is None or device.startswith("cuda")
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    if sched_native is not None:
        params.set("sched_native", sched_native)
    try:
        bail0 = bailouts()
        with Context(nb_cores=4, device=device) as ctx:
            summary = phase(ctx)
            summary["scheduler"] = report_scheduler(label, ctx, bail0)
            trace = summary.get("trace")
            summary["telemetry"] = report_telemetry(
                label, ctx, bail0,
                trace["sampled"] if trace is not None else 0,
                summary.get("cpu_tasks", 0))
    finally:
        if sched_native is not None:
            params.unset("sched_native")
    del ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return summary


def empty_pool(n: int):
    """``n`` independent empty tasks (the JAX package's ``tasks`` probe
    DAG, ``bench.py::_empty_pool``)."""
    p = PTG("empty", N=n)
    p.task("E", i=Range(0, n - 1)).flow("x", "CTL").body(lambda: None)
    return p.build()


def chain_pool(nc: int, nb: int):
    """``nc`` independent RW chains of length ``nb`` over 1x1 tiles (the
    JAX package's ``ntasks`` probe DAG, ``bench.py::_chain_pool``): every
    task binds real data and releases a local successor."""
    A = TwoDimBlockCyclic(1, 1, 1, nc, name="chains").from_array(
        torch.zeros(1, nc))

    def body(T):
        T += 1.0

    g = PTG("chains", NC=nc, NB=nb)
    g.task("S", c=Range(0, nc - 1), k=Range(0, nb - 1)) \
        .affinity(lambda c, k: A(0, c)) \
        .flow("T", "RW",
              IN(DATA(lambda c, k: A(0, c)), when=lambda c, k: k == 0),
              IN(TASK("S", "T", lambda c, k: dict(c=c, k=k - 1)),
                 when=lambda c, k: k > 0),
              OUT(TASK("S", "T", lambda c, k: dict(c=c, k=k + 1)),
                  when=lambda c, k, NB=nb: k < nb - 1)) \
        .body(body)
    return g.build(), A


def host_probe(kind: str, sched_native: int, n: int = 20000,
               nc: int = 500, nb: int = 24, cores: int = 4) -> dict:
    """One host probe (``tasks``: ``n`` empty tasks; ``ntasks``: ``nc``
    chains of ``nb``) at ``sched_native`` in a Context of ``cores``
    streams on the CPU-backed device module, after a warm tenth: tasks/s
    over add_taskpool + wait, and the C chain's bailouts by reason."""
    params.set("sched_native", sched_native)
    try:
        with Context(nb_cores=cores, device="cpu") as ctx:
            sched = ctx.scheduler.name
            if kind == "tasks":
                ctx.add_taskpool(empty_pool(max(1, n // 10)))
                ctx.wait()
                total, bail0 = n, bailouts()
                t0 = time.perf_counter()
                ctx.add_taskpool(empty_pool(n))
                ctx.wait()
            else:
                ctx.add_taskpool(chain_pool(max(1, nc // 10), nb)[0])
                ctx.wait()
                tp, A = chain_pool(nc, nb)
                total, bail0 = nc * nb, bailouts()
                t0 = time.perf_counter()
                ctx.add_taskpool(tp)
                ctx.wait()
            dt = time.perf_counter() - t0
            bail = bailout_delta(bail0)
    finally:
        params.unset("sched_native")
    if (sched == "native") != bool(sched_native):
        raise AssertionError(f"host {kind}: ran on {sched} at sched_native "
                             f"{sched_native}")
    if kind == "ntasks":
        # the number is only valid if every chain ran end to end
        got = A.to_array()
        if not bool((got == float(nb)).all()):
            raise AssertionError(f"host ntasks: chain results wrong (want "
                                 f"{nb}, got {got.flatten()[:4].tolist()})")
        if sched_native and bail:
            raise AssertionError(f"host ntasks: the C chain handed tasks "
                                 f"back to Python: {bail}")
    return {"sched": sched, "tasks": total, "seconds": dt,
            "tasks_per_s": total / dt, "bailouts": bail}


def overhead_probe(kind: str, n: int = 20000, pairs: int = 4,
                   cores: int = 4) -> dict:
    """The twin of the JAX package's ``_overhead_probe`` (bench.py):
    interleaved pairs of the ``tasks`` probe at ``sched_native`` 1, off
    then armed — ``telemetry``: ``metrics_enabled`` and
    ``liveattr_enable`` at 0 against 1; ``journal``: ``journal_enabled``;
    ``tracer``: the defaults, against the task profiler and the causal
    tracer installed before the run.  Reports the minimum pair ratio
    (off rate / armed rate - 1) and the minimum armed cost in us per
    task: host noise moves single pairs both ways, a real cost shows in
    every pair.  An armed run that raises, or a run whose task count is
    wrong, fails."""
    knobs = {"telemetry": ("metrics_enabled", "liveattr_enable"),
             "journal": ("journal_enabled",), "tracer": ()}[kind]

    def run(armed: int) -> float:
        params.set("sched_native", 1)
        for k in knobs:
            params.set(k, armed)
        try:
            with Context(nb_cores=cores, device="cpu") as ctx:
                planes = (ctx.metrics is not None, ctx.journal is not None)
                mods = []
                if kind == "tracer" and armed:
                    prof = Profile("tracer probe")
                    mods = [install_task_profiler(ctx, prof),
                            install_causal_tracer(ctx, prof)]
                ctx.add_taskpool(empty_pool(max(1, n // 10)))
                ctx.wait()
                t0 = time.perf_counter()
                ctx.add_taskpool(empty_pool(n))
                ctx.wait()
                dt = time.perf_counter() - t0
                for mod in mods:
                    mod.uninstall(ctx)
                done = sum(es.nb_tasks_done for es in ctx.streams)
                sched = ctx.scheduler.name
        finally:
            params.unset("sched_native")
            for k in knobs:
                params.unset(k)
        want_planes = {"telemetry": (bool(armed), True),
                       "journal": (True, bool(armed)),
                       "tracer": (True, True)}[kind]
        if done != n + max(1, n // 10) or sched != "native" \
                or planes != want_planes:
            raise AssertionError(
                f"overhead {kind} armed={armed}: {done} tasks on {sched}, "
                f"planes (metrics, journal) {planes}; expected "
                f"{n + max(1, n // 10)} on native, {want_planes}")
        return n / dt

    ratios, us, off_best, on_best = [], [], 0.0, 0.0
    for _ in range(pairs):
        off, on = run(0), run(1)
        off_best, on_best = max(off_best, off), max(on_best, on)
        ratios.append(max(0.0, off / on - 1.0))
        us.append(max(0.0, (1.0 / on - 1.0 / off) * 1e6))
    gate = OVERHEAD_GATES_US[kind]
    armed = {"telemetry": "metrics_enabled + liveattr_enable (the JAX "
                          "package's third knob, flightrec_enabled, is "
                          "not ported)",
             "journal": "journal_enabled",
             "tracer": "task profiler + causal tracer"}[kind]
    verdict = "within" if min(us) <= gate else "over"
    log(f"[host overhead {kind}] armed: {armed}; {pairs} interleaved pairs "
        f"of {n} tasks at sched_native 1: min pair ratio "
        f"{min(ratios):+.4f}, {min(us):.3f} us/task (pairs "
        f"{['%+.3f' % r for r in ratios]}; best off {off_best:.0f}, armed "
        f"{on_best:.0f} tasks/s); the JAX package's CPU gate <= {gate} "
        f"us/task: {verdict}")
    return {"ratio": min(ratios), "us_per_task": min(us),
            "pairs": ratios, "tasks_off": off_best, "tasks_on": on_best,
            "gate_us": gate, "verdict": verdict}


def host_cpu() -> str:
    """The host's CPU model and core counts, from ``/proc/cpuinfo``: its
    model name, or (where a virtualised kernel reports it as unknown) its
    vendor, family and model numbers."""
    import os
    import platform
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break                    # the first processor only
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    except OSError:
        pass
    model = info.get("model name", "unknown")
    if model == "unknown":
        model = (f"{info.get('vendor_id', 'unknown vendor')} family "
                 f"{info.get('cpu family', '?')} model "
                 f"{info.get('model', '?')}")
    return (f"{model} ({platform.machine()}), {os.cpu_count()} cores "
            f"({len(os.sched_getaffinity(0))} usable)")


def phase_host(smi: str, rounds: int = 3, **sizes) -> dict:
    """Both host probes at ``sched_native`` 1 and 0 in turns, ``rounds``
    times each; the best of each, with the CPU named beside the card."""
    cpu = host_cpu()
    log(f"[host] CPU: {cpu}; card: {smi}")
    best = {}
    for r in range(rounds):
        for kind in ("tasks", "ntasks"):
            for flag in (1, 0):
                res = host_probe(kind, flag, **sizes)
                log(f"[host {kind}] round {r} sched_native {flag} "
                    f"({res['sched']}): {res['tasks']} tasks in "
                    f"{res['seconds'] * 1e3:.1f} ms, "
                    f"{res['tasks_per_s']:.0f} tasks/s; C chain bailouts "
                    f"{res['bailouts']}")
                key = f"{kind} sched_native={flag}"
                if key not in best or \
                        res["tasks_per_s"] > best[key]["tasks_per_s"]:
                    best[key] = res
    for kind in ("tasks", "ntasks"):
        nat, lad = best[f"{kind} sched_native=1"], \
            best[f"{kind} sched_native=0"]
        log(f"[host {kind}] best of {rounds}: native "
            f"{nat['tasks_per_s']:.0f} tasks/s, ladder "
            f"{lad['tasks_per_s']:.0f} tasks/s, native / ladder "
            f"{nat['tasks_per_s'] / lad['tasks_per_s']:.2f} ({cpu}; card "
            f"{smi})")
    # the overhead probes are the tasks probe's twins, at its size
    overhead = {kind: overhead_probe(kind, n=sizes.get("n", 20000),
                                     cores=sizes.get("cores", 4))
                for kind in ("telemetry", "journal", "tracer")}
    return {"cpu": cpu, "best": best, "overhead": overhead}


# ---------------------------------------------------------------------------
# serving: the resident job service, its wire and the fabric
# ---------------------------------------------------------------------------

#: per-job result limits: a GEMM job's C against its plain product
#: (relative to the largest |entry|), the JAX package's potrf test
#: tolerance on max|LL' - A| / max|A|, and a stencil job's vector against
#: the float64 serial reference (max abs)
GEMM_JOB_TOL = 1e-3
POTRF_JOB_TOL = 1e-4
STENCIL_JOB_TOL = 1e-5

#: the served jobs at the card sizes: GEMM and potrf at n=8192, nb=2048
#: (64 GEMM tasks, f32: 1.10e12 flop a job), the stencil at the JAX
#: package's bench geometry (mb=2^20, 8 tiles, 64 steps; fused at 16)
SERVING_SIZES = {"gemm": (8192, 2048), "potrf": (8192, 2048),
                 "stencil": (1 << 23, 1 << 20, 64), "fuse": 16,
                 "fabric_gemm": (4096, 2048), "fabric_jobs": 48,
                 "fabric_nt": 8}


def _pcts(lats: list) -> tuple:
    """(p50, p99) as the JAX package's fabric bench takes them."""
    lats = sorted(lats)
    return lats[len(lats) // 2], lats[min(len(lats) - 1,
                                          int(len(lats) * 0.99))]


def serving_tasks(app: str, p: dict) -> int:
    """The tasks one served job enumerates: GEMM (n/nb)^3 steps plus the
    (n/nb)^2 beta-scaling tasks (the catalog's beta is 0), potrf its five
    classes, the stencil NT INIT tasks plus NT per (fused) sweep block."""
    if app == "gemm":
        t = p["n"] // p["nb"]
        return t ** 3 + t ** 2
    if app == "potrf":
        return sum(potrf_task_counts(p["n"] // p["nb"]).values())
    nt = p["n"] // p["nb"]
    return nt * (1 + -(-p["steps"] // p.get("fuse", 1)))


def check_job(app: str, res: dict, label: str) -> float:
    """Hold a served job's own check to its limit; returns the error."""
    err, tol = {"gemm": (res.get("rel_err"), GEMM_JOB_TOL),
                "potrf": (res.get("residual"), POTRF_JOB_TOL),
                "stencil": (res.get("max_err"), STENCIL_JOB_TOL)}[app]
    if err is None or not err <= tol:
        raise AssertionError(f"[{label}] {app} job result {res}: error "
                             f"{err} against {tol}")
    return err


def _chain_job(i: int, nt: int):
    """The JAX package's fabric bench job (``bench.py::run_fabric_bench``):
    an nt-deep chain of host tasks over its own 1x1-tile collection."""
    def factory():
        A = TwoDimBlockCyclic(mb=4, nb=4, lm=4, ln=4)
        A.data_of(0, 0).copy_on(0).payload[:] = 0.0
        p = PTG(f"fj{i}", NT=nt)
        p.task("S", k=Range(0, nt - 1)) \
            .affinity(lambda k, A=A: A(0, 0)) \
            .flow("T", "RW",
                  IN(DATA(lambda A=A: A(0, 0)), when=lambda k: k == 0),
                  IN(TASK("S", "T", lambda k: dict(k=k - 1)),
                     when=lambda k: k > 0),
                  OUT(TASK("S", "T", lambda k, NT=nt: dict(k=k + 1)),
                      when=lambda k, NT=nt: k < NT - 1),
                  OUT(DATA(lambda A=A: A(0, 0)),
                      when=lambda k, NT=nt: k == NT - 1)) \
            .body(lambda T: T + 1.0)
        return p.build()
    return factory


def _jobs_done(ctx) -> float:
    return sum(s["v"] for s in ctx.metrics.samples()
               if s["n"] == "parsec_jobs_done_total"
               and s["l"].get("status") == "done")


def serving_in_process(svc, sizes: dict, label: str) -> dict:
    """Four GEMM, two potrf and four stencil jobs (one fused) submitted
    together at mixed priorities to a warm JobService; every result held
    to its check, jobs/s and the admission -> completion percentiles,
    each app's job wall times and the per-job retired counts."""
    n, nb = sizes["gemm"]
    pn, pnb = sizes["potrf"]
    sn, snb, steps = sizes["stencil"]
    plan = [("gemm", {"n": n, "nb": nb, "seed": 11 + i}, prio)
            for i, prio in enumerate((0, 5, 1, 3))]
    plan += [("potrf", {"n": pn, "nb": pnb, "seed": 21 + i}, prio)
             for i, prio in enumerate((4, 2))]
    plan += [("stencil", {"n": sn, "nb": snb, "steps": steps,
                          "seed": 31 + i,
                          "fuse": sizes["fuse"] if i == 3 else 1}, prio)
             for i, prio in enumerate((1, 0, 2, 6))]
    done0 = _jobs_done(svc.context)
    t0 = time.perf_counter()
    jobs = [(app, p, svc.submit(APPS[app](dict(p, device="cuda")),
                                priority=prio, name=app, client=label))
            for app, p, prio in plan]
    results = [(app, p, job, job.result(timeout=600.0))
               for app, p, job in jobs]
    span = time.perf_counter() - t0
    lats = [job.finished_at - job.submitted_at for _a, _p, job in jobs]
    p50, p99 = _pcts(lats)
    walls = collections.defaultdict(list)
    errs = collections.defaultdict(list)
    counts = []
    for app, p, job, res in results:
        errs[app].append(check_job(app, res, label))
        walls[app].append(job.finished_at - job.started_at)
        retired = svc.gauges.job_task_counts(job.job_id)["tasks_retired"]
        counts.append((job.job_id, app, retired, serving_tasks(app, p)))
        if retired != serving_tasks(app, p):
            raise AssertionError(f"[{label}] job {job.job_id} ({app}) "
                                 f"retired {retired} tasks, its pool has "
                                 f"{serving_tasks(app, p)}")
    deadline = time.monotonic() + 10.0
    while _jobs_done(svc.context) - done0 < len(jobs) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    done = _jobs_done(svc.context) - done0
    if done != len(jobs):
        raise AssertionError(f"[{label}] parsec_jobs_done_total counted "
                             f"{done} of {len(jobs)} jobs")
    out = {"jobs": len(jobs), "seconds": span,
           "jobs_per_s": len(jobs) / span, "p50_s": p50, "p99_s": p99,
           "wall_s": {a: w for a, w in walls.items()},
           "max_err": {a: max(e) for a, e in errs.items()},
           "retired_vs_tasks": counts, "jobs_done_total": done}
    log(f"[{label}] {len(jobs)} jobs (4 GEMM n={n} nb={nb} f32, 2 potrf "
        f"n={pn} nb={pnb} f32, 4 stencil n={sn} nb={snb} steps={steps}, "
        f"one at fuse {sizes['fuse']}) in {span:.3f} s: "
        f"{out['jobs_per_s']:.3f} jobs/s, admission -> completion p50 "
        f"{p50:.3f} s p99 {p99:.3f} s")
    for app in walls:
        log(f"[{label}] {app} job wall s "
            f"{[round(w, 4) for w in walls[app]]}, worst error "
            f"{out['max_err'][app]:.3e}")
    log(f"[{label}] retired / tasks by job "
        f"{[(j, a, r, t) for j, a, r, t in counts]}; "
        f"parsec_jobs_done_total +{done:.0f}")
    return out


def serving_wire(svc, sizes: dict, label: str) -> dict:
    """One job of each app through ``request()`` on a JobServer over the
    same service: submit, status and the waiting result op; a bad-magic
    frame refused; the metrics scrape with the job families; the journal
    op with the jobs' lifecycle."""
    server = JobServer(svc, host="127.0.0.1", port=0)
    h, port = server.host, server.port
    try:
        n, nb = sizes["gemm"]
        pn, pnb = sizes["potrf"]
        sn, snb, steps = sizes["stencil"]
        reqs = [("gemm", {"n": n, "nb": nb, "seed": 41}),
                ("potrf", {"n": pn, "nb": pnb, "seed": 42}),
                ("stencil", {"n": sn, "nb": snb, "steps": steps,
                             "seed": 43})]
        subs = []
        for app, p in reqs:
            r = request(h, port, {"op": "submit", "app": app,
                                  "params": dict(p, device="cuda"),
                                  "client": label})
            if not r.get("ok"):
                raise AssertionError(f"[{label}] submit {app}: {r}")
            subs.append((app, r["job"]))
        errs = {}
        for app, jid in subs:
            res = request(h, port, {"op": "result", "job": jid,
                                    "timeout": 600.0})
            st = request(h, port, {"op": "status", "job": jid})
            if not (res.get("ok") and res["status"] == "DONE"
                    and st.get("ok") and st["info"]["status"] == "DONE"):
                raise AssertionError(f"[{label}] {app} job {jid}: result "
                                     f"{res}, status {st}")
            errs[app] = check_job(app, res["result"], label)
        with socket.create_connection((h, port), timeout=10.0) as s:
            s.sendall(b"BAD?" + b"\0" * 16)
            s.settimeout(10.0)
            try:
                refused = s.recv(64) == b""
            except ConnectionResetError:
                refused = True
        text = request(h, port, {"op": "metrics"})["text"]
        families = all(f in text for f in (
            'parsec_jobs_done_total{status="done"}',
            "parsec_job_duration_seconds_count", "parsec_job_tasks_total",
            "parsec_jobs_slo_breached_total"))
        jr = request(h, port, {"op": "journal"})
        kinds = collections.Counter(
            e["e"] for e in jr["ranks"]["0"]["events"]
            if e["e"].startswith("job_"))
        journal_ok = jr.get("ok") and all(
            kinds[k] >= len(subs) for k in ("job_admit", "job_start",
                                            "job_done"))
    finally:
        server.close()
    if not (refused and families and journal_ok):
        raise AssertionError(f"[{label}] bad magic refused {refused}, "
                             f"job families in the scrape {families}, "
                             f"journal {dict(kinds)}")
    log(f"[{label}] {len(subs)} jobs over the framed-JSON wire: errors "
        f"{ {a: f'{e:.3e}' for a, e in errs.items()} }; bad magic "
        f"refused; scrape carries the job families; journal job events "
        f"{dict(kinds)}")
    return {"jobs": len(subs), "max_err": errs,
            "journal_job_events": dict(kinds)}


def serving_fabric(device: str, sizes: dict, label: str) -> dict:
    """The JAX package's fabric bench (``bench.py::run_fabric_bench``:
    four warm chain jobs, then a stream of chain jobs, jobs/s and p50/p99
    admission -> completion), one GEMM job leasing ``devices=1`` beside
    two shared ones (which wait for the lease), a second submit of a
    profiled app that gets a quote, and the journal audited (F1-F3)."""
    nj, nt = sizes["fabric_jobs"], sizes["fabric_nt"]
    n, nb = sizes["fabric_gemm"]
    with ServingFabric(device=device, nb_cores=4, max_active=8,
                       max_pending=nj + 8) as fab:
        warm = [fab.submit(_chain_job(-1 - i, nt), app="fabwarm")
                for i in range(4)]
        for j in warm:
            if not j.wait(timeout=60.0):
                raise AssertionError(f"[{label}] {j} never finished")
        t0 = time.perf_counter()
        jobs = [fab.submit(_chain_job(i, nt), app="fabbench")
                for i in range(nj)]
        for j in jobs:
            if not j.wait(timeout=120.0) or j.status().name != "DONE":
                raise AssertionError(f"[{label}] {j} did not finish")
        dt = time.perf_counter() - t0
        p50, p99 = _pcts([j.finished_at - j.submitted_at for j in jobs])
        gp = {"n": n, "nb": nb, "device": "cuda"}
        excl = fab.submit(APPS["gemm"](dict(gp, seed=51)), devices=1,
                          app="gemm", name="gemm-lease")
        shared = [fab.submit(APPS["gemm"](dict(gp, seed=52 + i)),
                             app="gemm", name=f"gemm-shared{i}")
                  for i in range(2)]
        errs = [check_job("gemm", j.result(timeout=600.0), label)
                for j in [excl] + shared]
        lease = [e["devices"] for e in fab.context.journal.tail(4096)
                 if e.get("e") == "fabric_place"
                 and e.get("job") == excl.job_id]
        waited = all(j.started_at >= excl.finished_at for j in shared)
        again = fab.submit(APPS["gemm"](dict(gp, seed=55)), app="gemm",
                           name="gemm-quoted")
        errs.append(check_job("gemm", again.result(timeout=600.0), label))
        bundle = {0: [fab.context.journal.snapshot()]}
        stats = fab.stats()["fabric"]
    violations = journal_audit.audit(bundle)
    if lease != [fab.context.accelerator_spaces()[:1]] or not waited \
            or again.quote_eta is None or violations:
        raise AssertionError(
            f"[{label}] lease {lease}, shared jobs waited {waited}, quote "
            f"{again.quote_eta}, audit {violations[:3]}")
    out = {"jobs": nj, "nt": nt, "jobs_per_s": nj / dt, "p50_s": p50,
           "p99_s": p99, "gemm_max_err": max(errs),
           "quote_eta_s": again.quote_eta, "verdict": again.verdict,
           "measured_s": again.finished_at - again.started_at,
           "audit": "clean", "preemptions": stats["preemptions"]}
    log(f"[{label}] {nj} chain jobs nt={nt}: {out['jobs_per_s']:.1f} "
        f"jobs/s, admission -> completion p50 {p50 * 1e3:.2f} ms p99 "
        f"{p99 * 1e3:.2f} ms; GEMM n={n} leased {lease[0]}, the two shared "
        f"GEMM jobs started after its release; second gemm submit quoted "
        f"{again.quote_eta:.4f} s ({again.verdict}), ran "
        f"{out['measured_s']:.4f} s; journal audit F1-F3 clean")
    return out


def phase_serving(device: str = "cuda", sizes: dict = None,
                  clients: bool = False) -> dict:
    """The resident job service on the card, through the entry points a
    user calls: the in-process mix on a warm ``JobService``, one job of
    each app over the JobServer's wire (with ``clients``, one more GEMM
    job through the operator tools, ``serving_clients``), then the
    ServingFabric.  Every GEMM and potrf job launches K1 on its f32
    ``fma`` route; the K1 launches of the parts are this path's (counts
    set to 0 just before, read just after)."""
    sizes = dict(SERVING_SIZES, **(sizes or {}))
    label = "serving"
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with JobService(device=device, nb_cores=4, max_active=4) as svc:
        inproc = serving_in_process(svc, sizes, f"{label} in-process")
        wire = serving_wire(svc, sizes, f"{label} wire")
        tools = serving_clients(svc, device, sizes["gemm"],
                                f"{label} clients") if clients else None
    fabric = serving_fabric(device, sizes, f"{label} fabric")
    launches, routes = read_counts(), read_routes()
    fma = routes["fma"]
    log(f"[{label}] K1 launches {launches['gemm_tile']} by route {routes} "
        f"(fma {fma}), grouped {launches['gemm_tile_grouped']}")
    if device == "cuda" and fma <= 0:
        raise AssertionError(f"[{label}] no K1 launch took the fma route")
    gc.collect()
    return {"launches": launches, "routes": routes, "in_process": inproc,
            "wire": wire, "clients": tools, "fabric": fabric,
            "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                         if device == "cuda" else None)}


# ---------------------------------------------------------------------------
# the operator tools (parsec_tpu_torch/tools), each run as a user runs it:
# ``python -m parsec_tpu_torch.tools.<name>`` from the repository's root
# ---------------------------------------------------------------------------

REPO = os.path.dirname(os.path.abspath(__file__))

#: the chaos case on the card: a recovered potrf kill (K1 device bodies).
#: Each tool's process spends seconds importing torch on the card's host
#: (PERF.md §6), so the phase keeps one case of the catalog
CHAOS_CASES = ("kill-close-recover",)
CHAOS_LINE = re.compile(r"^\[(PASS|FAIL)\] seed=\d+ (\S+)\s+\[\S+\] "
                        r"expect=(\S+) got=(\S+) \(([\d.]+)s\)$", re.M)


def tool(name: str, *args, timeout: float = 600.0,
         stderr: bool = False) -> tuple:
    """``python -m parsec_tpu_torch.tools.<name> args`` in a process of
    its own: (stdout, seconds), with its standard error appended when
    ``stderr``.  A non-zero exit raises."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m",
                        f"parsec_tpu_torch.tools.{name}",
                        *[str(a) for a in args]], cwd=REPO,
                       capture_output=True, text=True, timeout=timeout)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"[tools] {name} {list(args)} exited "
                             f"{r.returncode}:\n{r.stdout[-3000:]}\n"
                             f"{r.stderr[-3000:]}")
    return (r.stdout + r.stderr if stderr else r.stdout), dt


def scraped_jobs_done(text: str) -> float:
    """``parsec_jobs_done_total{status="done"}`` in a scrape's text."""
    return sum(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
               if ln.startswith("parsec_jobs_done_total{")
               and 'status="done"' in ln)


def serving_clients(svc, device: str, size: tuple, label: str) -> dict:
    """One GEMM job of ``size`` (n, nb) through the operator tools on a
    JobServer over ``svc``: ``job_client submit --wait`` (the job's
    ``device`` left at its default, ``cuda``: K1 ``fma`` on the card,
    one launch a tile), its result held to its limit as the wire's are;
    ``metrics_client`` counts one more job done than the scrape before
    (taken through ``request``); ``metrics_client --status --job`` and
    ``live_view --once`` render it."""
    n, nb = size
    server = JobServer(svc, host="127.0.0.1", port=0)
    base = ("--host", server.host, "--port", server.port)
    secs = {}
    try:
        before = scraped_jobs_done(request(server.host, server.port,
                                           {"op": "metrics"})["text"])
        fma0 = read_routes()["fma"]
        out, secs["job_client"] = tool(
            "job_client", *base, "submit", "gemm", "--set", f"n={n}",
            "--set", f"nb={nb}", "--set", "seed=61", "--name",
            "tools-gemm", "--wait")
        fma = read_routes()["fma"] - fma0
        dec = json.JSONDecoder()
        sub, end = dec.raw_decode(out)
        res, _ = dec.raw_decode(out[end:].lstrip())
        if not (sub.get("ok") and res.get("ok")
                and res.get("status") == "DONE"):
            raise AssertionError(f"[{label}] job_client: {out[-2000:]}")
        err = check_job("gemm", res["result"], label)
        jid = sub["job"]
        text, secs["metrics_client"] = tool(
            "metrics_client", *base, "--grep", "parsec_jobs_done_total")
        done = scraped_jobs_done(text) - before
        status, secs["metrics_client --status"] = tool(
            "metrics_client", *base, "--status", "--job", jid)
        jobs = [j["job"] for j in json.loads(status)["jobs"]]
        view, secs["live_view"] = tool("live_view", *base, "--once")
    finally:
        server.close()
    row = [ln for ln in view.splitlines()
           if ln.split()[:2] == [str(jid), "tools-gemm"]]
    tiles = (n // nb) ** 3
    if done != 1 or jobs != [jid] or not row \
            or (device == "cuda" and fma != tiles):
        raise AssertionError(f"[{label}] jobs done +{done}, --status jobs "
                             f"{jobs}, live view row {row}, K1 fma launches "
                             f"{fma} (tiles {tiles}):\n{view}")
    log(f"[{label}] job_client submit gemm n={n} nb={nb} --wait: job "
        f"{jid} DONE, rel_err {err:.3e}, {fma} K1 fma launches; "
        f"metrics_client jobs done +{done:g}; --status and live_view "
        f"render job {jid}: {row[0].strip()}; seconds per tool "
        + ", ".join(f"{k} {v:.2f}" for k, v in secs.items()))
    return {"job": jid, "rel_err": err, "k1_fma": fma, "jobs_done": done,
            "seconds": secs}


def trace_info_counts(text: str) -> dict:
    """Class -> count of ``trace_info --stats``'s per-class table."""
    counts, on = {}, False
    for line in text.splitlines():
        if line.startswith("per-class interval stats"):
            on = True
            continue
        if on:
            f = line.split()
            if len(f) == 6 and f[1].isdigit():
                counts[f[0]] = int(f[1])
            elif len(f) > 1 and not line.startswith(" "):
                break
    return counts


def check_trace_tools(ptt: str, ntasks: int, label: str,
                      out_dir: str) -> dict:
    """``trace_info --stats --gaps`` and ``trace2chrome`` on one traced
    pass's trace: the per-class counts hold ``ntasks`` exec spans and
    ``ntasks`` dev: spans, and the Chrome file's X events are the
    trace's intervals (name, start and duration)."""
    size = os.path.getsize(ptt)
    text, info_s = tool("trace_info", ptt, "--stats", "--gaps")
    counts = trace_info_counts(text)
    exe = sum(n for c, n in counts.items()
              if c != "queue_wait" and not c.startswith("dev:"))
    dev = sum(n for c, n in counts.items() if c.startswith("dev:"))
    if exe != ntasks or dev != ntasks or "per-stream occupancy" not in text:
        raise AssertionError(f"[{label}] trace_info: {exe} exec and {dev} "
                             f"dev: spans for {ntasks} tasks ({counts})")
    js = os.path.join(out_dir, slug(label) + ".json")
    _out, chrome_s = tool("trace2chrome", ptt, "-o", js)
    with open(js) as f:
        events = json.load(f)["traceEvents"]
    _meta, rows = read_trace(ptt)
    ivs = intervals(rows)
    t0 = min(iv["ts_begin"] for iv in ivs)
    want = sorted((iv["name"], (iv["ts_begin"] - t0) * 1e6,
                   iv["duration"] * 1e6) for iv in ivs)
    got = sorted((e["name"], e["ts"], e["dur"]) for e in events)
    if got != want or any(e["ph"] != "X" or e["dur"] < 0 for e in events):
        raise AssertionError(f"[{label}] trace2chrome: {len(got)} events "
                             f"against {len(want)} intervals")
    log(f"[{label}] trace tools on the traced pass's trace "
        f"({size / 2**20:.2f} MiB, {len(rows)} events): trace_info "
        f"--stats --gaps {info_s:.2f} s ({exe} exec and {dev} dev: spans "
        f"for {ntasks} tasks); trace2chrome {chrome_s:.2f} s "
        f"({len(events)} X events = the trace's intervals, "
        f"{os.path.getsize(js) / 2**20:.2f} MiB of JSON)")
    return {"trace_mib": size / 2**20, "events": len(rows),
            "trace_info_s": info_s, "trace2chrome_s": chrome_s,
            "x_events": len(events), "exec_spans": exe, "dev_spans": dev}


def check_merge(paths: list, label: str, out_dir: str) -> dict:
    """``trace2chrome --merge`` over the 2-rank potrf's rank traces: one
    flow arrow per matched activation (both ends of every arrow), ranks
    0 and 1, and the merged trace's intervals as X events."""
    js = os.path.join(out_dir, slug(label) + "_merged.json")
    _out, merge_s = tool("trace2chrome", "--merge", *paths, "-o", js)
    with open(js) as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    starts = {e["id"] for e in ev if e["ph"] == "s"}
    ends = {e["id"] for e in ev if e["ph"] == "f"}
    rows, _metas = critpath.merge_traces(paths)
    tasks = sum(1 for e in ev if e["ph"] == "X" and e["cat"] == "task")
    other = doc["otherData"]
    if not starts or starts != ends or other["flow_arrows"] != len(starts) \
            or other["ranks"] != [0, 1] or tasks != len(intervals(rows)):
        raise AssertionError(f"[{label}] trace2chrome --merge: arrows "
                             f"{other['flow_arrows']}, {len(starts)} s and "
                             f"{len(ends)} f ends, ranks {other['ranks']}, "
                             f"{tasks} task events")
    log(f"[{label}] trace2chrome --merge of {len(paths)} rank traces "
        f"({sum(os.path.getsize(p) for p in paths) / 2**20:.2f} MiB): "
        f"{merge_s:.2f} s, {len(ev)} events, {len(starts)} flow arrows, "
        f"ranks {other['ranks']}")
    return {"trace2chrome_merge_s": merge_s, "events": len(ev),
            "flow_arrows": len(starts)}


def chaos_command(device: str, cases=CHAOS_CASES) -> list:
    """The chaos tool's arguments: each of ``cases`` once on ``device``
    (``--seeds`` rotates over the cases ``--only`` keeps)."""
    return ["--device", device, "--only", ",".join(cases), "--seeds",
            str(len(cases))]


def run_chaos(device: str, cases=CHAOS_CASES) -> dict:
    """The chaos tool over ``cases`` with two ranks on ``device`` (on the
    card both time-share it): exit 0, every case passed; returns each
    case's outcome and seconds."""
    out, dt = tool("chaos", *chaos_command(device, cases), timeout=900)
    got = {m[1]: {"status": m[0], "expect": m[2], "got": m[3],
                  "seconds": float(m[4])} for m in CHAOS_LINE.findall(out)}
    if set(got) != set(cases) or any(g["status"] != "PASS"
                                     for g in got.values()):
        raise AssertionError(f"[tools chaos] {got}\n{out[-3000:]}")
    for name, g in got.items():
        log(f"[tools chaos] {name}: expect {g['expect']}, got {g['got']} "
            f"in {g['seconds']:.1f} s")
    log(f"[tools chaos] {len(got)} cases on {device}, two ranks: "
        f"{dt:.1f} s")
    return {"cases": got, "seconds": dt}


LINT_STATUS = re.compile(r"^parseclint: (?:clean|(\d+) finding\(s\))"
                         r"(?:, (\d+) baselined)? \((\d+) files\)$", re.M)


def run_lint() -> dict:
    """The port's static analysis (``parseclint``) over the package, in a
    process of its own: a new finding exits non-zero, which fails the
    run.  Returns the files scanned, the new and baselined findings and
    the process's seconds."""
    out, dt = tool("parseclint", "parsec_tpu_torch", stderr=True,
                   timeout=300)
    m = LINT_STATUS.search(out)
    if m is None:
        raise AssertionError(f"[tools parseclint] no status line:\n"
                             f"{out[-3000:]}")
    got = {"files": int(m[3]), "new": int(m[1] or 0),
           "baselined": int(m[2] or 0), "seconds": dt}
    if got["new"]:
        raise AssertionError(f"[tools parseclint] {got}\n{out[-3000:]}")
    log(f"[tools parseclint] files {got['files']} new {got['new']} "
        f"baselined {got['baselined']} s {dt:.1f}")
    return got


def phase_tools(traces: dict, merge: list, clients: dict,
                device: str = "cuda") -> dict:
    """The operator tools on what the paths left: ``trace_info`` and
    ``trace2chrome`` on each traced pass's trace (``traces``: label ->
    (path, tasks)), ``trace2chrome --merge`` on the 2-rank potrf's rank
    traces, the port's lint over the package, then the chaos catalog's
    ``CHAOS_CASES``.  The client tools ran in the serving path
    (``clients``: their numbers).  Launches no kernel in this process
    (the chaos ranks' are their own)."""
    t0 = time.perf_counter()
    reset_counts()
    out_dir = tempfile.mkdtemp(prefix="parsec_tools_")
    try:
        out = {label: check_trace_tools(path, n, label, out_dir)
               for label, (path, n) in traces.items()}
        out["merge"] = check_merge(merge, "2-rank potrf", out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out["parseclint"] = run_lint()
    out["chaos"] = run_chaos(device)
    out["clients"] = clients
    out["launches"] = read_counts()
    out["seconds"] = time.perf_counter() - t0
    log(f"[tools] trace tools, lint and chaos {out['seconds']:.1f} s; the "
        f"clients' seconds: {clients['seconds'] if clients else None}")
    return out


# ---------------------------------------------------------------------------
# 2-rank paths: two ranks time-sharing this one card over the comm layer
# ---------------------------------------------------------------------------

DIST_RANKS = 2
POTRF_DIST_TOL = 1e-2    # relative Frobenius error of an L tile
QR_DIST_TOL = 2e-2       # |R| tile against the single-rank run, abs and rel
GEMM_DIST_TOL = 1e-3     # C tile against its plain-version product
COMM_KEYS = ("act_eager", "act_rdv", "eager_bytes", "rdv_bytes",
             "bytes_sent", "bytes_recv", "frames_sent", "frames_recv")


def _rank_passes(ctx, passes: int, build, regen=None, check=None,
                 insert=None) -> dict:
    """One rank's passes of one path: ``regen()`` (outside the timed
    window), a barrier so both ranks start together, then insert + wait
    (which includes the gang's quiescence) + synchronize, timed; a DTD
    pool (``insert`` given) is filled by ``insert(tp)`` once added and
    waited (its flush home included) before the context.  Per
    pass: the wall time, task counts by class (device and CPU
    incarnations), K1 tiles and their wgmma share, K2 launches and
    ``check(tp)`` (after the timed window).  The kernel counts go to 0
    before the first pass; the comm counters, staged-in bytes and device
    counters are read over all the passes."""
    dev = ctx.device_registry.accelerators[0]
    # the CPU rehearsal (tests/test_torch_chip_smoke.py) has no stream
    sync = torch.cuda.synchronize if dev.is_cuda else (lambda: None)
    ce = ctx.comm.ce
    inc = _Incarnations(ctx)
    reset_counts()
    inc.take()
    st0 = ctx.comm.stats()
    in0 = dev.stats.bytes_in
    dev0 = device_counts(dev)
    out = {"passes": []}
    for p in range(passes + 1):
        if regen is not None:
            regen()
        sync()
        ce.barrier(timeout=600)
        launches0 = read_counts()
        tiles0, wgmma0 = k1_tiles()
        t0 = time.perf_counter()
        tp = build()
        ctx.add_taskpool(tp)
        if insert is not None:
            insert(tp)
            tp.wait()
        ctx.wait()
        sync()
        dt = time.perf_counter() - t0
        counts = inc.take()
        classes = collections.Counter()
        for (c, _event), v in counts.items():
            classes[c] += v
        launched = {k: v - launches0[k] for k, v in read_counts().items()}
        out["passes"].append({
            "s": dt, "classes": dict(classes),
            "cpu_runs": sum(v for (_c, event), v in counts.items()
                            if event == "exec_end"),
            "k1": k1_tiles()[0] - tiles0, "wgmma": k1_tiles()[1] - wgmma0,
            "k2": launched["gram_tile"],
            "check": check(tp) if check is not None else None})
    st = ctx.comm.stats()
    out["comm"] = {k: st[k] - st0[k] for k in COMM_KEYS}
    out["transport"] = st["transport"]
    out["staged_in"] = dev.stats.bytes_in - in0
    out["launches"] = read_counts()
    out["device"] = {k: v - dev0[k] for k, v in device_counts(dev).items()}
    return out


def _potrf_rank(ctx, rank: int, nranks: int, mb: int, nt: int,
                passes: int, refs: dict, trace_dir=None) -> dict:
    """potrf over a P=2 row grid: the single-rank path's operand (the
    bench generator indexed over the whole matrix) regenerated before
    every pass; afterwards every local L tile against the single-rank
    run's (``refs``: that run's factor, on this card).  With
    ``trace_dir`` one more pass runs under the task profiler and the
    causal tracer, and its trace is written there."""
    dev = ctx.device_registry.accelerators[0]
    n = nt * mb
    A = TwoDimBlockCyclic(mb, mb, n, n, nodes=nranks, myrank=rank, P=nranks,
                          dtype=torch.bfloat16, name="A")
    orig = potrf_tile_maker(TwoDimBlockCyclic(mb, mb, n, n,
                                              dtype=torch.bfloat16),
                            dev.tdev)
    lower = [(m, k) for (m, k) in A.local_tiles() if m >= k]

    def regen():
        for (m, k) in lower:
            A.place_on_device(m, k, dev, orig(m, k))

    def build():
        return potrf.potrf_taskpool(A)

    out = _rank_passes(ctx, passes, build, regen,
                       check=lambda tp: tp.cholesky_check.failed())
    worst, identical = 0.0, True
    for (m, k) in lower:
        got = newest_payload(A, m, k).to(dev.tdev)
        ref = refs[(m, k)]
        if m == k:
            got, ref = torch.tril(got), torch.tril(ref)
        identical = identical and torch.equal(got, ref)
        g, r = got.double(), ref.double()
        worst = max(worst, float(torch.linalg.norm(g - r)
                                 / torch.linalg.norm(r)))
    out["tiles"] = {"count": len(lower), "worst_rel_fro": worst,
                    "bit_identical": bool(identical)}
    if trace_dir is not None:
        # the clock handshake runs on the comm loop; one accepted pong
        # round before the header snapshot
        deadline = time.time() + 15
        while len(ctx.comm.ce.clock) < nranks - 1 and \
                time.time() < deadline:
            time.sleep(0.05)
        regen()
        torch.cuda.synchronize()
        ctx.comm.ce.barrier(timeout=600)
        prof = Profile(f"potrf-2rank-r{rank}")
        mods = [install_task_profiler(ctx, prof),
                install_causal_tracer(ctx, prof)]
        t0 = time.perf_counter()
        try:
            ctx.add_taskpool(potrf.potrf_taskpool(A))
            ctx.wait()
            torch.cuda.synchronize()
        finally:
            for mod in mods:
                mod.uninstall(ctx)
        out["traced_s"] = time.perf_counter() - t0
        out["trace"] = prof.dump(os.path.join(trace_dir, f"rank{rank}.ptt"))
    return out


def _gemm_mats(rank: int, nranks: int, mb: int, t: int, dev) -> dict:
    """A, B (bf16) and C (f32) over a P=2 row grid, every local tile made
    on the device by its seeded maker; each collection's ``set_init`` is
    the same maker, so a survivor remakes an adopted tile bit for bit."""
    mats = {}
    for nm, dt in (("A", torch.bfloat16), ("B", torch.bfloat16),
                   ("C", torch.float32)):
        M = TwoDimBlockCyclic(mb, mb, t * mb, t * mb, nodes=nranks,
                              myrank=rank, P=nranks, dtype=dt, name=nm)

        def make(m, n, nm=nm, dt=dt):
            return seeded_tile(nm, m, n, mb, t, dt, dev.tdev)
        M.set_init(make)
        for (m, n) in M.local_tiles():
            M.place_on_device(m, n, dev, make(m, n))
        mats[nm] = M
    return mats


def _gemm_c_check(mats: dict, mb: int, t: int, dev, passes: int,
                  bits: bool = False) -> dict:
    """Every local C tile against C0 + passes * A@B by the plain version
    (relative error); with ``bits``, also against K1's own chain over k
    (the PTG path's order, in place): bit for bit.  The chain launches K1,
    so a caller reads its counts before this."""
    worst, identical = 0.0, True
    C = mats["C"]

    def tile(nm, m, n):
        return seeded_tile(nm, m, n, mb, t, mats[nm].dtype, dev.tdev)
    for (m, n) in C.local_tiles():
        prod = torch.zeros((mb, mb), device=dev.tdev)
        for k in range(t):
            prod = gemm_tile_reference(tile("A", m, k), tile("B", k, n),
                                       prod, 1.0)
        got = newest_payload(C, m, n).to(dev.tdev)
        if not torch.isfinite(got).all():
            raise AssertionError(f"C({m},{n}) is not finite")
        worst = max(worst, rel_err(got, tile("C", m, n) + passes * prod))
        if bits:
            ref = tile("C", m, n)
            for k in range(t):
                ref = gemm_tile(tile("A", m, k), tile("B", k, n), ref, 1.0)
            identical = identical and torch.equal(got, ref)
    return {"count": len(C.local_tiles()), "worst_rel": worst,
            "bit_identical": bool(identical) if bits else None}


def _gemm_rank(ctx, rank: int, nranks: int, mb: int, t: int,
               passes: int) -> dict:
    """GEMM over a P=2 row grid, C += A @ B per pass with A and B bf16
    and C f32: A stays local, B's panels cross (the RA/RB broadcast
    classes).  Every tile comes from a generator seeded by its index, so
    each rank rebuilds the plain-version product of its own C tiles."""
    dev = ctx.device_registry.accelerators[0]
    mats = _gemm_mats(rank, nranks, mb, t, dev)
    out = _rank_passes(ctx, passes, lambda: gemm_taskpool(*mats.values()))
    out["tiles"] = _gemm_c_check(mats, mb, t, dev, passes + 1)
    return out


def _dtd_gemm_rank(ctx, rank: int, nranks: int, mb: int, t: int,
                   passes: int, refs: dict) -> dict:
    """The GEMM through DTD over a P=2 row grid: every rank inserts every
    task, each runs where C(m, n) lives (AFFINITY), A stays local and the
    other rank's B tiles arrive as version-0 payloads over TAG_DTD (by
    rendezvous: a tile is far over the eager limit).  Afterwards (the
    flush home included) every local C tile must equal the single-rank
    DTD run's (``refs``, the same seeded operands and passes) bit for
    bit, and no DTD pull or backlogged frame may remain."""
    dev = ctx.device_registry.accelerators[0]
    mats = _gemm_mats(rank, nranks, mb, t, dev)
    stalls = []

    def insert(tp):
        gemm_dtd_insert(tp, *mats.values())
        stalls.append(tp.window_stalls)

    out = _rank_passes(ctx, passes, lambda: DTDTaskpool("gemm"),
                       insert=insert)
    C = mats["C"]
    identical = all(torch.equal(newest_payload(C, m, n).to(dev.tdev),
                                refs[(m, n)]) for (m, n) in C.local_tiles())
    out["tiles"] = {"count": len(C.local_tiles()),
                    "bit_identical": bool(identical)}
    out["dtd_lanes"] = {"refs_pending": ctx.comm.dtd_refs_pending,
                        "backlog": ctx.comm.debug_state()["dtd_backlog"]}
    out["window_stalls"] = sum(stalls)
    return out


def _qr_rank(ctx, rank: int, nranks: int, mb: int, nt: int, passes: int,
             refs: dict) -> dict:
    """Routed QR over a P=2 row grid (RSTORE/CSTORE carry R home) on the
    single-rank path's conditioned operand, regenerated before every
    pass; afterwards the local lower tiles must be zero and every local R
    tile match the single-rank run's in absolute value."""
    dev = ctx.device_registry.accelerators[0]
    n = nt * mb
    A = TwoDimBlockCyclic(mb, mb, n, n, nodes=nranks, myrank=rank, P=nranks,
                          dtype=torch.bfloat16, name="A")
    orig = qr_tile_maker(A, dev.tdev, SEED + 4, conditioned=True)

    def regen():
        for (m, k) in A.local_tiles():
            A.place_on_device(m, k, dev, orig(m, k))

    out = _rank_passes(ctx, passes, lambda: qr.qr_taskpool(A), regen)
    nonzero, worst, worst_diff = [], 0.0, 0.0
    for (m, k) in A.local_tiles():
        got = newest_payload(A, m, k).to(dev.tdev).float()
        if m > k:
            if bool(got.any()):
                nonzero.append((m, k))
            continue
        ref = refs[(m, k)].float()
        if m == k:
            got, ref = torch.triu(got), torch.triu(ref)
        # the allclose excess of |got| against |ref| (rtol = atol = tol)
        diff = (got.abs() - ref.abs()).abs()
        worst = max(worst, float((diff - QR_DIST_TOL * ref.abs()).max()))
        worst_diff = max(worst_diff, float(diff.max()))
    out["tiles"] = {"count": len(A.local_tiles()), "nonzero_lower": nonzero,
                    "worst_abs_excess": worst, "worst_abs_diff": worst_diff}
    return out


def _pingpong_rank(ctx, rank: int, nranks: int, rtt: tuple,
                   bw: tuple) -> dict:
    """The JAX package's pingpong probes (bench.py ``run_rtt_bench`` and
    ``run_bw_bench``) on host bodies: a datum bounced between the ranks
    through dataflow edges, ``rtt`` = (bytes, hops) for the round trip
    and ``bw`` = (bytes, hops) for the edge bandwidth, each after a warm
    run of 8 hops and a barrier.  The bandwidth leg pins its protocol as
    the bench does: eager up to twice its payload, adaptation off."""
    from parsec_tpu_torch.apps.pingpong import run_pingpong
    ce = ctx.comm.ce
    reset_counts()
    out = {}
    eager = ctx.comm.eager
    for leg, (nbytes, hops) in (("rtt", rtt), ("bw", bw)):
        pinned = leg == "bw"
        if pinned:
            ctx.comm.eager = 2 * nbytes
            params.set("comm_adaptive_eager", 0)
        try:
            run_pingpong(ctx, nbytes, 8)
            ce.barrier(timeout=600)
            st0 = ctx.comm.stats()
            per_hop, mbps = run_pingpong(ctx, nbytes, hops)
            st = ctx.comm.stats()
        finally:
            if pinned:
                ctx.comm.eager = eager
                params.unset("comm_adaptive_eager")
        out[leg] = {"bytes": nbytes, "hops": hops, "s_per_hop": per_hop,
                    "mb_per_s": mbps,
                    "comm": {k: st[k] - st0[k] for k in COMM_KEYS}}
        ce.barrier(timeout=600)
    out["transport"] = ctx.comm.stats()["transport"]
    out["launches"] = read_counts()
    return out


def dist_rank(ctx, rank: int, nranks: int, plan: dict, refs: dict) -> dict:
    """One rank of a 2-rank run: the paths ``plan`` names, in order."""
    dev = ctx.device_registry.accelerators[0]
    if not dev.is_cuda:
        raise RuntimeError(f"rank {rank}: not on the card ({dev.name})")
    out = {}
    for name, kw in plan.items():
        torch.cuda.reset_peak_memory_stats()
        if name == "potrf":
            out[name] = _potrf_rank(ctx, rank, nranks, refs=refs["potrf"],
                                    **kw)
        elif name == "gemm":
            out[name] = _gemm_rank(ctx, rank, nranks, **kw)
        elif name == "dtd_gemm":
            out[name] = _dtd_gemm_rank(ctx, rank, nranks,
                                       refs=refs["dtd_gemm"], **kw)
        elif name == "pingpong":
            out[name] = _pingpong_rank(ctx, rank, nranks, **kw)
        else:
            out[name] = _qr_rank(ctx, rank, nranks, refs=refs["qr"], **kw)
        out[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        gc.collect()
    return out


def _sum_passes(res: list, path: str) -> list:
    """Per pass, the ranks' counts summed and the slowest rank's time."""
    out = []
    for p in range(len(res[0][path]["passes"])):
        ps = [r[path]["passes"][p] for r in res]
        classes = collections.Counter()
        for q in ps:
            classes.update(q["classes"])
        out.append({"s": max(q["s"] for q in ps),
                    "classes": dict(classes),
                    "cpu_runs": sum(q["cpu_runs"] for q in ps),
                    "k1": sum(q["k1"] for q in ps),
                    "wgmma": sum(q["wgmma"] for q in ps),
                    "k2": sum(q["k2"] for q in ps),
                    "checks": [q["check"] for q in ps]})
    return out


def report_dist(label: str, res: list, path: str, flops: float,
                want: dict, want_k1: int, want_k2: int,
                cpu_classes=()) -> list:
    """Print one 2-rank path: per rank its passes, comm counters and
    staged-in bytes; then hold every pass's summed counts to ``want``."""
    for r, rr in enumerate(res):
        d = rr[path]
        times = [f"{q['s'] * 1e3:.1f}" for q in d["passes"]]
        rates = [f"{flops / q['s'] / 1e9:.1f}" for q in d["passes"]]
        c = d["comm"]
        log(f"[{label}] rank {r} ({d['transport']}): pass ms {times} "
            f"(GFLOP/s of the whole problem over this rank's pass "
            f"{rates}); activations eager {c['act_eager']} "
            f"({c['eager_bytes'] / 2**20:.1f} MiB) against rendezvous "
            f"{c['act_rdv']} ({c['rdv_bytes'] / 2**20:.1f} MiB); sent "
            f"{c['bytes_sent'] / 2**30:.3f} GiB in {c['frames_sent']} "
            f"frames, received {c['bytes_recv'] / 2**30:.3f} GiB in "
            f"{c['frames_recv']} frames; staged in from host "
            f"{d['staged_in'] / 2**30:.3f} GiB; device "
            f"faults {d['device']['faults']}; peak device memory "
            f"{d['peak_gib']:.2f} GiB; launches {d['launches']}")
        if d["device"]["faults"]:
            raise AssertionError(f"[{label}] rank {r}: "
                                 f"{d['device']['faults']} device faults")
    passes = _sum_passes(res, path)
    ntasks = sum(want.values())
    for p, q in enumerate(passes):
        if q["classes"] != want or q["k1"] != want_k1 or \
                q["wgmma"] != want_k1 or q["k2"] != want_k2 or \
                q["cpu_runs"] != sum(want.get(c, 0) for c in cpu_classes):
            raise AssertionError(
                f"[{label}] pass {p}: tasks {q['classes']}, K1 tiles "
                f"{q['k1']} ({q['wgmma']} wgmma), K2 {q['k2']}, CPU "
                f"incarnations {q['cpu_runs']}; expected {want} "
                f"({ntasks}), {want_k1} K1 all wgmma, {want_k2} K2")
    log(f"[{label}] every pass: {ntasks} tasks summed over the ranks "
        f"{want}, {want_k1} K1 tiles all on wgmma, {want_k2} K2 launches")
    return passes


def report_pingpong(res: list) -> dict:
    """Print the 2-rank pingpong legs: per rank the seconds per hop and
    MB/s (host bodies over the comm engine: host numbers, no device
    work) and its eager and rendezvous activations; every leg must have
    moved its payload (one activation a hop, summed over the ranks)."""
    out = {"launches": _rank_launches(res, "pingpong")}
    for leg in ("rtt", "bw"):
        for r, rr in enumerate(res):
            d = rr["pingpong"][leg]
            c = d["comm"]
            log(f"[2-rank pingpong {leg}] rank {r} "
                f"({rr['pingpong']['transport']}, host bodies: a host "
                f"number): {d['bytes']} B x {d['hops']} hops, "
                f"{d['s_per_hop'] * 1e6:.1f} us/hop, {d['mb_per_s']:.1f} "
                f"MB/s; activations eager {c['act_eager']} against "
                f"rendezvous {c['act_rdv']}")
        legs = [rr["pingpong"][leg] for rr in res]
        sent = sum(d["comm"]["act_eager"] + d["comm"]["act_rdv"]
                   for d in legs)
        if sent < legs[0]["hops"] - 1:
            raise AssertionError(f"[2-rank pingpong {leg}] {sent} "
                                 f"activations for {legs[0]['hops']} hops")
        out[leg] = {"us_per_hop": max(d["s_per_hop"] for d in legs) * 1e6,
                    "mb_per_s": min(d["mb_per_s"] for d in legs),
                    "bytes": legs[0]["bytes"], "hops": legs[0]["hops"]}
    if any(out["launches"].values()):
        raise AssertionError(f"[2-rank pingpong] kernels launched: "
                             f"{out['launches']}")
    return out


def _two_ranks(plan: dict, refs: dict, transport: str, trace_dir=None):
    """One run_distributed of ``plan`` on two ranks of this card over
    ``transport`` (the children's ``comm_transport``)."""
    if trace_dir is not None:
        plan = dict(plan)
        plan["potrf"] = dict(plan["potrf"], trace_dir=trace_dir)
    prior = os.environ.get("PARSEC_MCA_COMM_TRANSPORT")
    os.environ["PARSEC_MCA_COMM_TRANSPORT"] = transport
    try:
        gc.collect()
        torch.cuda.empty_cache()   # the ranks share this card's memory
        t0 = time.perf_counter()
        res = run_distributed(dist_rank, DIST_RANKS, args=(plan, refs),
                              device="cuda", timeout=900)
    finally:
        if prior is None:
            os.environ.pop("PARSEC_MCA_COMM_TRANSPORT", None)
        else:
            os.environ["PARSEC_MCA_COMM_TRANSPORT"] = prior
    log(f"[2-rank {transport}] run of {list(plan)}: "
        f"{time.perf_counter() - t0:.1f} s with spawn and set-up")
    return res


def phase_distributed(refs: dict, potrf_size=(6144, 16), gemm_size=(2048, 8),
                      qr_size=(6144, 8),
                      pingpong_size=((8, 400), (8 << 20, 32)),
                      trace_dir: str = None) -> dict:
    """The 2-rank potrf, GEMM and routed QR paths (comm_transport evloop,
    comm_frame_native 1: the defaults), then one potrf pass over the shm
    transport in turns with one over evloop; each size is (mb, tiles a
    side), the single-rank runs' that made ``refs``.  Both ranks run on
    this one card, each with its own CUDA context, time-sharing it; tiles
    cross card -> host -> wire -> host -> card.  These paths time the
    comm layer's host path and its staging copies, not multi-GPU
    scaling.  With ``trace_dir`` the potrf's traced pass leaves its two
    rank traces there (their paths under the potrf's ``traces``)."""
    (potrf_mb, potrf_nt), (gemm_mb, gemm_t), (qr_mb, qr_nt) = \
        potrf_size, gemm_size, qr_size
    label_p, label_g, label_q = (f"2-rank potrf mb={potrf_mb}",
                                 f"2-rank GEMM mb={gemm_mb}",
                                 f"2-rank QR mb={qr_mb}")
    log(f"[2-rank] {DIST_RANKS} ranks time-sharing one card, P={DIST_RANKS} "
        f"row grids, comm_transport "
        f"{params.get('comm_transport')}, comm_frame_native "
        f"{params.get('comm_frame_native')}; the parent holds the "
        f"single-rank runs' reference tiles on the card "
        f"({len(refs['potrf'])} potrf L tiles, {len(refs['qr'])} QR R "
        f"tiles, {len(refs['dtd_gemm'])} DTD GEMM C tiles), shared with "
        f"the ranks by CUDA IPC")
    # the potrf and QR passes cut to 2 and 1 timed ones (from 3 and 2) so
    # that the fault-tolerance path fits the script's time budget
    plan = {"potrf": {"mb": potrf_mb, "nt": potrf_nt, "passes": 2},
            "gemm": {"mb": gemm_mb, "t": gemm_t, "passes": 3},
            "dtd_gemm": {"mb": gemm_mb, "t": gemm_t, "passes": 3},
            "qr": {"mb": qr_mb, "nt": qr_nt, "passes": 1},
            "pingpong": dict(zip(("rtt", "bw"), pingpong_size))}
    own = trace_dir is None
    if own:
        trace_dir = tempfile.mkdtemp(prefix="parsec_2rank_trace_")
    try:
        res = _two_ranks(plan, refs, "evloop", trace_dir)
        att = critpath.attribution([r["potrf"]["trace"] for r in res])
    finally:
        if own:
            shutil.rmtree(trace_dir, ignore_errors=True)
    out = {}

    # potrf
    want = potrf_task_counts(potrf_nt)
    flops = potrf.potrf_flops(potrf_nt * potrf_mb)
    passes = report_dist(label_p, res, "potrf", flops, want,
                         want["SYRK"] + want["GEMM"], 0)
    failed = [q["checks"] for q in passes if any(q["checks"])]
    if failed:
        raise AssertionError(f"[{label_p}] a Cholesky flag is set: {failed}")
    med = statistics.median(q["s"] for q in passes[1:])
    tiles = [r["potrf"]["tiles"] for r in res]
    worst = max(t["worst_rel_fro"] for t in tiles)
    log(f"[{label_p}] Cholesky flag clear on both ranks in every pass; "
        f"median of {len(passes) - 1} timed passes (slowest rank) "
        f"{med * 1e3:.1f} ms, {flops / med / 1e9:.1f} GFLOP/s (n^3/3); "
        f"{sum(t['count'] for t in tiles)} lower tiles against the "
        f"single-rank run: worst relative Frobenius error {worst:.3e} "
        f"(limit {POTRF_DIST_TOL:.0e}), bit-identical "
        f"{all(t['bit_identical'] for t in tiles)}")
    if not worst <= POTRF_DIST_TOL:
        raise AssertionError(f"[{label_p}] L tile error {worst}")
    b = att["buckets"]
    log(f"[{label_p}] traced pass (slowest rank "
        f"{max(r['potrf']['traced_s'] for r in res) * 1e3:.1f} ms), merged "
        f"critical path of {len(att['path'])} tasks "
        f"({sum(1 for s in att['path'] if s['via'] == 'comm')} entered by a "
        f"remote edge): exec {b['exec'] * 1e3:.3f} ms, queue "
        f"{b['queue'] * 1e3:.3f} ms, comm {b['comm'] * 1e3:.3f} ms, idle "
        f"{b['idle'] * 1e3:.3f} ms against the makespan "
        f"{att['makespan'] * 1e3:.3f} ms (overlap "
        f"{att['overlap'] * 1e3:.3f} ms); flows {att['flows']}")
    if abs(sum(b.values()) - att["makespan"] - att["overlap"]) > \
            1e-5 * max(1, len(att["path"])):
        raise AssertionError(f"[{label_p}] buckets {b} do not sum to the "
                             f"makespan plus the overlap")
    out["potrf"] = {"pass_ms": med * 1e3, "pass_s": med,
                    "gflops": flops / med / 1e9,
                    "worst_rel_fro": worst, "critpath_ms": {
                        k: v * 1e3 for k, v in b.items()},
                    "launches": _rank_launches(res, "potrf"),
                    "traces": None if own else [r["potrf"]["trace"]
                                                for r in res]}

    # GEMM
    ntasks = gemm_t ** 3
    want = {"GEMM": ntasks, "RA": gemm_t * gemm_t, "RB": gemm_t * gemm_t}
    flops = total_flops(gemm_t * gemm_mb, gemm_t * gemm_mb, gemm_t * gemm_mb)
    passes = report_dist(label_g, res, "gemm", flops, want, ntasks, 0,
                         cpu_classes=("RA", "RB"))
    best = min(q["s"] for q in passes[1:])
    worst = max(r["gemm"]["tiles"]["worst_rel"] for r in res)
    log(f"[{label_g}] best of {len(passes) - 1} timed passes (slowest "
        f"rank) {best * 1e3:.1f} ms, {flops / best / 1e9:.1f} GFLOP/s; C "
        f"against the plain-version product: rel err {worst:.3e} (limit "
        f"{GEMM_DIST_TOL:.0e})")
    if not worst <= GEMM_DIST_TOL:
        raise AssertionError(f"[{label_g}] C disagrees: {worst}")
    out["gemm"] = {"pass_ms": best * 1e3, "gflops": flops / best / 1e9,
                   "worst_rel": worst,
                   "launches": _rank_launches(res, "gemm")}

    # the same GEMM through DTD: the other rank's B tiles cross as
    # version-0 payloads, pulled once per pass by a _dtd_recv task each
    label_d = f"2-rank DTD GEMM mb={gemm_mb}"
    pulled = DIST_RANKS * gemm_t * gemm_t // 2
    want = {"GEMM": ntasks, "_dtd_recv": pulled}
    passes = report_dist(label_d, res, "dtd_gemm", flops, want, ntasks, 0,
                         cpu_classes=("_dtd_recv",))
    best = min(q["s"] for q in passes[1:])
    tiles = [r["dtd_gemm"]["tiles"] for r in res]
    lanes = [r["dtd_gemm"]["dtd_lanes"] for r in res]
    sent = sum(r["dtd_gemm"]["comm"]["bytes_sent"] for r in res)
    log(f"[{label_d}] best of {len(passes) - 1} timed passes (slowest "
        f"rank) {best * 1e3:.1f} ms, {flops / best / 1e9:.1f} GFLOP/s; "
        f"{pulled} B tiles pulled a pass over the ranks, "
        f"{sent / (len(passes) * 2**30):.3f} GiB sent a pass; C against "
        f"the single-rank DTD run: bit-identical "
        f"{all(t['bit_identical'] for t in tiles)} "
        f"({sum(t['count'] for t in tiles)} tiles); DTD lanes at the end "
        f"{lanes}; window stalls "
        f"{[r['dtd_gemm']['window_stalls'] for r in res]}")
    if not all(t["bit_identical"] for t in tiles) or \
            any(ln["refs_pending"] or ln["backlog"] for ln in lanes):
        raise AssertionError(f"[{label_d}] C differs from the single-rank "
                             f"run's ({tiles}) or DTD lanes left {lanes}")
    out["dtd_gemm"] = {"pass_ms": best * 1e3, "gflops": flops / best / 1e9,
                       "bytes_per_pass": sent / len(passes),
                       "launches": _rank_launches(res, "dtd_gemm")}

    # QR
    want = qr_task_counts(qr_nt)
    want["RSTORE"] = qr_nt - 1
    want["CSTORE"] = (qr_nt - 1) * qr_nt // 2
    ib = qr.effective_ib(qr_mb)
    want_k1 = want["UNMQR"] + 3 * want["TSMQR"]
    want_k2 = 2 * (qr_mb // ib if ib else 1) * want["GEQRT"]
    flops = qr.geqrf_flops(qr_nt * qr_mb, qr_nt * qr_mb)
    passes = report_dist(label_q, res, "qr", flops, want, want_k1, want_k2)
    best = min(q["s"] for q in passes[1:])
    tiles = [r["qr"]["tiles"] for r in res]
    nonzero = [t for tt in tiles for t in tt["nonzero_lower"]]
    worst = max(t["worst_abs_excess"] for t in tiles)
    log(f"[{label_q}] best of {len(passes) - 1} timed passes (slowest "
        f"rank) {best * 1e3:.1f} ms, {flops / best / 1e9:.1f} GFLOP/s; "
        f"lower tiles zero: {not nonzero}; |R| against the single-rank "
        f"run: largest | |R| - |R_1| | "
        f"{max(t['worst_abs_diff'] for t in tiles):.3e}, worst excess over "
        f"{QR_DIST_TOL:.0e} + {QR_DIST_TOL:.0e}|R_1| {worst:.3e} (must be "
        f"<= 0)")
    if nonzero or worst > 0:
        raise AssertionError(f"[{label_q}] lower tiles {nonzero}, R "
                             f"excess {worst}")
    out["qr"] = {"pass_ms": best * 1e3, "gflops": flops / best / 1e9,
                 "launches": _rank_launches(res, "qr")}

    # pingpong: host bodies, host numbers
    out["pingpong"] = report_pingpong(res)

    # one potrf pass over shm, in turns with one over evloop
    shm_dir = "/dev/shm" if os.path.isdir("/dev/shm") else \
        tempfile.gettempdir()
    du = shutil.disk_usage(shm_dir)
    log(f"[2-rank shm] ring directory {shm_dir}: {du.total / 2**20:.0f} "
        f"MiB, {du.free / 2**20:.0f} MiB free; comm_shm_ring_mb "
        f"{params.get('comm_shm_ring_mb')} per directed pair")
    # one pass a turn, in a fresh pair of processes each: the turns' warm
    # pass is cut so that the rejoin and DTD-recovery legs fit the
    # script's time budget
    one = {"potrf": dict(plan["potrf"], passes=0)}
    turns = {}
    for transport in ("shm", "evloop"):
        rr = _two_ranks(one, refs, transport)
        label = f"{label_p} {transport} turn"
        want = potrf_task_counts(potrf_nt)
        ps = report_dist(label, rr, "potrf", potrf.potrf_flops(
            potrf_nt * potrf_mb), want, want["SYRK"] + want["GEMM"], 0)
        if any(any(q["checks"]) for q in ps):
            raise AssertionError(f"[{label}] a Cholesky flag is set")
        worst = max(r["potrf"]["tiles"]["worst_rel_fro"] for r in rr)
        if not worst <= POTRF_DIST_TOL:
            raise AssertionError(f"[{label}] L tile error {worst}")
        if any(r["potrf"]["transport"] != transport for r in rr):
            raise AssertionError(f"[{label}] ran on "
                                 f"{[r['potrf']['transport'] for r in rr]}")
        turns[transport] = ps[-1]["s"] * 1e3
    log(f"[2-rank potrf] pass shm {turns['shm']:.1f} ms against evloop "
        f"{turns['evloop']:.1f} ms (in turns, one cold pass each in fresh "
        f"processes, slowest rank)")
    out["potrf"]["turns_ms"] = turns
    return out


def _rank_launches(res: list, path: str) -> dict:
    """A path's kernel launches, summed over the ranks."""
    out = collections.Counter()
    for r in res:
        out.update(r[path]["launches"])
    return dict(out)


RECOVERY_SETUP_S = 12.0   # engine start -> the pool's start (both ranks;
                          # set-up, the attach snapshot's 9 GiB of host
                          # copies included, took 6.1-8.0 s on the H100)
RECOVERY_KILL_AT = 0.45   # the death: a share of the victim's pool tasks
TAG_RECOVERY_GO = 20      # an application tag: the ranks' start exchange


def kill_on_progress(ctx, tp, kill_after: int) -> None:
    """Kill this rank (``fault_kill``: the close of the ``kill_rank``
    directive) from a thread of its own once it has completed
    ``kill_after`` tasks of ``tp``: the death lands at that point of the
    pool's progress however long the pass takes under load."""
    done = itertools.count(1)
    ce = ctx.comm.ce

    def on_complete(es, event, task):
        if task.taskpool is tp and next(done) == kill_after:
            threading.Thread(target=ce.fault_kill, args=("close",),
                             daemon=True).start()
    ctx.pins_register("complete_exec", on_complete)


def recovery_rank(ctx, rank: int, nranks: int, mb: int, nt: int,
                  setup_s: float, refs: dict, kill_after: int) -> dict:
    """One rank of the fault-tolerance path: the bench operand made on the
    device (its lower local tiles; ``A.set_init`` with the same maker for
    the tiles a survivor adopts), the pool attached (the recovery snapshot
    of the local tiles, timed), then both ranks start the pool at
    ``setup_s`` after rank 1's engine came up (CLOCK_MONOTONIC is the
    host's, so the two processes share it) and wait.  Rank 1 kills itself
    once it has completed ``kill_after`` of its tasks in the pool
    (``kill_on_progress``) and raises; rank 0 returns its recovery
    numbers, its L tiles against ``refs`` (the single-rank factor) and the
    backward error of the whole factor it now holds."""
    dev = ctx.device_registry.accelerators[0]
    sync = torch.cuda.synchronize if dev.is_cuda else (lambda: None)
    ce = ctx.comm.ce
    n = nt * mb
    A = TwoDimBlockCyclic(mb, mb, n, n, nodes=nranks, myrank=rank, P=nranks,
                          dtype=torch.bfloat16, name="A")
    make = potrf.bench_operand(n, mb, torch.bfloat16, dev.tdev)
    A.set_init(make)
    for (m, k) in A.local_tiles():
        if m >= k:
            A.place_on_device(m, k, dev, make(m, k))
    sync()
    if dev.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    tp = potrf.potrf_taskpool(A)
    t0 = time.perf_counter()
    ctx.add_taskpool(tp)         # takes the recovery snapshot
    snap_s = time.perf_counter() - t0
    snaps = ctx.recovery._snaps.get(id(A), {})
    snap_bytes = sum(p.numel() * p.element_size()
                     for _v, p in snaps.values())
    # the pool starts at setup_s past rank 1's engine start, on both ranks
    got, evt = {}, threading.Event()

    def on_go(src, payload):
        got[src] = payload
        evt.set()
    ce.tag_register(TAG_RECOVERY_GO, on_go)
    ce.send_am(TAG_RECOVERY_GO, 1 - rank, ce.started_at)
    if not evt.wait(120):
        raise TimeoutError(f"rank {rank}: no start stamp from the peer")
    ce.tag_unregister(TAG_RECOVERY_GO)
    go = (ce.started_at if rank == 1 else got[1]) + setup_s
    setup_done = time.monotonic() - (ce.started_at if rank == 1 else got[1])
    ahead = go - time.monotonic()
    if ahead > 0:
        time.sleep(ahead)
    else:
        # a late start moves the death earlier into the pass; the parent
        # fails the path unless it still lands inside the run
        log(f"[recovery rank {rank}] set-up took {setup_done:.2f} s, past "
            f"the pool's start at {setup_s} s: starting now")
    if 1 - rank in ce.dead_peers:
        raise AssertionError(f"rank {rank}: the kill landed before the "
                             f"pool started")
    if rank == 1:
        kill_on_progress(ctx, tp, kill_after)
    t_start = time.perf_counter()
    ctx.wait()
    sync()
    t_done = time.perf_counter()
    rec = ctx.recovery
    st = rec.stats()
    deaths = [ev["t"] for ev in ctx.journal.tail(4096)
              if ev.get("e") == "recovery_start"]
    lower = [(m, k) for (m, k) in A.local_tiles() if m >= k]
    # the factor's tiles whose newest copy is on the host (restored ones
    # a minimal replay left as they were) go to the card once, so that
    # the checks below read every tile there
    on_host = 0
    for (m, k) in lower:
        c = A.data_of(m, k).newest_copy()
        if c is not None and c.device == 0:
            on_host += 1
            A.place_on_device(m, k, dev, newest_payload(A, m, k).to(
                dev.tdev))
    worst = 0.0
    for (m, k) in lower:
        got_t = newest_payload(A, m, k).to(dev.tdev)
        ref = refs[(m, k)].to(dev.tdev)
        if m == k:
            got_t, ref = torch.tril(got_t), torch.tril(ref)
        g, r = got_t.double(), ref.double()
        worst = max(worst, float(torch.linalg.norm(g - r)
                                 / torch.linalg.norm(r)))
    bwd = backward_error(A, make)
    return {"stats": st, "snapshot_s": snap_s, "snapshot_bytes": snap_bytes,
            "setup_s": setup_done, "run_s": t_done - t_start,
            "death_s": (deaths[0] - t_start) if deaths else None,
            "lower_tiles": len(lower), "host_tiles": on_host,
            "worst_rel_fro": worst,
            "backward_error": bwd, "failed": tp.cholesky_check.failed(),
            "k1": k1_tiles()[0], "launches": read_counts(),
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30
            if dev.is_cuda else 0.0}


def phase_recovery(refs: dict, nofault_s: float, size=(6144, 16),
                   setup_s: float = RECOVERY_SETUP_S,
                   kill_at: float = RECOVERY_KILL_AT, extra_plan: str = "",
                   device: str = "cuda") -> dict:
    """The fault-tolerance path (the module docstring): two ranks, rank 1
    killed once it has completed ``kill_at`` of its share of the pool's
    tasks, rank 0 recovering it; ``nofault_s`` (the 2-rank pass measured
    before) is what the survivor's time is read against.  ``extra_plan``
    adds fault directives (a small rehearsal stretches its pass with
    frame delays).  Fails unless rank 1 died, rank 0 completed with one
    recovery started and none failed, the factor checks hold and the
    flight recorder's bundle holds rank 0's ring with a recovery-start
    incident that ``merge_traces`` opens."""
    mb, nt = size
    label = f"fault tolerance: 2-rank potrf mb={mb}, rank 1 killed"
    # the P=2 row grid gives rank 1 about half of the pool's tasks
    share = sum(potrf_task_counts(nt).values()) // DIST_RANKS
    kill_after = max(1, round(kill_at * share))
    spec = "seed=13" + (f";{extra_plan}" if extra_plan else "")
    bundle = tempfile.mkdtemp(prefix="parsec_flightrec_")
    env = {"PARSEC_MCA_FAULT_PLAN": spec,
           "PARSEC_MCA_RECOVERY_ENABLE": "1",
           "PARSEC_MCA_FLIGHTREC_ENABLED": "1",
           "PARSEC_MCA_FLIGHTREC_DIR": bundle,
           "PARSEC_MCA_COMM_TRANSPORT": "evloop"}
    log(f"[{label}] fault plan {spec!r}; the pool starts {setup_s:.1f} s "
        f"after rank 1's engine came up, and rank 1 dies after completing "
        f"{kill_after} of its ~{share} tasks in it ({kill_at:.2f} of its "
        f"share; the no-fault pass took {nofault_s * 1e3:.1f} ms); "
        f"recovery and the flight recorder armed (bundle {bundle})")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = run_distributed(recovery_rank, DIST_RANKS,
                              args=(mb, nt, setup_s, refs, kill_after),
                              device=device,
                              timeout=900, tolerate_ranks=(1,))
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        if res[1] is not None or res[0] is None:
            raise AssertionError(f"[{label}] rank 1 must die and rank 0 "
                                 f"complete: {res}")
        r = res[0]
        st = r["stats"]
        if st["started"] != 1 or st["failed"] != 0 or st["completed"] != 1:
            raise AssertionError(f"[{label}] recoveries {st}")
        death = r["death_s"]
        log(f"[{label}] {wall:.1f} s with spawn and set-up; rank 0 set-up "
            f"{r['setup_s']:.2f} s; snapshot at attach "
            f"{r['snapshot_bytes'] / 2**30:.3f} GiB of host copies in "
            f"{r['snapshot_s']:.3f} s; rank 1 declared dead "
            f"{death * 1e3:.1f} ms into the pool "
            f"({death / nofault_s:.3f} of the no-fault pass)")
        log(f"[{label}] rank 0 from the pool's start to completion "
            f"{r['run_s'] * 1e3:.1f} ms, {r['run_s'] / nofault_s:.3f} x the "
            f"no-fault 2-rank pass; recoveries {st['started']} started, "
            f"{st['completed']} completed, {st['failed']} failed; minimal "
            f"replays {st['minimal_replays']}, full replays "
            f"{st['full_replays']}; tasks re-executed "
            f"{st['tasks_reexecuted']}; restored tiles by source "
            f"{st['restored_tiles']}; dead map {st['dead_map']}; K1 tiles "
            f"on the survivor {r['k1']}, launches {r['launches']}; peak "
            f"device memory {r['peak_gib']:.2f} GiB")
        log(f"[{label}] {r['lower_tiles']} lower L tiles on the survivor "
            f"({r['host_tiles']} of them newest on the host, moved to the "
            f"card for the checks) against the single-rank factor: worst "
            f"relative Frobenius "
            f"error {r['worst_rel_fro']:.3e} (limit {POTRF_DIST_TOL:.0e}); "
            f"backward error {r['backward_error']:.4e} (limit "
            f"{POTRF_BWD_TOL:.0e}); Cholesky flag set {r['failed']}")
        if r["lower_tiles"] != nt * (nt + 1) // 2 or \
                not r["worst_rel_fro"] <= POTRF_DIST_TOL or \
                not r["backward_error"] <= POTRF_BWD_TOL or r["failed"]:
            raise AssertionError(f"[{label}] the recovered factor fails its "
                                 f"checks")
        if death is None or not 0.0 < death < r["run_s"]:
            raise AssertionError(f"[{label}] the death ({death}) is not "
                                 f"inside the run ({r['run_s']})")
        # the survivor's ring is dumped on its own thread
        deadline = time.time() + 30
        while not os.path.exists(os.path.join(bundle, "rank0.ptt")) and \
                time.time() < deadline:
            time.sleep(0.1)
        summary = summarize_bundle(bundle)
        rows, _metas = critpath.merge_traces(summary["traces"])
        log(f"[{label}] flight-recorder bundle: ranks {summary['ranks']}, "
            f"{summary['events']} events ({len(rows)} rows through "
            f"critpath.merge_traces), flows {summary['flows']}; incidents "
            f"{[(i['rank'], i['reason']) for i in summary['incidents']]}")
        if 0 not in summary["ranks"] or not any(
                i["rank"] == 0 and i["reason"].startswith("recovery-start")
                for i in summary["incidents"]):
            raise AssertionError(f"[{label}] the bundle lacks rank 0's ring "
                                 f"or its recovery-start incident")
    finally:
        shutil.rmtree(bundle, ignore_errors=True)
    return {"launches": r["launches"], "run_ms": r["run_s"] * 1e3,
            "ratio_to_nofault": r["run_s"] / nofault_s,
            "death_share": death / nofault_s,
            "recovery": {k: st[k] for k in ("started", "completed",
                                            "failed", "minimal_replays",
                                            "full_replays",
                                            "tasks_reexecuted",
                                            "restored_tiles")},
            "snapshot_bytes": r["snapshot_bytes"],
            "snapshot_s": r["snapshot_s"],
            "worst_rel_fro": r["worst_rel_fro"],
            "backward_error": r["backward_error"],
            "peak_gib": r["peak_gib"],
            "bundle_events": summary["events"]}


#: the rejoin and DTD-recovery legs (one spawn of two ranks over shm)
FT_SETUP_S = 5.0          # rank 1's restarted engine -> the DTD pool's
                          # start (both ranks): the rejoin, pass B, its
                          # check, the DTD operands and the attach
                          # snapshot (1.76 s on the H100)
FT_REJOIN_TIMEOUT_S = 30.0
TAG_FT_GO = 21            # an application tag: rank 1's start stamp


def _ft_pass(ctx, sync, tp) -> float:
    """One pass of ``tp`` after a barrier, timed to its completion."""
    ctx.comm.ce.barrier(timeout=600)
    t0 = time.perf_counter()
    ctx.add_taskpool(tp)
    ctx.wait()
    sync()
    return time.perf_counter() - t0


def rejoin_rank(ctx, rank: int, nranks: int, mb: int, t: int,
                kill_plan: str = "") -> dict:
    """One rank of the rejoin leg: a PTG GEMM pass A; rank 1's engine goes
    down (``rde.fini()``) and comes back as incarnation 1 (``comm_epoch``
    1, with ``kill_plan`` armed when given) through
    ``ctx.recovery.rejoin()``; rank 0, which holds a JobService on its
    context, waits for the death and the rejoin; pass B on the rejoined
    rank.  Each pass's C is checked.  The kernel counts go to 0 first."""
    from parsec_tpu_torch.comm.engine import make_ce
    from parsec_tpu_torch.comm.remote_dep import RemoteDepEngine
    from parsec_tpu_torch.utils import faultinject
    dev = ctx.device_registry.accelerators[0]
    sync = torch.cuda.synchronize if dev.is_cuda else (lambda: None)
    rde = ctx.comm
    ce = rde.ce
    reset_counts()
    out = {"transport": ctx.comm.stats()["transport"]}
    mats = _gemm_mats(rank, nranks, mb, t, dev)
    sync()
    svc = JobService(context=ctx, max_active=1) if rank == 0 else None
    out["pass_a_s"] = _ft_pass(ctx, sync, gemm_taskpool(*mats.values()))
    out["pass_a"] = _gemm_c_check(mats, mb, t, dev, 1)
    ce.barrier(timeout=600)
    t_down = time.monotonic()
    if rank == 1:
        port_base = ce.port_base
        rde.fini()                         # the rank goes down
        time.sleep(1.0)
        params.set("comm_epoch", 1)        # its restarted incarnation,
        if kill_plan:                      # with the DTD leg's kill
            faultinject.arm(kill_plan)
        t_up = time.monotonic()
        ce = make_ce(rank, nranks, port_base)
        rde = RemoteDepEngine(ce, ctx)
        ctx.recovery.rejoin(timeout=FT_REJOIN_TIMEOUT_S)
        t_ack = time.monotonic()
        out["rejoin"] = {"down_to_ack_s": t_ack - t_down,
                         "up_to_ack_s": t_ack - t_up, "epoch": ce.epoch}
    else:
        deadline = time.monotonic() + FT_REJOIN_TIMEOUT_S
        while 1 not in ce.dead_peers:
            if time.monotonic() > deadline:
                raise TimeoutError("rank 1's death was never declared")
            time.sleep(0.005)
        t_dead = time.monotonic()
        # the dead mark clears in the handshake just before the rejoin is
        # counted and the service told
        while 1 in ce.dead_peers or ctx.recovery.rejoins < 1:
            if time.monotonic() > deadline + FT_REJOIN_TIMEOUT_S:
                raise TimeoutError("rank 1 never rejoined")
            time.sleep(0.005)
        out["rejoin"] = {"down_to_dead_s": t_dead - t_down,
                         "down_to_rejoined_s": time.monotonic() - t_down,
                         "rejoins": ctx.recovery.rejoins,
                         "dead": sorted(ce.dead_peers)}
        svc_states = [(ev.get("state"), ev.get("cause"))
                      for ev in ctx.journal.tail(4096)
                      if ev.get("e") == "service_state"
                      and ev.get("peer") == 1]
        st = svc.stats()
        out["service"] = {"transitions": svc_states,
                          "degraded": st["degraded"],
                          "recovering": st["recovering"]}
        svc.shutdown(timeout=30)
    ce.barrier(timeout=600)
    out["pass_b_s"] = _ft_pass(ctx, sync, gemm_taskpool(*mats.values()))
    out["pass_b"] = _gemm_c_check(mats, mb, t, dev, 2)
    out["rejoin_launches"] = read_counts()
    return out


def ft_rank(ctx, rank: int, nranks: int, mb: int, t: int, setup_s: float,
            kill_plan: str, kill_after: int) -> dict:
    """One rank of the rejoin and DTD-recovery legs (shm, recovery and the
    flight recorder armed): the rejoin leg (``rejoin_rank``, rank 1's
    restarted incarnation arming ``kill_plan``), then the GEMM through
    DTD (``recovery_replay`` re-inserts it, the operands' ``set_init``
    remakes adopted tiles), started on both ranks at ``setup_s`` past rank
    1's restarted engine; rank 1 kills itself (``fault_kill``, the
    ``kill_rank`` directive's close) once it has completed ``kill_after``
    of its tasks in that pool, so the death lands at that share of its
    part of the pass however long the pass takes, and rank 0 recovers.
    Rank 1 sends its own numbers with its start stamp; rank 0 returns both
    ranks'."""
    dev = ctx.device_registry.accelerators[0]
    sync = torch.cuda.synchronize if dev.is_cuda else (lambda: None)
    got, evt = {}, threading.Event()

    def on_go(src, payload):
        got[src] = payload
        evt.set()
    if rank == 0:
        ctx.comm.ce.tag_register(TAG_FT_GO, on_go)
    out = rejoin_rank(ctx, rank, nranks, mb, t, kill_plan)
    gc.collect()
    ce = ctx.comm.ce                       # rank 1's is the restarted one
    reset_counts()
    if dev.is_cuda:
        torch.cuda.reset_peak_memory_stats()
    dmats = _gemm_mats(rank, nranks, mb, t, dev)
    sync()
    tp = DTDTaskpool("gemm-ft")
    tp.recovery_collections = list(dmats.values())
    tp.recovery_replay = lambda pool: gemm_dtd_insert(pool, *dmats.values())
    rec0 = dict(ctx.recovery.counts)
    t0 = time.perf_counter()
    ctx.add_taskpool(tp)                   # takes the recovery snapshot
    out["snapshot_s"] = time.perf_counter() - t0
    out["snapshot_bytes"] = sum(
        p.numel() * p.element_size()
        for M in dmats.values()
        for _v, p in ctx.recovery._snaps.get(id(M), {}).values())
    if rank == 1:
        ce.send_am(TAG_FT_GO, 0, {"started_at": ce.started_at, **out})
        start = ce.started_at
    else:
        if not evt.wait(120):
            raise TimeoutError("no start stamp from rank 1")
        out["peer"] = got[1]
        start = got[1]["started_at"]
        ce.tag_unregister(TAG_FT_GO)
    go = start + setup_s
    out["setup_s"] = time.monotonic() - start
    ahead = go - time.monotonic()
    if ahead > 0:
        time.sleep(ahead)
    else:
        log(f"[rejoin + DTD recovery rank {rank}] set-up took "
            f"{out['setup_s']:.2f} s, past the pool's start at {setup_s} s: "
            f"starting now")
    if 1 - rank in ce.dead_peers:
        raise AssertionError(f"rank {rank}: the kill landed before the "
                             f"DTD pool started")
    if rank == 1:
        kill_on_progress(ctx, tp, kill_after)
    t_start = time.perf_counter()
    gemm_dtd_insert(tp, *dmats.values())
    out["insert_s"] = time.perf_counter() - t_start
    tp.wait()
    ctx.wait()
    sync()
    t_done = time.perf_counter()
    out["run_s"] = t_done - t_start
    out["launches"] = read_counts()
    out["k1"] = k1_tiles()
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 \
        if dev.is_cuda else 0.0
    st = ctx.recovery.stats()
    out["stats"] = st
    out["recoveries"] = {k: st[k] - rec0[k] for k in rec0}
    deaths = [ev for ev in ctx.journal.tail(4096)
              if ev.get("e") == "recovery_start" and tp.taskpool_id in
              (ev.get("pools") or ())]
    out["death_s"] = (deaths[-1]["t"] - t_start) if deaths else None
    skip = [ev for ev in ctx.journal.tail(4096)
            if ev.get("e") == "replay_mode" and ev.get("pool") ==
            tp.taskpool_id]
    out["replay_mode"] = skip[-1] if skip else None
    out["pool"] = tp.taskpool_id
    out["dtd"] = _gemm_c_check(dmats, mb, t, dev, 1, bits=True)
    return out


def phase_rejoin_dtd(dtd_nofault_s: float, size=(2048, 8),
                     setup_s: float = FT_SETUP_S,
                     kill_at: float = RECOVERY_KILL_AT,
                     extra_plan: str = "", device: str = "cuda") -> dict:
    """The elastic rejoin and the DTD recovery on two ranks of this card,
    in one spawn over shm (recovery and the flight recorder armed): the
    rejoin leg (the PTG GEMM; rank 1 down and back as incarnation 1; a
    JobService on rank 0 degraded, then healthy), then the DTD GEMM with
    rank 1 killed once it has completed ``kill_at`` of its share of the
    pool's tasks and recovered on rank 0; ``dtd_nofault_s`` (the 2-rank
    DTD pass measured just before) is what the survivor's time is read
    against.  ``extra_plan`` adds fault directives to rank 1's restarted
    incarnation (a small rehearsal stretches its pass with dispatch
    delays)."""
    mb, t = size
    label_r = f"rejoin: 2-rank GEMM mb={mb}, shm"
    label_d = f"DTD recovery: 2-rank DTD GEMM mb={mb}, rank 1 killed"
    # rank 1 runs the tasks of the C tiles it owns: half of the t^3
    kill_after = max(1, round(kill_at * t ** 3 / DIST_RANKS))
    plan = "seed=17" + (f";{extra_plan}" if extra_plan else "")
    bundle = tempfile.mkdtemp(prefix="parsec_flightrec_")
    env = {"PARSEC_MCA_RECOVERY_ENABLE": "1",
           "PARSEC_MCA_FLIGHTREC_ENABLED": "1",
           "PARSEC_MCA_FLIGHTREC_DIR": bundle,
           # the rejoin's death dumps an incident first; the DTD kill's
           # must not fall inside the recorder's 30 s rate limit
           "PARSEC_MCA_FLIGHTREC_MIN_INTERVAL_S": "1",
           "PARSEC_MCA_COMM_TRANSPORT": "shm"}
    log(f"[{label_r}] then [{label_d}]: rank 1's restarted incarnation "
        f"arms {plan!r}; the pool starts {setup_s:.1f} s after that "
        f"incarnation's engine came up, and rank 1 dies after completing "
        f"{kill_after} of its {t ** 3 // DIST_RANKS} tasks in it "
        f"({kill_at:.2f} of its share; the 2-rank DTD pass took "
        f"{dtd_nofault_s * 1e3:.1f} ms)")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        res = run_distributed(ft_rank, DIST_RANKS,
                              args=(mb, t, setup_s, plan, kill_after),
                              device=device,
                              timeout=900, tolerate_ranks=(1,))
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    try:
        if res[1] is not None or res[0] is None:
            raise AssertionError(f"[{label_d}] rank 1 must die and rank 0 "
                                 f"complete: {res}")
        r0 = res[0]
        r1 = r0["peer"]
        log(f"[{label_r}] {wall:.1f} s for both legs with spawn and "
            f"set-up; transport {r0['transport']}")
        # -- rejoin ---------------------------------------------------------
        rj0, rj1 = r0["rejoin"], r1["rejoin"]
        pa = max(r0["pass_a_s"], r1["pass_a_s"])
        pb = max(r0["pass_b_s"], r1["pass_b_s"])
        worst = max(r["pass_a"]["worst_rel"] for r in (r0, r1))
        worst_b = max(r["pass_b"]["worst_rel"] for r in (r0, r1))
        svc = r0["service"]
        log(f"[{label_r}] rank 1 down -> rank 0 declared it dead "
            f"{rj0['down_to_dead_s']:.3f} s, rejoined (dead mark cleared) "
            f"{rj0['down_to_rejoined_s']:.3f} s; rank 1 down -> rejoin ACK "
            f"{rj1['down_to_ack_s']:.3f} s (1.0 s of it down by design; "
            f"its new engine up -> ACK {rj1['up_to_ack_s']:.3f} s), "
            f"incarnation epoch {rj1['epoch']}; rank 0 rejoins "
            f"{rj0['rejoins']}, dead set {rj0['dead']}; pass A "
            f"{pa * 1e3:.1f} ms, pass B (on the rejoined rank) "
            f"{pb * 1e3:.1f} ms ({pb / pa:.3f} x pass A; slowest rank); C "
            f"rel err after A {worst:.3e}, after B {worst_b:.3e} (limit "
            f"{GEMM_DIST_TOL:.0e}); JobService on rank 0: {svc}")
        if rj0["rejoins"] != 1 or rj0["dead"] or rj1["epoch"] != 1:
            raise AssertionError(f"[{label_r}] rejoin {rj0} {rj1}")
        if not (worst <= GEMM_DIST_TOL and worst_b <= GEMM_DIST_TOL):
            raise AssertionError(f"[{label_r}] C disagrees: {worst}, "
                                 f"{worst_b}")
        states = [s for s, _c in svc["transitions"]]
        if svc["degraded"] or svc["recovering"] or not states or \
                states[0] != "recovering" or states[-1] != "healthy" or \
                ("healthy", "rejoin") not in svc["transitions"]:
            raise AssertionError(f"[{label_r}] the service did not go "
                                 f"degraded -> healthy: {svc}")
        # -- DTD recovery ---------------------------------------------------
        rc = r0["recoveries"]
        st = r0["stats"]
        death = r0["death_s"]
        mode = r0["replay_mode"] or {}
        d = r0["dtd"]
        # a fallback to the full replay is printed with its reason
        why = "" if mode.get("mode") == "skip" else \
            f", fallback reason {mode.get('reason')!r}"
        log(f"[{label_d}] rank 0 set-up {r0['setup_s']:.2f} s; snapshot "
            f"at attach {r0['snapshot_bytes'] / 2**30:.3f} GiB of host "
            f"copies in {r0['snapshot_s']:.3f} s (rank 1: "
            f"{r1['snapshot_bytes'] / 2**30:.3f} GiB in "
            f"{r1['snapshot_s']:.3f} s); rank 1 declared dead "
            f"{(death or 0) * 1e3:.1f} ms into the pool "
            f"({(death or 0) / dtd_nofault_s:.3f} of the no-fault pass), "
            f"the insert stream ended {r0['insert_s'] * 1e3:.1f} ms in "
            f"(the restart waits for its end)")
        log(f"[{label_d}] rank 0 from the pool's start to completion "
            f"{r0['run_s'] * 1e3:.1f} ms, {r0['run_s'] / dtd_nofault_s:.3f} "
            f"x the no-fault 2-rank DTD pass; recoveries {rc}; replay "
            f"{mode.get('mode')}: agreed skip prefix "
            f"{mode.get('prefix')} of {t ** 3} inserts ghosted, held cut "
            f"payloads {mode.get('seeds')} (all held by rank 0, the sole "
            f"survivor), {mode.get('tasks')} tasks re-run{why}; "
            f"minimal replays {st['minimal_replays']}, full replays "
            f"{st['full_replays']}, skip agreements "
            f"{st['skip_agreements']}; tasks re-executed "
            f"{st['tasks_reexecuted']}; restored tiles by source "
            f"{st['restored_tiles']}; K1 tiles on the survivor {r0['k1'][0]} "
            f"({r0['k1'][1]} wgmma), launches {r0['launches']}; peak "
            f"device memory {r0['peak_gib']:.2f} GiB")
        log(f"[{label_d}] {d['count']} C tiles on the survivor against the "
            f"plain-version product: rel err {d['worst_rel']:.3e} (limit "
            f"{GEMM_DIST_TOL:.0e}); bit-identical to the PTG path's C (K1's "
            f"chain over k) {d['bit_identical']}")
        if rc["started"] != 1 or rc["failed"] != 0 or rc["completed"] != 1:
            raise AssertionError(f"[{label_d}] recoveries {rc}")
        if d["count"] != t * t or not d["worst_rel"] <= GEMM_DIST_TOL:
            raise AssertionError(f"[{label_d}] C fails its check: {d}")
        if death is None or not 0.0 < death < r0["run_s"]:
            raise AssertionError(f"[{label_d}] the death ({death}) is not "
                                 f"inside the run ({r0['run_s']})")
        deadline = time.time() + 30
        while not os.path.exists(os.path.join(bundle, "rank0.ptt")) and \
                time.time() < deadline:
            time.sleep(0.1)
        summary = summarize_bundle(bundle)
        incidents = [(i["rank"], i["reason"]) for i in summary["incidents"]]
        log(f"[{label_d}] flight-recorder bundle: ranks {summary['ranks']}, "
            f"{summary['events']} events, flows {summary['flows']}; "
            f"incidents {incidents}")
        if not any(rk == 0 and why.startswith("recovery-start") and
                   f"[{r0['pool']}]" in why for rk, why in incidents):
            raise AssertionError(f"[{label_d}] the bundle lacks rank 0's "
                                 f"recovery-start incident for the DTD pool")
    finally:
        shutil.rmtree(bundle, ignore_errors=True)
    launches = collections.Counter(r0["launches"])
    for r in (r0, r1):
        launches.update(r["rejoin_launches"])
    return {"launches": dict(launches),
            "rejoin": {"down_to_ack_s": rj1["down_to_ack_s"],
                       "up_to_ack_s": rj1["up_to_ack_s"],
                       "pass_a_ms": pa * 1e3, "pass_b_ms": pb * 1e3,
                       "service": svc["transitions"]},
            "dtd": {"run_ms": r0["run_s"] * 1e3,
                    "ratio_to_nofault": r0["run_s"] / dtd_nofault_s,
                    "death_share": death / dtd_nofault_s,
                    "replay": {k: mode.get(k) for k in
                               ("mode", "prefix", "seeds", "tasks",
                                "reason")},
                    "recovery": {k: st[k] for k in
                                 ("minimal_replays", "full_replays",
                                  "skip_agreements", "tasks_reexecuted",
                                  "restored_tiles")},
                    "snapshot_bytes": r0["snapshot_bytes"],
                    "snapshot_s": r0["snapshot_s"],
                    "worst_rel": d["worst_rel"],
                    "bit_identical": d["bit_identical"],
                    "k1": r0["k1"][0], "peak_gib": r0["peak_gib"]}}


# -- several device modules on the one card: the ICI engine ------------------

#: modules of the multi-module phase (``device="cuda*8"``): the JAX
#: package's 8-device mesh (MULTICHIP_r05.json), time-sharing one card
MESH_MODULES = 8
#: the phase's paths at the single-module paths' widths
MESH_SIZES = {"gemm": (2048, 8), "potrf": (6144, 16), "qr": (6144, 8),
              "wave": (8, 4096), "zig": 4096, "attn": (8, 4096, 128),
              "spmd": 16384, "halo": 1 << 26}
#: the SPMD trio's limits: tests/test_parallel_spmd.py's (1e-4 for the
#: GEMMs, 1e-5 for the stencil)
SPMD_TOL, HALO_TOL = 1e-4, 1e-5
HALO_STEPS = 8
#: the permute wave's batching window (the reference test's): only a full
#: round flushes, so k edges ride <= 2 launches
WAVE_WINDOW_MS = 1000.0


def mesh_report(label: str, ctx: Context, ici0: dict, pass_ms: float,
                launches: dict, one_ms: float = None) -> dict:
    """A path's ICI counts (against ``ici0``) and each module's ledger
    peak, printed with its pass time beside the one-module pass's and its
    kernel launches."""
    now = ctx.ici.stats.as_dict()
    ici = {k: now[k] - ici0[k] for k in now}
    peaks = [m.bytes_peak / 2**30 for m in ctx.device_registry.accelerators]
    beside = f" (one module: {one_ms:.1f} ms, {pass_ms / one_ms:.3f} x)" \
        if one_ms else " (no one-module pass)"
    log(f"[{label}] {len(peaks)} modules time-sharing one card: pass "
        f"{pass_ms:.1f} ms{beside}; launches {launches}; IciStats {ici}; "
        f"module ledger peaks (GiB) {['%.3f' % g for g in peaks]}")
    return {"ici": ici, "module_peak_gib": peaks, "pass_ms": pass_ms,
            "one_module_ms": one_ms}


def drive_mesh_gemm(ctx: Context, mb: int, t: int, passes: int,
                    gen: torch.Generator, label: str) -> dict:
    """The tiled GEMM over the modules with ``panel_bcast``: A and B (bf16)
    on the host, as the JAX package's dryrun holds them (pinned on the
    card's host), C (f32) born on the module ``distribute_devices`` pins
    each tile to; each A-row / B-column reader fans its panel out to the
    GEMM tasks, and the ICI engine broadcasts a panel whose consumers sit
    on several modules.  One warm pass, ``passes`` timed; tasks,
    incarnations and K1 tiles checked every pass, C once against the
    plain product (C0 + passes' sum of A @ B, tile by tile)."""
    dev = path_device(ctx)
    on_card = dev.is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n = t * mb

    def host(dtype):
        x = torch.randn((n, n), generator=gen, device=dev.tdev).to(dtype)
        x = x.cpu()
        return x.pin_memory() if on_card else x
    A = TwoDimBlockCyclic(mb, mb, n, n, dtype=torch.bfloat16,
                          name="A").from_array(host(torch.bfloat16))
    B = TwoDimBlockCyclic(mb, mb, n, n, dtype=torch.bfloat16,
                          name="B").from_array(host(torch.bfloat16))
    C = TwoDimBlockCyclic(mb, mb, n, n, dtype=torch.float32, name="C")
    c0 = {}
    for (m, k) in C.local_tiles():
        c0[(m, k)] = torch.randn((mb, mb), generator=gen, device=dev.tdev)
        place(C, m, k, dev, c0[(m, k)].clone())
    sync()
    ntasks, readers = t ** 3, 2 * t * t
    inc = _Incarnations(ctx)
    reset_counts()
    inc.take()
    dev0 = device_counts(dev)
    ici0 = ctx.ici.stats.as_dict()
    times = []
    for p in range(passes + 1):
        # a new host version of every panel (the same values), outside
        # the timed window: the modules' replicas of the last pass go
        # stale, so each pass broadcasts its panels again
        for M in (A, B):
            for (m, k) in M.local_tiles():
                M.data_of(m, k).overwrite_host(M._tile_view(m, k))
        tiles0, wgmma0 = k1_tiles()
        executed0 = dev.stats.executed_tasks
        b0 = ctx.ici.stats.as_dict()
        t0 = time.perf_counter()
        ctx.add_taskpool(gemm_taskpool(A, B, C, panel_bcast=True))
        ctx.wait()
        sync()
        dt = time.perf_counter() - t0
        executed = dev.stats.executed_tasks - executed0
        tiles, wgmma = k1_tiles()[0] - tiles0, k1_tiles()[1] - wgmma0
        counts = inc.take()
        want = {("GEMM", "exec_async"): ntasks,
                ("RA", "exec_end"): t * t, ("RB", "exec_end"): t * t}
        if executed != ntasks or counts != want or (
                on_card and (tiles != ntasks or wgmma != ntasks)):
            raise AssertionError(
                f"[{label}] pass {p}: {executed} device tasks, "
                f"incarnations {counts}, {tiles} K1 tiles ({wgmma} "
                f"wgmma); expected {ntasks}, {want}, {ntasks} on wgmma")
        b1 = ctx.ici.stats.as_dict()
        log(f"[{label}] pass {p} ({'timed' if p else 'warm'}): "
            f"{dt * 1e3:.1f} ms, {total_flops(n, n, n) / dt / 1e9:.1f} "
            f"GFLOP/s, {tiles} K1 tiles, {readers} panel readers; ICI "
            f"bcasts {b1['bcasts'] - b0['bcasts']} carrying "
            f"{(b1['bcast_bytes'] - b0['bcast_bytes']) / 2**30:.2f} GiB, "
            f"puts {b1['puts'] - b0['puts']}")
        if p:
            times.append(dt)
    launches = read_counts()
    device = report_device(label, dev, dev0)
    ici = {k: v - ici0[k] for k, v in ctx.ici.stats.as_dict().items()}
    if ici["bcasts"] <= 0:
        raise AssertionError(f"[{label}] no panel broadcast fired: {ici}")
    worst = 0.0
    for (m, k2) in C.local_tiles():
        prod = torch.zeros_like(c0[(m, k2)])
        for k in range(t):
            a = A._tile_view(m, k).to(dev.tdev)
            b = B._tile_view(k, k2).to(dev.tdev)
            prod = gemm_tile_reference(a, b, prod, 1.0)
        got = newest_payload(C, m, k2).to(dev.tdev)
        if not torch.isfinite(got).all():
            raise AssertionError(f"[{label}] C({m},{k2}) is not finite")
        worst = max(worst, rel_err(got, c0[(m, k2)] + (passes + 1) * prod))
    log(f"[{label}] C against the tile-by-tile plain product: rel err "
        f"{worst:.3e} (limit 1e-3); kernel launches {launches}")
    if worst > 1e-3:
        raise AssertionError(f"[{label}] C disagrees: {worst}")
    return {"launches": launches, "times": times, "best_s": min(times),
            "rel_err": worst, "cpu_tasks": (passes + 1) * readers,
            "device": device}


def drive_zig(ctx: Context, n: int, label: str) -> dict:
    """The zig chain (tests/test_ici.py's): S(k) on tile k's module adds
    one and feeds S(k+1) on the next module, so every edge crosses modules
    with one consumer and must ride a proactive placement (a put, or a
    permute edge).  Tiles of (n, n) f32 born on their modules; the last
    one must read the module count exactly."""
    dev = path_device(ctx)
    sync = torch.cuda.synchronize if dev.is_cuda else (lambda: None)
    nd = len(dev.modules)
    V = TwoDimBlockCyclic(n, n, nd * n, n, name="Z")
    for k in range(nd):
        place(V, k, 0, dev, torch.full((n, n), float(k), device=dev.tdev))
    sync()
    p = PTG("zig", NT=nd)
    p.task("S", k=Range(0, nd - 1)) \
        .affinity(lambda k, V=V: V(k, 0)) \
        .flow("T", "RW",
              IN(DATA(lambda k, V=V: V(k, 0)), when=lambda k: k == 0),
              IN(TASK("S", "T", lambda k: dict(k=k - 1)),
                 when=lambda k: k > 0),
              OUT(TASK("S", "T", lambda k: dict(k=k + 1)),
                  when=lambda k, ND=nd: k < ND - 1),
              OUT(DATA(lambda k, V=V: V(k, 0)),
                  when=lambda k, ND=nd: k == ND - 1)) \
        .body(lambda T: T + 1.0, device="cuda") \
        .body(lambda T: T + 1.0)
    reset_counts()
    ici0 = ctx.ici.stats.as_dict()
    t0 = time.perf_counter()
    ctx.add_taskpool(p.build())
    ctx.wait()
    ctx.flush_ici()
    sync()
    dt = time.perf_counter() - t0
    d = {k: v - ici0[k] for k, v in ctx.ici.stats.as_dict().items()}
    ok = bool(torch.all(newest_payload(V, nd - 1, 0) == float(nd)))
    log(f"[{label}] {nd} tasks over {nd} modules, ({n}, {n}) f32: "
        f"{dt * 1e3:.2f} ms; proactive placements: puts {d['puts']}, "
        f"permute edges {d['permute_edges']}; last tile == {nd}: {ok}")
    if not ok or d["puts"] + d["permute_edges"] <= 0:
        raise AssertionError(f"[{label}] value ok {ok}, ICI {d}: no "
                             f"proactive placement fired")
    return {"launches": read_counts(), "best_s": dt}


def drive_spmd(ctx: Context, n: int, halo_n: int, gen: torch.Generator,
               label: str) -> dict:
    """The SPMD trio (parallel/spmd.py) over the context's modules: SUMMA
    on the 2x4 mesh and the reduce-scatter GEMM on the 1x8 ring at n x n
    f32 with TF32 off (operands scaled by n^-1/4, so C is O(1) as at the
    reference tests' sizes, where their absolute tolerance holds), each
    held to the plain product on the first module's device; then the halo
    stencil over ``halo_n`` f32 for ``HALO_STEPS`` steps against its
    serial form.  One warm call, one timed, each."""
    mods = list(ctx.device_registry.accelerators)
    on_card = mods[0].is_cuda
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tdev = mods[0].tdev
    mesh2d = spmd.make_mesh(devices=mods)
    mesh1d = spmd.make_mesh(shape=(len(mods),), axis_names=("p",),
                            devices=mods)
    scale = n ** -0.25
    A = torch.randn((n, n), generator=gen, device=tdev) * scale
    B = torch.randn((n, n), generator=gen, device=tdev) * scale
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = torch.matmul(A, B)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    out = {}

    def timed(fn, *args):
        fn(*args)
        sync()
        t0 = time.perf_counter()
        y = fn(*args)
        sync()
        return y, time.perf_counter() - t0

    for name, fn in (("summa", spmd.summa_gemm_fn(mesh2d)),
                     ("ring_reduce", spmd.ring_reduce_gemm_fn(mesh1d))):
        C, dt = timed(fn, A, B)
        err = (C - ref).abs()
        excess = float((err - (SPMD_TOL + SPMD_TOL * ref.abs())).max())
        out[name] = {"s": dt, "max_abs_err": float(err.max()),
                     "excess": excess}
        log(f"[{label}] {name} n={n} f32 (TF32 off) over "
            f"{mesh2d.shape if name == 'summa' else mesh1d.shape}: "
            f"{dt * 1e3:.1f} ms, {2.0 * n ** 3 / dt / 1e12:.2f} TFLOP/s; "
            f"max abs err against the plain product {float(err.max()):.3e}"
            f", worst excess over {SPMD_TOL:.0e} + {SPMD_TOL:.0e}|ref| "
            f"{excess:.3e} (must be <= 0)")
        if not excess <= 0:
            raise AssertionError(f"[{label}] {name} outside the "
                                 f"tolerance: {excess}")
        del C, err
    x = torch.randn(halo_n, generator=gen, device=tdev)
    y, dt = timed(spmd.halo_stencil_fn(mesh1d, steps=HALO_STEPS), x)
    want = x
    for _ in range(HALO_STEPS):
        want = (torch.roll(want, 1) + torch.roll(want, -1) + want) / 3.0
    err = float((y - want).abs().max())
    excess = float(((y - want).abs()
                    - (HALO_TOL + HALO_TOL * want.abs())).max())
    out["halo"] = {"s": dt, "max_abs_err": err, "excess": excess}
    log(f"[{label}] halo stencil {halo_n} f32 x {HALO_STEPS} steps over "
        f"{mesh1d.shape}: {dt * 1e3:.1f} ms; max abs err against the "
        f"serial stencil {err:.3e}, worst excess over {HALO_TOL:.0e} + "
        f"{HALO_TOL:.0e}|ref| {excess:.3e} (must be <= 0)")
    if not excess <= 0:
        raise AssertionError(f"[{label}] halo stencil outside the "
                             f"tolerance: {excess}")
    return out


def phase_multi_module(one: dict = None, device: str = None,
                       sizes: dict = None,
                       gen: torch.Generator = None) -> dict:
    """Every multi-device path over ``device`` (``"cuda*8"``: eight device
    modules time-sharing the one card, each its own launch stream, memory
    space, LRU and budget), each in a Context of its own: the GEMM with
    panel broadcasts, potrf (median of 3), geqrf (one timed pass with the
    QR checks), the permute wave (k edges on <= 2 launches), the zig chain
    (a proactive placement fires), ring attention with its blocks spread
    over the modules, and the SPMD trio.  ``one`` holds the single-module
    paths' summaries, whose pass times each line prints beside its own.
    Returns each path's summary with its IciStats and ledger peaks."""
    device = device or f"cuda*{MESH_MODULES}"
    sizes = {**MESH_SIZES, **(sizes or {})}
    one = one or {}
    on_card = device.startswith("cuda")
    gen = gen or torch.Generator(
        device="cuda" if on_card else "cpu").manual_seed(SEED + 15)
    tag = device

    def one_ms(path):
        return one[path]["pass_ms"] if path in one else None

    def run(label, body):
        def phase(ctx):
            if ctx.ici is None:
                raise AssertionError(f"[{label}] no ICI engine on {device}")
            ici0 = ctx.ici.stats.as_dict()
            summary = body(ctx)
            summary.update(mesh_report(label, ctx, ici0,
                                       summary["pass_ms"],
                                       summary["launches"],
                                       summary.pop("one_ms", None)))
            return summary
        return in_context(phase, label, device=device)

    def gemm(ctx):
        mb, t = sizes["gemm"]
        res = drive_mesh_gemm(ctx, mb, t, 3, gen,
                              f"GEMM mb={mb} panel_bcast, {tag}")
        return {"launches": res["launches"],
                "pass_ms": res["best_s"] * 1e3,
                "one_ms": one_ms(f"GEMM mb={mb}"),
                "rel_err": res["rel_err"], "cpu_tasks": res["cpu_tasks"]}

    def potrf_path(ctx):
        mb, nt = sizes["potrf"]
        res = drive_potrf(ctx, mb, nt, torch.bfloat16, passes=3,
                          label=f"potrf mb={mb}, {tag}")
        return {"launches": res["launches"],
                "pass_ms": statistics.median(res["times"]) * 1e3,
                "one_ms": one_ms(f"potrf mb={mb}"),
                "backward_error": res["backward_error"]}

    def qr_path(ctx):
        mb, nt = sizes["qr"]
        res = drive_qr(ctx, mb, nt, torch.bfloat16, passes=1,
                       label=f"QR mb={mb}, {tag}")
        return {"launches": res["launches"],
                "pass_ms": res["best_s"] * 1e3,
                "one_ms": one_ms(f"QR mb={mb}"),
                "residual": res["residual"]}

    def wave_path(ctx):
        P, n = sizes["wave"]
        label = f"permute wave P={P}, {tag}"
        seen = [ctx.ici.stats.as_dict()]

        def per_pass(what):
            # the pass's moves; then drain what is left in the window (a
            # quiescence point, as the JAX package's dryrun does), so each
            # pass starts with an empty batch
            now = ctx.ici.stats.as_dict()
            d = {k: now[k] - seen[-1][k] for k in now}
            log(f"[{label}] {what}: {P} edges, permutes {d['permutes']} "
                f"carrying {d['permute_edges']} edges, puts {d['puts']} "
                f"(limit: 2 launches, >= {P - 2} edges batched)")
            if d["permutes"] + d["puts"] > 2 or \
                    d["permute_edges"] < P - 2:
                raise AssertionError(f"[{label}] {what}: the wave's edges "
                                     f"did not ride <= 2 launches: {d}")
            ctx.ici.flush_placements(force=True)
            seen.append(ctx.ici.stats.as_dict())
        params.set("comm_ici_permute_window_ms", WAVE_WINDOW_MS)
        try:
            res = drive_wave(ctx, P, n, passes=3, label=label,
                             after_pass=per_pass)
        finally:
            params.unset("comm_ici_permute_window_ms")
        return {"launches": res["launches"],
                "pass_ms": res["best_s"] * 1e3,
                "one_ms": one_ms(f"permute wave P={P}"),
                "cpu_tasks": res["cpu_tasks"]}

    def zig(ctx):
        res = drive_zig(ctx, sizes["zig"], f"zig chain, {tag}")
        return {"launches": res["launches"],
                "pass_ms": res["best_s"] * 1e3}

    def attn(ctx):
        P, T, d = sizes["attn"]
        res = drive_ring_attention(ctx, P, T, d, False, passes=2, gen=gen,
                                   label=f"ring attention N={P * T}, {tag}")
        return {"launches": res["launches"],
                "pass_ms": res["best_s"] * 1e3,
                "one_ms": one_ms(f"ring attention N={P * T}"),
                "max_abs_err": res["max_abs_err"]}

    def spmd_path(ctx):
        res = drive_spmd(ctx, sizes["spmd"], sizes["halo"], gen,
                         f"SPMD trio, {tag}")
        return {"launches": read_counts(),
                "pass_ms": sum(r["s"] for r in res.values()) * 1e3,
                "spmd": res}

    paths = {"gemm": ("GEMM", gemm), "potrf": ("potrf", potrf_path),
             "qr": ("QR", qr_path), "wave": ("permute wave", wave_path),
             "zig": ("zig chain", zig), "attn": ("ring attention", attn),
             "spmd": ("SPMD trio", spmd_path)}
    t0 = time.perf_counter()
    out = {}
    for key, (name, body) in paths.items():
        reset_counts()
        out[f"{name}, {tag}"] = run(f"{name}, {tag}", body)
    log(f"[{tag}] the multi-module phase took "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    key, peaks = peaks_for(name)
    log(f"card: {smi}")
    log(f"torch.cuda: {name}, {torch.cuda.device_count()} device(s); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"parsec_tpu_torch {parsec_tpu_torch.__version__}; "
        f"bound from the {key} peaks")
    log(f"device module: {device_settings()}")
    check_no_degraded_mode()
    # the traced passes' traces, kept for the tools phase
    with tempfile.TemporaryDirectory(prefix="parsec_traces_") as keep:
        return drive(smi, name, peaks, keep)


def drive(smi: str, name: str, peaks, keep: str) -> int:
    """Every phase after the card check (``main``); ``keep`` holds the
    traced passes' traces until the tools phase has read them."""
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    t0 = time.perf_counter()
    path = cuda_kernels.build(verbose=True)
    log(f"build: {path.name} from {len(cuda_kernels.sources())} sources in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(nvcc {cuda_kernels.last_build_seconds:.1f} s)")

    k1 = phase_kernels(dev, peaks)
    torch.cuda.empty_cache()
    entries = {"gemm_tile": k1,
               "gemm_tile_grouped": phase_k1_forms(dev, peaks, k1),
               "gram_tile": phase_gram(dev, peaks)}
    torch.cuda.empty_cache()

    host = phase_host(smi)

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    # the single-rank potrf and QR runs' final tiles, held on the card
    # for the 2-rank paths' checks
    refs = {"potrf": {}, "qr": {}, "dtd_gemm": {}}
    per_path = {
        "GEMM mb=12288": in_context(lambda ctx: phase_gemm(ctx, gen),
                                    "GEMM path mb=12288"),
        # the small-tiles path at sched_native 1, then 0: native against
        # the Python ladder, in turns
        "GEMM mb=2048": in_context(
            lambda ctx: phase_small_tiles(ctx, gen, traced=True,
                                          trace_dir=keep), "mb=2048",
            sched_native=1),
        "GEMM mb=2048 ladder": in_context(
            lambda ctx: phase_small_tiles(ctx, gen), "mb=2048 ladder",
            sched_native=0),
        "DTD GEMM mb=12288": in_context(lambda ctx: phase_dtd_gemm(ctx, gen),
                                        "DTD GEMM mb=12288"),
        "DTD GEMM mb=2048": in_context(
            lambda ctx: phase_front_small(ctx, gen, "dtd",
                                          "DTD GEMM mb=2048",
                                          keep=refs["dtd_gemm"]),
            "DTD GEMM mb=2048"),
        "JDF GEMM mb=2048": in_context(
            lambda ctx: phase_front_small(ctx, gen, "jdf",
                                          "JDF GEMM mb=2048"),
            "JDF GEMM mb=2048"),
        "QR mb=6144": in_context(lambda ctx: phase_qr(ctx, refs["qr"]),
                                 "QR path mb=6144"),
        "potrf mb=6144": in_context(
            lambda ctx: phase_potrf(ctx, refs["potrf"], trace_dir=keep),
            "potrf path mb=6144"),
        "ring attention N=32768": in_context(
            lambda ctx: phase_ring_attention(ctx, gen, causal=False),
            "ring attention N=32768"),
        "ring attention causal N=32768": in_context(
            lambda ctx: phase_ring_attention(ctx, gen, causal=True),
            "ring attention causal N=32768"),
        "recursive potrf n=8192": in_context(
            lambda ctx: phase_recursive_potrf(ctx, gen),
            "recursive potrf n=8192"),
        "permute wave P=8": in_context(phase_wave, "permute wave P=8"),
        "checkpoint + grapher mb=2048": in_context(
            phase_checkpoint_grapher, "checkpoint + grapher mb=2048")}
    dist = phase_distributed(refs, trace_dir=keep)
    recovered = phase_recovery(refs["potrf"], dist["potrf"]["pass_s"])
    rejoined = phase_rejoin_dtd(dist["dtd_gemm"]["pass_ms"] / 1e3)
    del refs
    gc.collect()
    torch.cuda.empty_cache()
    per_path.update({"2-rank potrf mb=6144": dist["potrf"],
                     "2-rank GEMM mb=2048": dist["gemm"],
                     "2-rank DTD GEMM mb=2048": dist["dtd_gemm"],
                     "2-rank QR mb=6144": dist["qr"],
                     "2-rank pingpong": dist["pingpong"],
                     "2-rank potrf mb=6144, rank 1 killed": recovered,
                     "2-rank rejoin + DTD GEMM mb=2048, rank 1 killed":
                     rejoined})
    # eight device modules time-sharing the card: the ICI engine's paths
    per_path.update(phase_multi_module(per_path))
    gc.collect()
    torch.cuda.empty_cache()
    # the resident job service, run after every other path, with the
    # client tools; then the trace tools and the chaos harness
    per_path["serving"] = phase_serving(clients=True)
    gc.collect()
    torch.cuda.empty_cache()
    per_path["tools"] = phase_tools(
        {p: (per_path[p]["trace"]["ptt"], per_path[p]["trace"]["ntasks"])
         for p in ("GEMM mb=2048", "potrf mb=6144")},
        dist["potrf"]["traces"], per_path["serving"]["clients"])
    nat, lad = per_path["GEMM mb=2048"], per_path["GEMM mb=2048 ladder"]
    log(f"[mb=2048] {nat['scheduler']['name']} against "
        f"{lad['scheduler']['name']}: best pass {nat['pass_ms']:.1f} ms "
        f"against {lad['pass_ms']:.1f} ms (ratio "
        f"{nat['pass_ms'] / lad['pass_ms']:.3f}), estimated idle share "
        f"{nat['idle_share']:.3f} against {lad['idle_share']:.3f}")

    for path_name, res in per_path.items():
        log(f"launches on path {path_name}: {res['launches']}")
    # the kernels line counts the main path at the defaults, the 2-rank
    # paths' launches summed over their ranks: the ladder rerun of
    # mb=2048 is an A/B of the scheduler, and the 2-rank potrf's shm and
    # evloop turns an A/B of the transport; their launches are left out
    main_paths = [r for p, r in per_path.items()
                  if p != "GEMM mb=2048 ladder"]
    for kname, entry in entries.items():
        entry["launches"] = sum(r["launches"][kname] for r in main_paths)
        # at one launch per task (device_fuse=1) no grouped launch is on
        # a path
        on_path = kname != "gemm_tile_grouped" or \
            int(params.get("device_fuse")) > 1
        if on_path and entry["launches"] <= 0:
            raise AssertionError(f"{kname} was never launched on a path")
    print(json.dumps({"device_module": device_settings(),
                      "sched_native": params.get("sched_native"),
                      "host": host, "paths": per_path}))
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card "
        f"check")
    print(json.dumps({"kernels": list(entries.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
