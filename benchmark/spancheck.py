"""A cell's traced passes with the program's device spans on, against the
CUPTI trace of the same passes.

    python3 -m benchmark.spancheck --workload <cell> --seed <n> \
        [--seconds 4] [--rounds 2] [--out <file.json>]

Runs the cell's set-up as the harness does (operands from the seed, one
warm pass), then ``2 * rounds`` traced windows in turns, spans off, on,
on, off, ...: each window is at least ``--seconds`` and two passes under
``torch.profiler`` (CUDA activity alone), as the harness's ``--trace 1``
run traces them; in a window with spans on the program's causal tracer
records its ``device`` and ``stages`` classes (prof/causal.py) beside
it.  It prints, and writes to ``--out``, one JSON object:

- ``readings``: ``trsm_share.potrf``, ``launch_us.potrf``,
  ``idle_dag.potrf`` (benchmark/spans.py) of each window with spans on;
- ``gaps``: the longest idle gaps, named ``<harness stage>><program
  span>``;
- ``agreement``: each launch step's ``dev:`` start and end against the
  first and last CUPTI kernel whose middle lies inside the step (median
  and 99th percentile of |difference|, us; then the window's clock
  offset, the median of a step's two signed differences, and the same
  statistics less it); the union of ``dev:``
  intervals against CUPTI's kernel-busy time inside ``bm.wait`` (relative
  difference); TRSM's share by its spans against CUPTI's share of the
  kernel that takes most of TRSM's steps' time, by name, and of every
  kernel inside TRSM's steps;
- ``cost``: the mean traced pass with spans on over the one with spans
  off, and each window's device idle share (``device_idle.*``'s reading).

Needs a CUDA card; ``--device cpu`` runs the program on its CPU-backed
module (tests only: no kernel is traced there, so no agreement).
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import os
import statistics
import sys
import tempfile
import warnings
from typing import Dict, List, Optional

import torch

from benchmark import spans as sp
from benchmark import cards, spec
from benchmark import trace as tr
from benchmark.harness import Stages, log
from benchmark.window import run_window

#: the task class whose device share trsm_share reads
TRSM = "TRSM"


def _percentile(values: List[float], q: float) -> Optional[float]:
    if not values:
        return None
    v = sorted(values)
    return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]


def agreement(summary: tr.TraceSummary, spans: sp.ProgramSpans) -> dict:
    """The program's device spans against the CUPTI kernels of the same
    window (see the module docstring)."""
    t0, t1 = summary.t0, summary.t1
    kernels = sorted((s, s + d, n) for n, s, d in summary.kernels)
    mids = [(s + e) / 2 for s, e, _ in kernels]
    steps = sorted({(s, e, lid, c) for c, s, e, lid, _clk in spans.dev
                    if t0 <= s and e <= t1})
    starts, ends, empty = [], [], 0
    by_class: Dict[str, list] = {}
    for s, e, _lid, cls in steps:
        lo, hi = bisect.bisect_left(mids, s), bisect.bisect_right(mids, e)
        if lo >= hi:
            empty += 1
            continue
        inside = kernels[lo:hi]
        starts.append(inside[0][0] - s)
        ends.append(max(k[1] for k in inside) - e)
        by_class.setdefault(cls, []).extend(inside)
    deltas = [abs(d) for d in starts + ends]
    # what both ends of a step share is an offset of one clock against
    # the other (the program's anchor or the profiler's own conversion of
    # the card's time); the rest is the steps' shape
    offset = _percentile([(a + b) / 2 for a, b in zip(starts, ends)], 0.5)
    shape = [abs(d - offset) for d in starts + ends] if starts else []
    wait = tr.merge((s, e) for n, s, e in summary.stages if n == "bm.wait")
    dev_u = sp.intersect(tr.merge((s, e) for _c, s, e, *_ in spans.dev),
                         wait)
    ker_u = sp.intersect(tr.merge((s, e) for s, e, _ in kernels), wait)
    busy = tr.total(tr.clip(tr.merge((s, e) for s, e, _ in kernels), t0,
                            t1))
    out = {"steps": len(steps), "steps_without_kernel": empty,
           "edge_us_median": _percentile(deltas, 0.5),
           "edge_us_p99": _percentile(deltas, 0.99),
           "first_kernel_after_start_us_median": _percentile(starts, 0.5),
           "last_kernel_end_after_end_us_median": _percentile(ends, 0.5),
           "clock_offset_us": offset,
           "edge_us_median_less_offset": _percentile(shape, 0.5),
           "edge_us_p99_less_offset": _percentile(shape, 0.99),
           "dev_union_in_wait_s": tr.total(dev_u) * 1e-6,
           "kernel_busy_in_wait_s": tr.total(ker_u) * 1e-6,
           "dev_vs_kernel_busy_rel": (tr.total(dev_u) / tr.total(ker_u) - 1)
           if ker_u else None}
    trsm = by_class.get(TRSM, [])
    if trsm and busy > 0:
        by_name: Dict[str, float] = {}
        for s, e, n in trsm:
            by_name[n] = by_name.get(n, 0.0) + e - s
        product = max(by_name, key=by_name.get)
        named = tr.clip(tr.merge((s, e) for s, e, n in kernels
                                 if n == product), t0, t1)
        inside = tr.clip(tr.merge((s, e) for s, e, _ in trsm), t0, t1)
        out.update({
            "trsm_product_kernel": tr.short_name(product),
            "cupti_trsm_product_share": 100.0 * tr.total(named) / busy,
            "cupti_trsm_steps_share": 100.0 * tr.total(inside) / busy})
    return out


def stage_stats(spans: sp.ProgramSpans) -> Dict[str, dict]:
    """Per host stage: count, total seconds, median, 90th percentile and
    largest span in us."""
    by: Dict[str, List[float]] = {}
    for n, s, e, _ in spans.stages:
        by.setdefault(n, []).append(e - s)
    return {n: {"n": len(d), "total_s": sum(d) * 1e-6,
                "median_us": _percentile(d, 0.5),
                "p90_us": _percentile(d, 0.9), "max_us": max(d)}
            for n, d in sorted(by.items())}


def traced_window(ctx, one_pass, seconds: float, stages: Stages,
                  spans_on: bool, on_card: bool, chips: int = 1):
    """One traced window: (its passes, trace summary, program spans or
    None)."""
    from torch.profiler import ProfilerActivity, profile

    from parsec_tpu_torch.prof.causal import install_causal_tracer
    from parsec_tpu_torch.prof.profiling import Profile
    from parsec_tpu_torch.prof.reader import read_trace
    activities = [ProfilerActivity.CUDA] if on_card \
        else [ProfilerActivity.CPU]
    stages.spans.clear()
    prof = Profile("spancheck") if spans_on else None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=activities) as torch_prof:
            tracer = install_causal_tracer(ctx, prof,
                                           classes=("device", "stages")) \
                if spans_on else None
            gc.collect()
            gc.freeze()
            try:
                passes = run_window(one_pass, seconds, min_passes=2)
            finally:
                if tracer is not None:
                    tracer.uninstall(ctx)
    with tempfile.TemporaryDirectory(prefix="bm-spancheck-") as d:
        path = os.path.join(d, "trace.json")
        torch_prof.export_chrome_trace(path)
        del torch_prof
        events, base_ns = tr.load(path)
        program = None
        if prof is not None:
            meta, rows = read_trace(prof.dump(os.path.join(d, "p.ptt")))
            program = sp.from_profile(meta, rows, base_ns)
    summary = tr.summarize(events, tr.to_trace_clock(stages.spans, base_ns),
                           chips)
    return passes, summary, program


def run(cell: spec.Cell, seed: int, seconds: float, rounds: int,
        device: str = "cuda") -> dict:
    """Set up ``cell`` and run its traced windows in turns (see the module
    docstring); returns the JSON object."""
    from parsec_tpu_torch.core.context import Context
    on_card = device == "cuda"
    chips = cell.chips
    tdevs = [torch.device("cuda", i) for i in range(chips)] if on_card \
        else [torch.device("cpu")] * chips
    problem = spec.problem_module(cell.problem).Problem(
        cell.config, cell.traffic, seed, tdevs[0])
    stage = Stages()
    result: dict = {"cell": cell.name, "seed": seed,
                    "card": torch.cuda.get_device_name(tdevs[0]) if on_card
                    else "cpu", "windows": []}
    modules = device if on_card else f"cpu:{chips}"
    with Context(nb_cores=int(cell.config["workers"]), device=modules) as ctx:
        problem.place(list(ctx.device_registry.accelerators))

        def one_pass() -> bool:
            with stage(tr.PASS):
                with stage("bm.collect"):
                    gc.collect()
                with stage("bm.restore"):
                    problem.restore()
                with stage("bm.build_pool"):
                    tp = problem.make_pool()
                with stage("bm.add_taskpool"):
                    ctx.add_taskpool(tp)
                with stage("bm.wait"):
                    ctx.wait()
                with stage("bm.synchronize"):
                    if on_card:
                        for d in tdevs:
                            torch.cuda.synchronize(d)
            return problem.pass_failed(tp)

        failed = int(one_pass())
        order = [False, True, True, False] * rounds
        for spans_on in order[:2 * rounds]:
            passes, summary, program = traced_window(
                ctx, one_pass, seconds, stage, spans_on, on_card, chips)
            failed += sum(p.failed for p in passes)
            win = {"spans": spans_on, "passes": [p.seconds for p in passes],
                   "device_idle": 100.0 * (1 - summary.busy_s
                                           / summary.window_s)}
            if program is not None:
                win["readings"] = sp.readings(program, summary)
                win["gaps"] = sp.gap_names(summary, program)
                win["dev_spans"] = len(program.dev)
                win["clocks"] = sorted({c[4] for c in program.dev})
                win["stages"] = stage_stats(program)
                win["anchor_width_us"] = 1e6 * getattr(
                    ctx.device_registry.accelerators[0], "anchor_width_s",
                    0.0)
                if on_card:
                    win["agreement"] = agreement(summary, program)
            result["windows"].append(win)
            log(f"window spans {'on' if spans_on else 'off'}: "
                f"{json.dumps(win)}")
        result["failed"] = failed
        problem.release()
    gc.unfreeze()

    def mean_pass(on: bool) -> float:
        return statistics.fmean(s for w in result["windows"]
                                if w["spans"] == on for s in w["passes"])

    result["cost"] = {"pass_s_off": mean_pass(False),
                      "pass_s_on": mean_pass(True),
                      "on_over_off": mean_pass(True) / mean_pass(False)}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.spancheck")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if args.device == "cuda":
        cards.narrow(cell.chips)
        if not torch.cuda.is_available():
            print("needs a CUDA card (or --device cpu)", file=sys.stderr)
            return 2
    result = run(cell, args.seed, args.seconds, args.rounds, args.device)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
