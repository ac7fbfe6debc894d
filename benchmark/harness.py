"""One run of one cell: set-up, the timed window, the traced passes, the
check against the plain reference, and the result line's object."""

from __future__ import annotations

import gc
import os
import sys
import tempfile
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional, Tuple

import torch

from benchmark import cards, peaks, readers, spec
from benchmark import trace as tr
from benchmark.window import Pass, check_peak, run_window, window_rate

#: the traced passes last at least this long, and are at least two
TRACE_SECONDS = 4.0
#: seconds between two SM clock readings beside the traced passes
SMI_PERIOD_S = 1.0


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class ClockSampler:
    """Reads the SM clock of each card in ``ids`` (``nvidia-smi -i``
    names) with ``nvidia-smi`` every ``period`` seconds on a thread of its
    own while the ``with`` block runs."""

    def __init__(self, ids: List[str], period: float = SMI_PERIOD_S):
        self.ids, self.period = ids, period
        self.mhz: List[float] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self._stop.wait(self.period):
            for out in peaks.smi_lines("clocks.sm", self.ids):
                self.mhz.append(float(out.split()[0]))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def _counters(devs, ici) -> Tuple[Dict[str, float], List[Dict[str, float]]]:
    """(the modules' ``DeviceStats`` summed, with the ICI engine's counters
    as ``ici.<name>`` where there is one; each module's)."""
    by_card = [d.stats.as_dict() for d in devs]
    total = {k: sum(c[k] for c in by_card) for k in by_card[0]}
    if ici is not None:
        total.update({f"ici.{k}": v for k, v in ici.stats.as_dict().items()})
    return total, by_card


def _deltas(c0: Dict[str, float], c1: Dict[str, float]) -> Dict[str, float]:
    return {k: c1[k] - c0[k] for k in c0}


class Stages:
    """Wall-clock stamps of the passes and their stages: (name, start ns,
    end ns), in the clock the profiler puts device activity on."""

    def __init__(self):
        self.spans: List[tuple] = []

    @contextmanager
    def __call__(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def mean_ms(self, names) -> Dict[str, float]:
        """Mean host milliseconds a pass spent in each stage."""
        passes = sum(1 for n, _, _ in self.spans if n == tr.PASS) or 1
        return {n: sum(e - s for m, s, e in self.spans if m == n) / 1e6
                / passes for n in names}


def _traced(one_pass: Callable[[], bool], seconds: float, stages: Stages,
            clock: Optional[ClockSampler], chips: int):
    """Passes under ``torch.profiler`` (device activity alone, every
    card's; on the CPU, which has none, its host operations) for at least
    ``seconds`` and two passes, with ``clock`` reading the SM clock beside
    them: (passes, trace summary over the run's ``chips`` cards)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else [ProfilerActivity.CPU]
    stages.spans.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=activities) as prof:
            # what starting the profiler made (its modules, its objects)
            # joins the set-up's objects outside the collector's reach, so
            # the passes' collections stay as short as in the window
            gc.collect()
            gc.freeze()
            if clock is None:
                passes = run_window(one_pass, seconds, min_passes=2)
            else:
                with clock:
                    passes = run_window(one_pass, seconds, min_passes=2)
    with tempfile.TemporaryDirectory(prefix="bm-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        events, base_ns = tr.load(path)
    return passes, tr.summarize(events, tr.to_trace_clock(stages.spans,
                                                          base_ns), chips)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None,
             out: Callable[[str], None] = print) -> dict:
    """Run ``cell`` once; return the result line's object.  ``device``
    "cpu" runs the program on as many CPU-backed modules as the cell has
    cards (tests only).  On the card the process sees exactly the cell's
    cards (``cards.narrow``), one device module each."""
    if t_start is None:
        t_start = time.perf_counter()
    on_card = device == "cuda"
    chips = cell.chips
    tdevs = [torch.device("cuda", i) for i in range(chips)] if on_card \
        else [torch.device("cpu")] * chips
    problem = spec.problem_module(cell.problem).Problem(
        cell.config, cell.traffic, seed, tdevs[0])
    card = torch.cuda.get_device_name(tdevs[0]) if on_card else "cpu"
    pk = peaks.peaks_for(card)
    from parsec_tpu_torch.core.context import Context

    log_passes: List[Pass] = []
    stage = Stages()
    modules = device if on_card else f"cpu:{chips}"

    with Context(nb_cores=int(cell.config["workers"]), device=modules) as ctx:
        devs = list(ctx.device_registry.accelerators)
        if len(devs) != chips:
            raise RuntimeError(
                f"cell {cell.name} runs on {chips} card(s); the Context "
                f"attached {len(devs)} device modules")
        problem.place(devs)

        def sync() -> None:
            if on_card:
                for d in tdevs:
                    torch.cuda.synchronize(d)

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
                    sync()
            return problem.pass_failed(tp)

        warm_failed = one_pass()
        sync()
        setup_s = time.perf_counter() - t_start
        if on_card:
            from parsec_tpu_torch.apps import cuda_kernels
            out(f"set-up {setup_s:.3f} s, of it the K1/K2 library's build "
                f"{cuda_kernels.last_build_seconds:.3f} s (0 where it was "
                f"found built)")
        log(f"set-up {setup_s:.3f} s (warm pass included)")
        gc.collect()
        gc.freeze()

        stage.spans.clear()
        c0, c0_by = _counters(devs, ctx.ici)
        passes = run_window(one_pass, seconds)
        c1, c1_by = _counters(devs, ctx.ici)
        log_passes += passes
        for p in passes:
            check_peak(p, problem.flops_per_pass, pk[problem.k1_dtype],
                       chips)
        rate, window_s, good = window_rate(passes, problem.flops_per_pass)
        for i, p in enumerate(passes):
            out(f"pass {i} {p.seconds:.6f} s{' FAILED' if p.failed else ''}")
        out(f"window {window_s:.6f} s, {len(passes)} passes, "
            f"{rate / 1e12:.4f} TFLOP/s")
        out("host ms a pass by stage: " + ", ".join(
            f"{n} {v:.3f}" for n, v in
            stage.mean_ms((tr.PASS,) + tr.STAGES).items()))
        summary, clock = None, None
        smi_ids = cards.smi_ids(chips) if on_card else []
        if trace:
            clock = ClockSampler(smi_ids) if on_card else None
            t_passes, summary = _traced(one_pass, min(seconds, TRACE_SECONDS),
                                        stage, clock, chips)
            log_passes += t_passes
            out(f"traced {summary.passes} passes over "
                f"{summary.window_s:.6f} s, device busy "
                f"{summary.busy_s:.6f} s; host ms a pass by stage: " +
                ", ".join(f"{n} {v:.3f}" for n, v in
                          stage.mean_ms((tr.PASS,) + tr.STAGES).items()))
        outputs = problem.outputs()
        sync()
        mem_by_card = [torch.cuda.max_memory_allocated(d) if on_card else 0
                       for d in tdevs]
        problem.release()
    gc.unfreeze()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
        for i, name in enumerate(smi_ids):
            out(f"card {i} {peaks.smi('name,power.limit', name)}; peaks "
                f"{pk[problem.k1_dtype]:.4g} FLOP/s ({problem.k1_dtype}), "
                f"{pk['bytes']:.4g} B/s")

    counters = _deltas(c0, c1)
    counters_by_card = [_deltas(a, b) for a, b in zip(c0_by, c1_by)]
    obs = readers.Observation(
        problem=problem, setup_s=setup_s, rate_flops=rate,
        counters=counters, counters_by_card=counters_by_card,
        smi_mhz=clock.mhz if clock is not None else [],
        trace=summary, peaks=pk)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"])(obs)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    ref = spec.reference_module(cell.problem)
    t_ref = time.perf_counter()
    checks = ref.check(cell.config, cell.traffic, seed, tdevs, outputs)
    del outputs
    log(f"reference check {time.perf_counter() - t_ref:.3f} s")
    limits = cell.limits
    failed = warm_failed + sum(p.failed for p in log_passes)
    correct = failed == 0 and all(
        checks[k] <= limits[k] for k in limits)
    result = {
        "correct": bool(correct),
        "attempted": 1 + len(log_passes),
        "failed": int(failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": card,
                   "count": chips, "memory_peak_bytes": int(max(mem_by_card)),
                   "memory_peak_bytes_by_card": [int(m) for m in mem_by_card]},
    }
    if summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["busy_s_by_card"] = summary.busy_s_by_card
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(summary),
                               "idle_gaps": tr.top_gaps(summary)}
    result["counters"] = counters
    result["counters_by_card"] = counters_by_card
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    return result
