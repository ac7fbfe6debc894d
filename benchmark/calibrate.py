"""Readings that the correctness limits are set from, on the card, in one
process: the program's numbers on many seeds (each a set-up, one timed
pass and the reference's check), the control's (the reference in fp8 in
the program's place) on a few, and the program's with a fault planted in
its timed path (``benchmark.faults``) on a few.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 --faults unchanged,half --fault-seeds 1,2,3

Prints one JSON line a reading: {"seed", "side": "program"|"control"|
"fault:<kind>", numbers...}.  The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from benchmark import cards, faults, spec
from benchmark.harness import run_cell


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    cards.narrow(cell.chips)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"calibrate needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2

    def program(seed: int, side: str) -> None:
        t = time.perf_counter()
        try:
            r = run_cell(cell, seed, 0.0, False,
                         out=lambda s: print(s, file=sys.stderr))
            reading = {"correct": r["correct"], "failed": r["failed"],
                       **{k: c["value"] for k, c in r["checks"].items()},
                       "seconds": time.perf_counter() - t}
        except RuntimeError as e:
            # a run that raises prints no result: it is not correct
            reading = {"correct": False, "error": str(e)}
        # a run that raised left its set-up's objects frozen
        gc.unfreeze()
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "side": side, **reading}),
              flush=True)

    for seed in _seeds(args.seeds):
        program(seed, "program")
    for kind in [k for k in args.faults.split(",") if k]:
        for seed in _seeds(args.fault_seeds):
            with faults.planted(kind):
                program(seed, f"fault:{kind}")
    ref = spec.reference_module(cell.problem)
    tdevs = [torch.device("cuda", i) for i in range(cell.chips)]
    for seed in _seeds(args.control_seeds):
        t = time.perf_counter()
        nums = ref.control(cell.config, cell.traffic, seed, tdevs)
        print(json.dumps({"seed": seed, "side": "control", **nums,
                          "seconds": time.perf_counter() - t}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
