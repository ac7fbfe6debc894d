"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Shows the process exactly the cell's cards, the first ``chips`` it would
otherwise see (``benchmark.cards``), before anything initialises CUDA.
Needs as many CUDA cards as the cell asks for; without them it exits 2 and
prints no result.  Standard output carries the passes' times, then the
result as its last line: one JSON object with ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``,
and last ``checks`` (each number compared against its limit, which also
end standard error).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _args(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    if args.seed < 0:
        print("--seed must be a whole number from 0 up", file=sys.stderr)
        return 2
    from benchmark import cards, guard, spec
    cell = spec.load_cell(args.workload)
    cards.narrow(cell.chips)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      t_start=T_START)
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"the run loaded forbidden modules: {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
