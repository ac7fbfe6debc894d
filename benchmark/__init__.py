"""The benchmark of ``parsec_tpu_torch`` on one NVIDIA H100.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for a fixed window and prints one JSON line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: the configuration's sizes in
``configs/<config>.json``, the cell's traffic in ``workloads/<cell>.json``,
the problem's driver in ``problems/<problem>.py``, its plain reference in
``reference/<problem>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  A new cell, configuration or metric is new files
and a new entry in ``BENCHMARK.json``; no file here needs an edit.

The yardstick lives in this folder and imports nothing of the program:
operand generators (``operands.py``), flop and byte counts (``work.py``),
the table of peaks (``peaks.py``), the window's arithmetic (``window.py``),
the trace reduction (``trace.py``) and the references.  From the program
the benchmark takes only the system under test, its counters and its
kernels' names.
"""
