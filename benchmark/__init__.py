"""The benchmark of ``parsec_tpu_torch`` on NVIDIA H100s: one card a cell,
or four of one host where the cell asks for them.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) for a fixed window and prints one JSON line:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: the configuration's sizes in
``configs/<config>.json``, the cell's traffic in ``workloads/<cell>.json``,
the problem's driver in ``problems/<problem>.py``, its plain reference in
``reference/<problem>.py`` and each per-layer metric's reader in
``metrics/<metric>.py``.  A new cell, configuration or metric is new files
and a new entry in ``BENCHMARK.json``; no file here needs an edit, for a
cell of several cards too.  A run sees exactly the cell's cards
(``cards.py``) and hands all of them to the problem and the reference;
the peak floor scales with their number; device busy and idle time,
memory, the SM clock and the device modules' counters are read card by
card, with the ICI engine's counters of the traffic between cards.

The yardstick lives in this folder and imports nothing of the program:
operand generators (``operands.py``), flop and byte counts (``work.py``),
the table of peaks (``peaks.py``), the window's arithmetic (``window.py``),
the trace reduction (``trace.py``) and the references.  From the program
the benchmark takes only the system under test, its counters and its
kernels' names.
"""
