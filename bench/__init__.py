"""The port's benchmark: one cell of ``BENCHMARK.json`` per run.

``python3 bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` serves the cell's configuration (``configs/``) under its
traffic mix (``traffic/``) through ``repro_torch``'s serving front end,
checks the served logits against the plain reference (``reference/``)
and prints one JSON line.  Per-layer metrics are read by the files of
``metrics/``, found by name.
"""
