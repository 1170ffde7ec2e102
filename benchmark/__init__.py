"""The benchmark of ``sparse_linear_assignment_tpu_torch`` on NVIDIA cards.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once and prints one JSON line.  Everything
that belongs to one item sits in a file of its own, found by the name
that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: a deployment (instance law, sides, source);
- ``workloads/<cell>.json``: a cell (its configuration, generator, entry
  adapter, batch, pool and traffic parameters);
- ``gen/<generator>.py``: a frozen traffic generator, seeded on the device;
- ``entries/<entry>.py``: the adapter that drives one entry point;
- ``metrics/<metric>.py``: the reader of one per-layer metric;
- ``reference/``: the plain reference that decides ``correct``.

Nothing here imports JAX or the JAX package, and ``reference/`` imports
nothing of the program.
"""
