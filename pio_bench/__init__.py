"""The benchmark of ``predictionio_tpu_torch`` on one NVIDIA H100.

``run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>`` runs one
cell of ``BENCHMARK.json`` and prints one JSON object as its last line.
Everything that belongs to one configuration, traffic mix, entry or metric
sits in a file of its own, found by name:

- ``configs/<config>.json``: the sizes of a deployment (the file named in
  ``BENCHMARK.json``);
- ``traffic/<traffic>.json``: the entry the window drives, how the events
  are drawn and how the check samples the answers;
- ``entries/<entry>.py``: builds the program's inputs and runs one step;
- ``metrics/<metric>.py``: one reader a metric, returning a number or None;
- ``limits/<workload>.json``: the limit of each number the check compares,
  with the readings it was set from.

The yardstick lives here too: the generator (``gen.py``), the published
peaks and the operation and byte counts (``counts.py``), the reduction of a
profiler trace (``trace.py``), the plain reference (``reference.py``) and the
comparison that decides ``correct`` (``check.py``).  Nothing here imports
``jax`` or the JAX package; the program under test is imported only by the
entries.
"""
