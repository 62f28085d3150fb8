"""The benchmark of ``repro_torch``: VLA fleets served by split co-inference.

One run serves one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the card for a fixed number of seconds and prints one JSON
line.  Everything that belongs to one configuration, traffic mix, cell or
metric is a file of its own under this folder, found by name
(``catalog.py``):

- ``configs/<config>.json``: the model configuration as it is run, with
  its ``family``;
- ``families/<family>.py``: what a request carries, drawn from the seed,
  and the comparison with the family's plain reference;
- ``traffic/<traffic>.json``: the clients, their ``loop``, the
  ``server`` and the plan or controller that serves them;
- ``servers/<server>.py``: how the program serves one step;
- ``loops/<loop>.py``: how requests arrive and the window is paced;
- ``limits/<cell>.json``: the limits of the comparison that decides
  ``correct``, with the readings they were set from;
- ``metrics/<metric>.py``: one reader per metric.

The yardstick lives here too and imports nothing of the program: the plain
float32 reference (``reference/``), the work counts and the data-sheet
peaks (``work.py``), exact statistics (``stats.py``), the reading of the
profiler trace (``devtrace.py``) and a frozen copy of the bandwidth trace
generator (``netrace.py``).

Run from the root of a checkout::

    python3 -m ecc_bench.run --workload vla7b-vitl-detok.fleet32-int8 \\
        --seed 7 --seconds 30 --trace 0
"""
