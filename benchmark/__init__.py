"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

    python3 benchmark/run.py --workload echo.64mb --seed 7 --seconds 20 --trace 0

Everything is found by name (``harness/cell.py``):

- ``configs/<config>.json``: a deployment as it is run, its sizes and
  guarantees; ``deployments/<config>.py`` sets it up on the program
  (``incubator_brpc_tpu_torch``) and keeps what each call returned;
  ``reference/<config>.py`` is the plain PyTorch that judges it;
- ``traffic/<traffic>.json``: a traffic mix, a file of parameters read by
  the generator it names, ``traffic/<generator>.py``;
- ``workloads/<cell>.json``: the limits of the comparison that decides
  ``correct`` in that cell;
- ``metrics/<metric>.py``: one reader a metric, end-to-end or per layer.

A later cell, configuration or metric is new files and new entries of
``BENCHMARK.json``; no file here names a cell.
"""
