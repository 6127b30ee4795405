"""Per-layer metrics, one file each, named as ``BENCHMARK.json`` names
them. A file declares ``LAYER``, ``MOVES`` (the end-to-end metric it
should move), ``SOURCE``, ``UNIT`` and ``BETTER``, and ``read(ctx)``,
which returns the number or None where the run gives it nothing to read
(the harness then leaves the metric out of the line). ``ctx`` is what a
driver hands over: ``arch`` (the configuration), ``rays_per_unit``,
``units`` and ``window_s`` of the timed window, ``trace`` (the reduced
trace of the traced window, ``nerfbench/trace.py``) and ``spans`` (the
system's own timings)."""
