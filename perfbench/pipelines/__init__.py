"""The program's pipelines the benchmark can run, one module each.

A configuration (perfbench/configs/<config>.json) names its pipeline under
``"pipeline"``; run.py imports ``perfbench.pipelines.<pipeline>`` and
drives the module's ``Pipeline`` class:

- ``Pipeline(config, traffic, scene_dir, views, seed, work, device, spans,
  overrides)`` writes its seeded checkpoints under ``work`` and builds the
  program for the configuration over the rendered scene (``views``, as
  perfbench/scene.py renders it; its files in Olsson's layout in
  ``scene_dir``). ``spans`` is the run's adapter.Spans; ``overrides``
  (dotted config keys) serve the CPU tests' small shapes.
- ``warm()``: every shape a pass uses, once, before the window.
- ``run_pass(seed) -> dict``: one whole pass with its own ``seed``; what it
  counted. Every pipeline counts ``views`` (the views the pass took in); a
  pipeline that verifies pairs counts ``pairs``. run.py reports
  ``<count>_per_s`` for each count over the window, except ``failed``
  (answers a pass did not give), which it sums into the result's
  ``failed``.
- ``counters() -> dict``: the program's path counters, read before and
  after the window (integers are printed as their difference).
- ``context() -> dict``: what the pipeline's per-layer readers need beyond
  the shared keys (spans, work, device, passes, config and the counts).
- ``close()``: drops the program's state before the check; keeps the last
  pass's outputs.
- ``check(params, control) -> (numbers, control numbers or None)``: the
  last pass held against the plain reference (``params`` is the cell's
  ``workloads/<cell>.json`` ``"check"``); with ``control``, also the
  reference one precision below in the program's place.
- ``ORDER`` (a class attribute): the names of the check's numbers, each
  with a limit in every cell's ``workloads/<cell>.json``; ``ATTEMPTED``:
  the count that is the result's ``attempted``; ``program``: the built
  object a CPU test's fault breaks.
"""
