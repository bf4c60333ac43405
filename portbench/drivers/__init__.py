"""One module per kind of traffic: ``drivers/<kind>.py``, named by the
traffic file's ``driver``.  Each has ``Program(run)`` (set-up: weights,
state, warm-up), ``Program.one(i)`` (one timed request or step),
``Program.counters()``, ``Program.outputs(sample)`` (what the window
produced, for the check), ``sample(run, n)``, ``control(run, sample)``
(the reference in the lower precision, in the program's place) and
``judge(run, outputs)`` (the numbers against the float32 reference)."""
