"""The benchmark's shared machinery: the catalogue of cells and metrics
(``spec.py``), the seeded inputs (``inputs.py``), the program's set-up
(``program.py``), the profiler's reading (``trace.py``) and the
comparison that decides ``correct`` (``check.py``)."""
