"""Data parallelism over scenes (counterpart of ``grouptraj/parallel/``):
the process-group state, scene sharding and the global sums
(``mesh``), and a launcher with the rank functions the tests and
``chip_smoke.py`` run (``data_parallel``)."""
