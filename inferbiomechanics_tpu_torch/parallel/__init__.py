"""Data parallelism over processes (``parallel/dist.py``), the counterpart
of the JAX package's ``parallel/mesh.py``. ``pipeline.py`` is not ported
(ROADMAP.md, not to port); ``sharding_rules.py``, the model-parallel column
split, waits for ROADMAP.md Queue 1 item 8c."""
