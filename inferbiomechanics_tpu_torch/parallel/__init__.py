"""Parallelism over processes, the counterpart of the JAX package's
``parallel/``: ``dist.py`` (the process group and its collectives),
``mesh.py`` (the JAX meshes' rank layouts), ``sharding_rules.py`` (the
model-parallel column split, a library no loop calls, as in the JAX
package) and ``pipeline.py`` (``--pipeline-parallel``: the GPipe step, one
rank a stage)."""
