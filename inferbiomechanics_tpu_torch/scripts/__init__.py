"""The port's learning-quality studies: the counterparts of the JAX
package's ``scripts/parity_rmse.py`` and ``scripts/anchor_quality.py``,
trained through the port's own entry points on the same synthetic split,
batch schedule and scoring."""
