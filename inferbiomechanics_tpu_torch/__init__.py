"""inferbiomechanics_tpu_torch: the PyTorch/CUDA port of inferbiomechanics_tpu.

The JAX package beside it stays the reference; each ported module names
its JAX counterpart by file and is held against it in ``tests/test_torch_*``.
The port imports torch and never jax, flax or optax. It shares the JAX
package's jax-free parts (config schema, data layer, HTTP layer) through
``shared.py``.

- ``ops``:    the fused MLP kernel (CUDA C++ for Hopper, ``ops/csrc``),
              its plain PyTorch version and the build.
- ``models``: the feedforward model.
- ``train``:  model construction and checkpoints (serving subset).
- ``serve``:  the batch-inference service behind the shared HTTP layer.
- ``cli``:    ``python -m inferbiomechanics_tpu_torch serve``.
"""
