"""inferbiomechanics_tpu_torch: the PyTorch/CUDA port of inferbiomechanics_tpu.

The JAX package beside it stays the reference; each ported module names
its JAX counterpart by file and is held against it in ``tests/test_torch_*``.
The port imports torch and never jax, flax or optax, and nothing of the JAX
package: it keeps its own copy of what it needs from there (``config``,
``data``, the HTTP layer in ``serve``).

- ``config``: the flag schema (same flags and defaults as the JAX package).
- ``data``:   the subject store, window dataset and synthetic subjects.
- ``ops``:    the fused MLP and fused encoder-layer kernels (CUDA C++ for
              Hopper, ``ops/csrc``), their plain PyTorch versions, the build.
- ``models``: the feedforward model, GroundLink, the transformer and the
              diffusion denoiser with its DDIM sampler.
- ``train``:  model construction and checkpoints (serving subset).
- ``serve``:  the batch-inference service, dynamic batcher and HTTP layer.
- ``cli``:    ``python -m inferbiomechanics_tpu_torch serve``.
"""
