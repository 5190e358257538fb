"""The parts of ``inferbiomechanics_tpu`` that the port shares, not copies.

These modules of the JAX package import no jax, flax or optax, so the port
uses them as they are:

- ``inferbiomechanics_tpu/config.py``: the one flag schema;
- ``inferbiomechanics_tpu/data/`` (keys, dataset, synthetic; not
  ``loader.py``): the subject store and window layouts;
- the HTTP layer of ``inferbiomechanics_tpu/serve.py``: ``serve`` (the
  server and its request handler, with the payload codecs) and the dynamic
  batcher. ``serve.py`` imports jax only inside its ``InferenceService``'s
  methods, which the port does not use: it has its own service.

Every other module of the port imports them from here, so this file is the
whole boundary between the two packages. :data:`JAX_FREE_MODULES` lists
every module of the JAX package that the port may load;
``tests/test_torch_imports.py`` holds the port and ``chip_smoke.py`` to it.
"""

from inferbiomechanics_tpu.config import (  # noqa: F401
    Config, add_config_flags, config_from_args,
)
from inferbiomechanics_tpu.data import keys  # noqa: F401
from inferbiomechanics_tpu.data.dataset import (  # noqa: F401
    WindowDataset, input_layout,
)
from inferbiomechanics_tpu.data.synthetic import (  # noqa: F401
    write_synthetic_subject,
)
from inferbiomechanics_tpu.serve import (  # noqa: F401
    _DynamicBatcher as DynamicBatcher,
    serve,
)

# the modules of the JAX package that the port may load, at import or while
# it serves; none of them imports jax, flax or optax (``data/loader.py``
# does, and is not among them)
JAX_FREE_MODULES = frozenset(
    ['inferbiomechanics_tpu', 'inferbiomechanics_tpu.config',
     'inferbiomechanics_tpu.serve', 'inferbiomechanics_tpu.data']
    + [f'inferbiomechanics_tpu.data.{m}' for m in (
        'b3d', 'b3d_infer', 'b3d_legacy', 'dataset', 'keys', 'native',
        'osim', 'pickled', 'synthetic')])
