"""Shared model plumbing: packed-input handling and output-head slicing.

PyTorch counterpart of ``inferbiomechanics_tpu/models/common.py``. Models
take the 10 input streams either packed as one ``[B, T, C_in]`` tensor (as
the dataset serves them) or as a dict keyed by ``InputDataKeys`` in the
canonical concat order, and emit the 4 ground-contact output groups.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

from inferbiomechanics_tpu_torch.data import keys as K

ModelInput = Union[torch.Tensor, Dict[str, torch.Tensor]]
# masks(shape, p, device[, shared=True]) -> bool keep mask of that shape,
# True with probability 1 - p; ``shared``: one mask for the whole (global)
# batch (flax attention's broadcast dropout), not rows of the batch
MaskSource = Callable[..., torch.Tensor]


def pack_inputs(inputs: ModelInput) -> torch.Tensor:
    """Dict-of-streams -> packed [B, T, C_in]; passthrough if already packed."""
    if isinstance(inputs, dict):
        return torch.cat([inputs[k] for k in K.INPUT_CONCAT_ORDER], dim=-1)
    return inputs


def slice_output_heads(x: torch.Tensor, num_contact_bodies: int,
                       num_output_frames: int) -> Dict[str, torch.Tensor]:
    """Split a flat head vector into the 4 contact output groups.

    ``x`` is [B, num_output_frames * per_frame] or [B, F, per_frame]; the
    head is frame-major, each frame laid out as
    ``[CoPs 3nb | forces 3nb | torques 3nb | wrenches 6nb]``.
    """
    nb = num_contact_bodies
    per_frame = nb * (3 * 3 + 6)
    if x.ndim == 2:
        x = x.reshape(x.shape[0], num_output_frames, per_frame)
    c3, c6 = 3 * nb, 6 * nb
    return {
        K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME: x[..., 0:c3],
        K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME: x[..., c3:2 * c3],
        K.OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME: x[..., 2 * c3:3 * c3],
        K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME: x[..., 3 * c3:3 * c3 + c6],
    }


def output_head_size(num_contact_bodies: int, num_output_frames: int) -> int:
    return num_contact_bodies * (3 * 3 + 6) * num_output_frames


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax's lecun-normal in place: a normal truncated at two standard
    deviations, rescaled to the variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_linear(layer: nn.Linear, init_style: str,
                generator: Optional[torch.Generator]) -> None:
    """Fill ``layer`` from ``generator`` (on the CPU, so that a seed gives
    the same weights on every device): 'torch' is torch's own Linear init,
    'lecun' is flax's lecun-normal kernel with a zero bias."""
    fan_in = layer.in_features
    w = torch.empty(layer.weight.shape)
    b = torch.empty(layer.bias.shape)
    if init_style == 'torch':
        k = 1.0 / math.sqrt(fan_in)
        w.uniform_(-k, k, generator=generator)
        b.uniform_(-k, k, generator=generator)
    elif init_style == 'lecun':
        lecun_normal_(w, fan_in, generator)
        b.zero_()
    else:
        raise ValueError(f"init_style must be 'torch' or 'lecun', "
                         f"got {init_style!r}")
    with torch.no_grad():
        layer.weight.copy_(w)
        layer.bias.copy_(b)


def global_rows(draw: Callable[[Tuple[int, ...]], torch.Tensor], shape: Tuple[int, ...],
                shard: Optional[Tuple[int, int]]) -> torch.Tensor:
    """``draw(shape)``, or under data parallelism (``shard`` = (rank, world
    size)) the draw of the global batch, ``world`` times ``shape[0]`` rows,
    of which this rank keeps its own: the JAX package partitions one global
    noise tensor over its devices, so a rank's rows are those that one
    process at the global batch would draw for them."""
    if shard is None:
        return draw(tuple(shape))
    r, n = shard
    b = shape[0]
    return draw((b * n, *shape[1:]))[r * b:(r + 1) * b]


def generator_masks(generator: Optional[torch.Generator] = None,
                    shard: Optional[Tuple[int, int]] = None) -> MaskSource:
    """Keep masks drawn from ``generator`` (on the tensor's device), or from
    torch's default generator when it is None; under data parallelism
    (``shard``) a rank's rows of the global batch's masks
    (:func:`global_rows`), and a ``shared`` mask the same on every rank."""
    def masks(shape, p, device, shared=False):
        def draw(s):
            return torch.rand(s, generator=generator, device=device)
        return (draw(tuple(shape)) if shared else global_rows(draw, shape, shard)) >= p
    return masks


def dropout(x: torch.Tensor, p: float, masks: MaskSource) -> torch.Tensor:
    """flax's ``nn.Dropout`` at rate ``p`` in ``x``'s dtype: ``x / (1 - p)``
    where the mask keeps, 0 where it drops."""
    if p == 0.0:
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    keep = masks(tuple(x.shape), p, x.device)
    return torch.where(keep, x / (1.0 - p), torch.zeros((), dtype=x.dtype, device=x.device))
