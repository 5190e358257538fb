"""Fused MLP forward: one CUDA kernel for the whole layer chain.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/pallas_mlp.py``. The
kernel itself is ``csrc/fused_mlp.cu`` (it replaces the Pallas
``_fused_kernel``); this module holds its plain PyTorch version
(:func:`mlp_reference`), the one-time weight packing
(:func:`pack_mlp_params`) and the wrapper (:func:`fused_mlp_forward`).

Parameters keep the JAX package's layout at this module's public
functions: ``params = [(W [in, out], b [out]), ...]``.

:func:`fused_mlp_forward` launches the kernel for a CUDA tensor and uses
:func:`mlp_reference` only for a CPU tensor; any other device raises.
``launches`` counts the kernel launches in this process.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from inferbiomechanics_tpu_torch.ops import _build

ACTIVATIONS = {
    'relu': torch.relu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'gelu': lambda v: F.gelu(v, approximate='tanh'),   # jax.nn.gelu's default
    'elu': F.elu,
}
# ids of csrc/fused_mlp.cu's Activation enum
_ACT_IDS = {'relu': 0, 'tanh': 1, 'sigmoid': 2, 'gelu': 3, 'elu': 4}

# the kernel's limits: it holds the row tile's input and hidden activations
# in shared memory, which these keep under the 227 KB a block may use
# (see csrc/fused_mlp.cu)
MAX_LAYERS = 8
MAX_IN = 2048          # input width, after padding to 16
MAX_WIDTH = 1024       # hidden and output widths, after padding to 16

# kernel launches so far (for checking that a path went through the kernel)
launches = 0


def _round16(d: int) -> int:
    return (d + 15) // 16 * 16


def mlp_reference(x: torch.Tensor,
                  params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                  activation: str = 'sigmoid',
                  compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain version: x [B, C] -> [B, out] float32.

    The math of ``pallas_mlp.py::mlp_reference``: operands rounded to
    ``compute_dtype``, products summed in float32 with an f32 bias, the
    activation on every layer but the last, and ``h`` rounded back to
    ``compute_dtype`` after every layer, the last one too. The matmul runs
    in float32 on the rounded operands (exact products), so on a GPU it
    needs ``torch.backends.cuda.matmul.allow_tf32 = False``.
    """
    act = ACTIVATIONS[activation]
    h = x.to(compute_dtype)
    for i, (W, b) in enumerate(params):
        h = h.float() @ W.to(compute_dtype).float() + b.float()
        if i < len(params) - 1:
            h = act(h)
        h = h.to(compute_dtype)
    return h.float()


@dataclass(frozen=True)
class PackedMLP:
    """Weights padded, cast and laid out once for the kernel.

    ``weights``: bf16, every layer padded to ``[pdims[i], pdims[i+1]]`` and
    laid out in mma fragment order (:func:`fragment_order`), layers end to
    end; ``biases``: f32, padded, end to end. Padding is zero. ``layers``
    holds the unpadded ``(W bf16 [in, out], b f32)`` for the plain version.
    """
    weights: torch.Tensor
    biases: torch.Tensor
    dims: Tuple[int, ...]
    pdims: Tuple[int, ...]
    layers: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

    @property
    def device(self) -> torch.device:
        return self.weights.device


def fragment_order(w: torch.Tensor) -> torch.Tensor:
    """A padded ``[K, N]`` weight (K, N multiples of 16) in the order the
    kernel streams it: ``[N/16, K/16, 32 lanes, 8]``, flattened.

    For 16-column block ``nb`` and k-step ``ks``, lane ``g * 4 + c`` holds
    the B fragments of ``mma.m16n8k16`` for the block's two n8 tiles ``j``:
    register ``2 j + h`` packs ``W[16 ks + 8 h + 2 c + e, 16 nb + 8 j + g]``
    for e = 0, 1 (PTX ISA, "Matrix fragments for mma.m16n8k16").
    """
    k, n = w.shape
    return (w.reshape(k // 16, 2, 4, 2, n // 16, 2, 8)   # ks h c e nb j g
            .permute(4, 0, 6, 2, 5, 1, 3)                # nb ks g c j h e
            .reshape(-1))


def pack_mlp_params(params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    device) -> PackedMLP:
    """Pad every width to a multiple of 16 with zeros, cast W to bf16 and b
    to f32, lay W out in fragment order and place both on ``device``.

    Zero padding is exact: padded input columns meet zero weight rows,
    padded hidden columns (act(0), 0.5 for sigmoid) meet the next layer's
    zero rows, and padded output columns are never stored.
    """
    dims = [int(params[0][0].shape[0])] + [int(W.shape[1]) for W, _ in params]
    for (W, b), d0, d1 in zip(params, dims[:-1], dims[1:]):
        if tuple(W.shape) != (d0, d1) or tuple(b.shape) != (d1,):
            raise ValueError(f'layer shapes do not chain: W {tuple(W.shape)}, '
                             f'b {tuple(b.shape)} after width {d0}')
    pdims = [_round16(d) for d in dims]
    weights, biases, layers = [], [], []
    for (W, b), k, n, pk, pn in zip(params, dims[:-1], dims[1:],
                                    pdims[:-1], pdims[1:]):
        W = torch.as_tensor(W).to(device=device, dtype=torch.bfloat16)
        b = torch.as_tensor(b).to(device=device, dtype=torch.float32)
        wp = torch.zeros(pk, pn, dtype=torch.bfloat16, device=device)
        wp[:k, :n] = W
        weights.append(fragment_order(wp))
        biases.append(F.pad(b, (0, pn - n)))
        layers.append((W, b))
    return PackedMLP(torch.cat(weights), torch.cat(biases), tuple(dims),
                     tuple(pdims), tuple(layers))


def check_kernel_shape(pdims: Sequence[int]) -> None:
    """Raise if the kernel cannot take these padded widths."""
    n_layers = len(pdims) - 1
    if not 1 <= n_layers <= MAX_LAYERS:
        raise ValueError(f'fused MLP kernel takes 1..{MAX_LAYERS} layers, '
                         f'got {n_layers}')
    if pdims[0] > MAX_IN:
        raise ValueError(f'fused MLP kernel takes inputs up to {MAX_IN} wide, '
                         f'got {pdims[0]} (padded)')
    if max(pdims[1:]) > MAX_WIDTH:
        raise ValueError(f'fused MLP kernel takes layer widths up to '
                         f'{MAX_WIDTH}, got {max(pdims[1:])} (padded)')


def fused_mlp_forward(x: torch.Tensor, packed: PackedMLP,
                      activation: str = 'sigmoid') -> torch.Tensor:
    """x [B, C_in] float32 -> [B, C_out] float32 through the fused kernel.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`mlp_reference`; any other device raises.
    """
    global launches
    if x.device.type == 'cpu':
        return mlp_reference(x, packed.layers, activation)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_mlp_forward: no kernel for device {x.device}')
    if activation not in _ACT_IDS:
        raise ValueError(f'unknown activation {activation!r}')
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f'fused_mlp_forward takes a contiguous float32 '
                         f'[B, C] tensor, got {x.dtype} {tuple(x.shape)}')
    if x.shape[1] != packed.dims[0]:
        raise ValueError(f'input width {x.shape[1]} != packed width '
                         f'{packed.dims[0]}')
    if packed.device != x.device:
        raise ValueError(f'weights on {packed.device}, input on {x.device}')
    check_kernel_shape(packed.pdims)
    batch, c_out = x.shape[0], packed.dims[-1]
    out = torch.empty((batch, c_out), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    n_layers = len(packed.pdims) - 1
    pdims = (ctypes.c_int * len(packed.pdims))(*packed.pdims)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ib_fused_mlp_forward(
            x.data_ptr(), batch, x.shape[1], packed.weights.data_ptr(),
            packed.biases.data_ptr(), pdims, n_layers, out.data_ptr(), c_out,
            _ACT_IDS[activation], stream)
    _build.check(lib, code, 'fused_mlp_forward launch')
    launches += 1
    return out
