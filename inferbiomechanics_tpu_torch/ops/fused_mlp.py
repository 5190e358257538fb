"""Fused MLP forward: one CUDA kernel for the whole layer chain.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/pallas_mlp.py``. The
kernel itself is ``csrc/fused_mlp.cu`` (it replaces the Pallas
``_fused_kernel``); this module holds its plain PyTorch version
(:func:`mlp_reference`), the one-time weight packing
(:func:`pack_mlp_params`), the choice of the launch's shape from the batch
(:func:`plan_mlp`: a small-batch kernel that spreads one forward's weights
over a cluster of eight blocks, a large-batch kernel of 64-row tiles) and
the wrapper (:func:`fused_mlp_forward`).

Parameters keep the JAX package's layout at this module's public
functions: ``params = [(W [in, out], b [out]), ...]``.

:func:`fused_mlp_forward` launches the kernel for a CUDA tensor and uses
:func:`mlp_reference` only for a CPU tensor; any other device raises.
``launches`` counts the kernel launches in this process.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops._layout import TILE, swizzled_tiles

ACTIVATIONS = {
    'relu': torch.relu,
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'gelu': lambda v: F.gelu(v, approximate='tanh'),   # jax.nn.gelu's default
    'elu': F.elu,
}
# ids of csrc/fused_mlp.cu's Activation enum
_ACT_IDS = {'relu': 0, 'tanh': 1, 'sigmoid': 2, 'gelu': 3, 'elu': 4}

# the kernel's limits: it holds a row tile's hidden activations in shared
# memory and a warpgroup's share of a layer's outputs in registers, which
# these keep within what a block has (see csrc/fused_mlp.cu, plan_mlp)
MAX_LAYERS = 8
MAX_IN = 2048          # input width, after padding to 64
MAX_WIDTH = 1024       # hidden and output widths, after padding to 64
MAX_SMEM = 232448      # bytes of shared memory a block may use

# the largest batch the small-batch kernel takes: on an H100 it is the faster
# of the two up to here and the slower at 512 rows, where its clusters of
# eight blocks, eight rows each, need five waves (ops/tune.py times both)
SMALL_BATCH_MAX = 256

# csrc/fused_mlp.cu's constants
_TILE_BYTES = TILE * TILE * 2
_SMALL_STAGE_COLS = 3 * TILE   # columns of x a staged chunk holds, small-batch kernel
_LARGE_STAGES = 3      # f32 chunks of x (64 columns) in flight in the large-batch kernel,
_LARGE_UNITS = 3       # and its bf16 operand panels of x
_MAX_DEPTH = 24        # weight tiles in the ring
_MIN_DEPTH = 4
_BAR_BYTES = 2048

# kernel launches so far (for checking that a path went through the kernel)
launches = 0


def _round_tile(d: int) -> int:
    return (d + TILE - 1) // TILE * TILE


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
    laid out as swizzled 64 x 64 tiles (``_layout.swizzled_tiles``), layers
    end to end; ``biases``: f32, padded, end to end. Padding is zero.
    ``layers`` holds the unpadded ``(W bf16 [in, out], b f32)`` for the
    plain version.
    """
    weights: torch.Tensor
    biases: torch.Tensor
    dims: Tuple[int, ...]
    pdims: Tuple[int, ...]
    layers: Tuple[Tuple[torch.Tensor, torch.Tensor], ...]

    @property
    def device(self) -> torch.device:
        return self.weights.device


def fold_norm(W: torch.Tensor, b: torch.Tensor, s: torch.Tensor,
              t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Dense layer ``h -> h W + b`` after the affine map ``h -> h * s +
    t`` (an eval BatchNorm) as one layer: ``W' = diag(s) W`` and ``b' = b +
    t W``, in float32 (``t W`` summed in float64, so that no TF32 product
    enters)."""
    W = W.float()
    folded = (t.double()[:, None] * W.double()).sum(0)
    return s.float()[:, None] * W, (b.double() + folded).float()


def pack_mlp_params(params: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    device, norms: Optional[Sequence] = None) -> PackedMLP:
    """Pad every width to a multiple of 64 with zeros, cast W to bf16 and b
    to f32, lay W out as swizzled tiles and place both on ``device``.

    ``norms[i]``, when given and not None, is the affine map ``(s, t)`` that
    precedes layer ``i`` at eval (a BatchNorm's, ``h -> h * s + t``); it is
    folded into the layer (:func:`fold_norm`) before the cast, so the kernel
    and the plain version run the folded layers.

    Zero padding is exact: padded input columns meet zero weight rows,
    padded hidden columns (act(0), 0.5 for sigmoid) meet the next layer's
    zero rows, and padded output columns are never stored.
    """
    dims = [int(params[0][0].shape[0])] + [int(W.shape[1]) for W, _ in params]
    for (W, b), d0, d1 in zip(params, dims[:-1], dims[1:]):
        if tuple(W.shape) != (d0, d1) or tuple(b.shape) != (d1,):
            raise ValueError(f'layer shapes do not chain: W {tuple(W.shape)}, '
                             f'b {tuple(b.shape)} after width {d0}')
    if norms is not None:
        if len(norms) != len(params):
            raise ValueError(f'{len(norms)} norms for {len(params)} layers')
        params = [(W, b) if norm is None else fold_norm(W, b, *norm)
                  for (W, b), norm in zip(params, norms)]
    pdims = [_round_tile(d) for d in dims]
    weights, biases, layers = [], [], []
    for (W, b), k, n, pk, pn in zip(params, dims[:-1], dims[1:],
                                    pdims[:-1], pdims[1:]):
        W = torch.as_tensor(W).to(device=device, dtype=torch.bfloat16)
        b = torch.as_tensor(b).to(device=device, dtype=torch.float32)
        wp = torch.zeros(pk, pn, dtype=torch.bfloat16, device=device)
        wp[:k, :n] = W
        weights.append(swizzled_tiles(wp))
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


@dataclass(frozen=True)
class MlpPlan:
    """The launch :func:`plan_mlp` chose: ``kernel`` (``'small'`` or
    ``'large'``), the batch rows of a tile, the blocks of the cluster that
    shares a tile, the weight tiles in the ring, the columns of a staged
    chunk of x and the bytes between chunks, the f32 chunks in the staging ring and the chunks in the ring
    of bf16 panels, and the byte offsets of the block's
    shared memory (from its 1024-aligned start, which the barriers take:
    the hidden activations of even and of odd layers, the staging of x, its
    panels, the small-batch kernel's exchange of partial sums, the weight
    ring)."""
    kernel: str
    rows: int
    cluster: int
    depth: int
    stage_cols: int
    stage_bytes: int
    stages: int
    units: int
    off_h0: int
    off_h1: int
    off_stage: int
    off_panel: int
    off_red: int
    off_ring: int
    smem_bytes: int

    def as_ints(self) -> Tuple[int, ...]:
        return (self.rows, self.cluster, self.depth, self.stage_cols,
                self.stage_bytes, self.stages, self.units,
                self.off_h0, self.off_h1, self.off_stage, self.off_panel,
                self.off_red, self.off_ring, self.smem_bytes)


def _round_kb(n: int) -> int:
    return (n + 1023) // 1024 * 1024


def plan_mlp(batch: int, pdims: Sequence[int]) -> MlpPlan:
    """Which of the two kernels takes ``batch`` rows of a chain of padded
    widths ``pdims``, and its shared-memory layout; a function of these
    alone. Raises if the kernel cannot take the widths.

    Up to :data:`SMALL_BATCH_MAX` rows: tiles of 8 rows, a cluster of 8
    blocks a tile, each pulling an eighth of every layer's weights, the two
    consumer warpgroups splitting K; all of x is staged at once. Above:
    tiles of 64 rows (32 when a layer is wider than 512, so that both
    activation buffers fit the shared memory and a warpgroup's share of a
    layer its registers), a cluster of 2 blocks a tile, x streamed in chunks
    of 64 columns, three in flight.

    The hidden activations of even and of odd layers each have a buffer as
    wide as the widest of them; the staging of x lies in the odd layers'
    buffer when that is large enough (the first layer writes the even one),
    and whatever is left holds the weight ring.
    """
    check_kernel_shape(pdims)
    hidden = list(pdims[1:-1])
    if batch <= SMALL_BATCH_MAX:
        kernel, rows, cluster = 'small', 8, 8
        stage_cols = _SMALL_STAGE_COLS
        stages = units = -(-pdims[0] // stage_cols)
        red_bytes = 2 * (rows // 2) * 128 * 4     # two column blocks a warpgroup
    else:
        kernel, rows, cluster = 'large', (64 if max(pdims[1:]) <= 512 else 32), 2
        stage_cols, stages, units, red_bytes = TILE, _LARGE_STAGES, _LARGE_UNITS, 0
    h_bytes = [rows * 2 * max(hidden[i::2], default=0) for i in (0, 1)]
    # a staged row holds 4 floats more (the TMA boxes start at 16-byte
    # boundaries), and each of up to 4 boxes is padded to 128 bytes
    stage_bytes = _round_kb(rows * (stage_cols + 4) * 4 + 4 * 128)
    staging = stages * stage_bytes
    off_h0 = _BAR_BYTES
    off_h1 = off_h0 + h_bytes[0]
    end = off_h1 + h_bytes[1]
    if h_bytes[1] >= staging:
        off_stage = off_h1
    else:
        off_stage, end = end, end + staging
    off_panel = end
    off_red = off_panel + units * rows * stage_cols * 2
    off_ring = off_red + _round_kb(red_bytes)
    # 1024 bytes of slack to align the start
    depth = min(_MAX_DEPTH, (MAX_SMEM - 1024 - off_ring) // _TILE_BYTES)
    if depth < _MIN_DEPTH:
        raise ValueError(f'fused MLP kernel: widths {tuple(pdims)} leave no '
                         f'room for the weight ring in the {MAX_SMEM} bytes of '
                         f'shared memory a block may use')
    return MlpPlan(kernel, rows, cluster, depth, stage_cols, stage_bytes, stages, units, off_h0, off_h1,
                   off_stage, off_panel, off_red, off_ring,
                   off_ring + depth * _TILE_BYTES + 1024)


def fused_mlp_forward(x: torch.Tensor, packed: PackedMLP,
                      activation: str = 'sigmoid') -> torch.Tensor:
    """x [B, C_in] float32 -> [B, C_out] float32 through the fused kernel.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`mlp_reference`; any other device raises. While ``torch.export``
    traces, the call is the ``ib_torch::fused_mlp`` operator
    (``ops/library.py``), which an exported program keeps.
    """
    global launches
    if torch.compiler.is_exporting():
        from inferbiomechanics_tpu_torch.ops import library
        return library.mlp(x, packed, activation)
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
    if x.data_ptr() % 16:
        raise ValueError('fused_mlp_forward takes an input that is 16-byte aligned')
    if packed.device != x.device:
        raise ValueError(f'weights on {packed.device}, input on {x.device}')
    batch, c_out = x.shape[0], packed.dims[-1]
    plan = plan_mlp(batch, packed.pdims)
    out = torch.empty((batch, c_out), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    n_layers = len(packed.pdims) - 1
    pdims = (ctypes.c_int * len(packed.pdims))(*packed.pdims)
    plan_ints = (ctypes.c_int * 14)(*plan.as_ints())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ib_fused_mlp_forward(
            x.data_ptr(), batch, x.shape[1], packed.weights.data_ptr(),
            packed.biases.data_ptr(), pdims, n_layers, out.data_ptr(), c_out,
            _ACT_IDS[activation], plan_ints, stream)
    _build.check(lib, code, 'fused_mlp_forward launch')
    launches += 1
    return out
