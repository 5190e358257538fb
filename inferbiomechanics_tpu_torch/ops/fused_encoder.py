"""Fused transformer encoder layer: one CUDA kernel for the whole layer.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/pallas_encoder.py``. The
kernel itself is ``csrc/fused_encoder.cu`` (it replaces the Pallas
``encoder_layer_pallas``, both of its kernel versions); this module holds
its plain PyTorch version (:func:`encoder_layer_reference`), the one-time
weight packing (:func:`pack_encoder_params`) and the wrapper
(:func:`fused_encoder_layer`).

One pre-LN layer: LayerNorm -> QKV projection -> softmax attention over the
window's T frames, per head -> output projection -> residual -> LayerNorm ->
MLP (GELU, tanh form) -> residual. Parameters keep the JAX package's layout
at this module's public functions: a flat tuple in :data:`PARAM_NAMES`
order, kernels ``[in, out]``, the ``3 d`` QKV columns ordered
``[q | k | v]``, each ``[H, dh]``.

:func:`fused_encoder_layer` launches the kernel for a CUDA tensor and uses
:func:`encoder_layer_reference` only for a CPU tensor; any other device
raises. ``launches`` counts the kernel launches in this process. There is
no backward: it comes with transformer training.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops.fused_mlp import fragment_order

# parameter order of the flat tuple interface
PARAM_NAMES = ('ln1_scale', 'ln1_bias', 'wqkv', 'bqkv', 'wproj', 'bproj',
               'ln2_scale', 'ln2_bias', 'wmlp1', 'bmlp1', 'wmlp2', 'bmlp2')
_WEIGHTS = (2, 4, 8, 10)          # indices of the four kernels in PARAM_NAMES
_ROWS = (0, 1, 3, 5, 6, 7, 9, 11)  # ... and of the eight f32 rows

LN_EPS = 1e-6

# the kernel's limits (csrc/fused_encoder.cu): a block holds 1..3 mma row
# tiles of 16 rows, whole windows only, in the shared memory a block may use
MAX_FRAMES = 48
MAX_SMEM = 232448
_MAX_ROW_TILES = 3
_PAD = 8

# kernel launches so far (for checking that a path went through the kernel)
launches = 0


def init_encoder_params(generator: Optional[torch.Generator], d_model: int,
                        mlp_ratio: int = 4) -> Tuple[torch.Tensor, ...]:
    """LeCun-normal weights / zero biases / unit LN, as a flat tuple (f32,
    on the CPU), drawn from ``generator``."""
    d, m = d_model, d_model * mlp_ratio

    def lecun(fan_in: int, fan_out: int) -> torch.Tensor:
        # variance 1 / fan_in, truncated at two standard deviations
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.empty(fan_in, fan_out)
        return torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                           generator=generator)

    return (torch.ones(d), torch.zeros(d),
            lecun(d, 3 * d), torch.zeros(3 * d),
            lecun(d, d), torch.zeros(d),
            torch.ones(d), torch.zeros(d),
            lecun(d, m), torch.zeros(m),
            lecun(m, d), torch.zeros(d))


def _dot(y: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Operands rounded to ``compute_dtype``, products summed in f32 (the
    products of two bf16 values are exact in f32). On a GPU this needs
    ``torch.backends.cuda.matmul.allow_tf32 = False``."""
    return y.to(compute_dtype).float() @ w.to(compute_dtype).float()


def encoder_layer_reference(x: torch.Tensor, params: Sequence[torch.Tensor],
                            num_heads: int,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> torch.Tensor:
    """Plain version; x [B, T, d] float32 -> [B, T, d] float32.

    The math of ``pallas_encoder.py::encoder_layer_reference``: LayerNorm
    in f32 (eps 1e-6, biased variance); the matmul operands rounded to
    ``compute_dtype``, summed in f32, with an f32 bias added after; q scaled
    by ``dh**-0.5`` after its bias; scores, softmax over the key frames and
    the value mix in f32; GELU in its tanh form, in f32; an f32 residual
    stream.
    """
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.float() for p in params)
    b, t, d = x.shape
    dh = d // num_heads
    h = x.float()
    y = F.layer_norm(h, (d,), g1, b1, LN_EPS)
    qkv = (_dot(y, wqkv, compute_dtype) + bqkv).reshape(b, t, 3, num_heads, dh)
    q = qkv[:, :, 0] * (dh ** -0.5)                     # [B, T, H, dh]
    k = qkv[:, :, 1]
    v = qkv[:, :, 2]
    scores = (q[:, :, None] * k[:, None, :]).sum(-1)    # [B, Tq, Tk, H]
    probs = torch.softmax(scores, dim=2)
    attn = (probs[..., None] * v[:, None]).sum(2)       # [B, Tq, H, dh]
    h = h + _dot(attn.reshape(b, t, d), wproj, compute_dtype) + bproj
    y = F.layer_norm(h, (d,), g2, b2, LN_EPS)
    y = _dot(y, w1, compute_dtype) + bm1
    y = F.gelu(y, approximate='tanh')
    return h + _dot(y, w2, compute_dtype) + bm2


@dataclass(frozen=True)
class PackedEncoderLayer:
    """One layer's parameters laid out once for the kernel.

    ``weights``: bf16, the four kernels in mma fragment order
    (``fused_mlp.fragment_order``), end to end (Wqkv, Wproj, W1, W2);
    ``rows``: f32, the eight vectors end to end (g1, b1, bqkv, bproj, g2,
    b2, bm1, bm2). ``params`` is the flat tuple (kernels bf16, vectors f32)
    for the plain version.
    """
    weights: torch.Tensor
    rows: torch.Tensor
    d_model: int
    mlp_dim: int
    params: Tuple[torch.Tensor, ...]

    @property
    def device(self) -> torch.device:
        return self.weights.device


def pack_encoder_params(params: Sequence[torch.Tensor],
                        device) -> PackedEncoderLayer:
    """Cast the kernels to bf16 and the vectors to f32, lay the kernels out
    in fragment order and place everything on ``device``."""
    if len(params) != len(PARAM_NAMES):
        raise ValueError(f'expected {len(PARAM_NAMES)} parameters '
                         f'{PARAM_NAMES}, got {len(params)}')
    d = int(params[0].shape[0])
    m = int(params[8].shape[1])
    shapes = ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,),
              (d,), (d,), (d, m), (m,), (m, d), (d,))
    for name, p, shape in zip(PARAM_NAMES, params, shapes):
        if tuple(p.shape) != shape:
            raise ValueError(f'{name}: shape {tuple(p.shape)}, expected {shape}')
    if d % 16 or m % 16:
        raise ValueError(f'd_model {d} and MLP width {m} must be multiples of 16')
    cast = [torch.as_tensor(p).detach().to(
                device=device,
                dtype=torch.bfloat16 if i in _WEIGHTS else torch.float32)
            for i, p in enumerate(params)]
    return PackedEncoderLayer(
        torch.cat([fragment_order(cast[i]) for i in _WEIGHTS]),
        torch.cat([cast[i] for i in _ROWS]), d, m, tuple(cast))


def plan_tile(t: int, d: int, m: int, num_heads: int) -> Tuple[int, int]:
    """``(row_tiles, windows)`` of a block for this shape, as
    ``csrc/fused_encoder.cu`` plans it; raises if the kernel cannot take the
    shape.

    The kernel takes ``d`` and ``m`` that are multiples of 128, an even head
    width, and windows of up to 48 frames as long as one window's rows
    (padded to 16) fit a block's shared memory beside their q/k/v: ``d`` up
    to 768 with a 4x MLP (T <= 16 there; T <= 32 at ``d = 384``, T <= 48 at
    ``d <= 256``).
    """
    if d < 128 or d % 128 or m < 128 or m % 128:
        raise ValueError(f'fused encoder kernel takes d_model and MLP width '
                         f'that are multiples of 128, got {d} and {m}')
    if num_heads < 1 or d % num_heads or (d // num_heads) % 2:
        raise ValueError(f'fused encoder kernel takes an even head width, '
                         f'got d_model {d} / {num_heads} heads')
    if not 1 <= t <= MAX_FRAMES:
        raise ValueError(f'fused encoder kernel takes windows of 1..'
                         f'{MAX_FRAMES} frames, got {t}')
    for row_tiles in range(_MAX_ROW_TILES, 0, -1):
        rows = 16 * row_tiles
        big = max(rows * (3 * d + _PAD) * 4, rows * (m + _PAD) * 2)
        smem = rows * (d + _PAD) * 4 + big + rows * (d + _PAD) * 2
        if smem <= MAX_SMEM:
            if rows < t:
                break
            return row_tiles, rows // t
    raise ValueError(f'fused encoder kernel: a window of {t} frames at '
                     f'd_model {d}, MLP width {m} does not fit the '
                     f'{MAX_SMEM} bytes of shared memory a block may use')


def fused_encoder_layer(x: torch.Tensor, packed: PackedEncoderLayer,
                        num_heads: int) -> torch.Tensor:
    """x [B, T, d] float32 -> [B, T, d] float32 through the fused kernel.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`encoder_layer_reference`; any other device raises.
    """
    global launches
    if x.device.type == 'cpu':
        return encoder_layer_reference(x, packed.params, num_heads)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_encoder_layer: no kernel for device {x.device}')
    if (x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous()
            or x.data_ptr() % 16):
        raise ValueError(f'fused_encoder_layer takes a contiguous, 16-byte '
                         f'aligned float32 [B, T, d] tensor, got {x.dtype} '
                         f'{tuple(x.shape)}')
    batch, t, d = x.shape
    if d != packed.d_model:
        raise ValueError(f'input width {d} != packed d_model {packed.d_model}')
    if packed.device != x.device:
        raise ValueError(f'weights on {packed.device}, input on {x.device}')
    plan_tile(t, d, packed.mlp_dim, num_heads)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ib_fused_encoder_forward(
            x.data_ptr(), batch, t, d, packed.mlp_dim, num_heads,
            packed.weights.data_ptr(), packed.rows.data_ptr(), out.data_ptr(),
            stream)
    _build.check(lib, code, 'fused_encoder_layer launch')
    launches += 1
    return out
