"""Fused GroundLink forward: one CUDA kernel for the conv stack and the head.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/pallas_groundlink.py``.
The kernel itself is ``csrc/fused_groundlink.cu`` (it replaces the Pallas
``_gl_kernel``); this module holds its plain PyTorch version
(:func:`groundlink_reference`), the one-time weight packing
(:func:`pack_groundlink_params`, counterpart of
``groundlink_params_from_tree``) and the wrapper
(:func:`fused_groundlink_forward`).

Parameters keep the JAX package's layout at this module's public functions,
the flax ``Groundlink`` tree with tensors for leaves::

    {'Conv_{i}': {'kernel': [k, C_in, C_out], 'bias': [C_out]}, ...,
     'Dense_{j}': {'kernel': [in, out], 'bias': [out]}, ...,
     'Dense_{fc_depth-1}': {'kernel': [in, 30]}}          # the head, no bias

:func:`fused_groundlink_forward` launches the kernel for a CUDA tensor and
uses :func:`groundlink_reference` only for a CPU tensor; any other device
raises. ``launches`` counts the kernel launches in this process.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

import torch

from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops._layout import fragment_order

# the kernel's limits (see csrc/fused_groundlink.cu and check_kernel_shape)
MAX_ROW_TILES = 4      # 16-row mma tiles a block owns: T <= 64
MAX_LAYERS = 12        # convs + FC layers + head
MAX_WIDTH = 512        # any layer's input width, after padding
_K_UNIT = 64           # a layer's input width is padded to a multiple of this
_N_UNIT = 16           # the head's output width is padded to a multiple of this

# kernel launches so far (for checking that a path went through the kernel)
launches = 0


def _round_up(d: int, unit: int) -> int:
    return (d + unit - 1) // unit * unit


def _elu(z: torch.Tensor) -> torch.Tensor:
    """``exp(min(z, 0)) - 1`` below zero, as ``pallas_groundlink.py::_elu``
    (not ``expm1``, which ``F.elu`` may use)."""
    return torch.where(z > 0, z, torch.exp(torch.clamp(z, max=0.0)) - 1.0)


def _layer_names(params: Mapping) -> Tuple[int, int]:
    """(number of convs, number of Dense layers) in a flax Groundlink tree."""
    n_conv = 0
    while f'Conv_{n_conv}' in params:
        n_conv += 1
    n_fc = 0
    while f'Dense_{n_fc}' in params:
        n_fc += 1
    if n_conv < 1 or n_fc < 1 or len(params) != n_conv + n_fc:
        raise ValueError(f'expected a Conv_{{i}}/Dense_{{j}} GroundLink tree, '
                         f'got keys {sorted(params)}')
    return n_conv, n_fc


def groundlink_reference(x: torch.Tensor, params: Mapping,
                         output_data_format: str = 'all_frames',
                         fc_depth: int = 3,
                         compute_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """Plain version: x [B, T, C_in] -> head vector [B, out_frames, 30] f32.

    The math of ``pallas_groundlink.py::_gl_forward_math`` step by step: each
    temporal conv (replicate padding) as its k shifted products with clamped
    frame indices, operands rounded to ``compute_dtype``, products summed in
    float32 with an f32 bias and ELU; then, on the last frame or on every
    frame, ``fc_depth - 1`` hidden layers and the bias-free head. The matmuls
    run in float32 on the rounded operands (exact products), so on a GPU they
    need ``torch.backends.cuda.matmul.allow_tf32 = False``.
    """
    n_conv, n_fc = _layer_names(params)
    if n_fc != fc_depth:
        raise ValueError(f'fc_depth {fc_depth} but the tree has {n_fc} Dense layers')
    if x.ndim != 3:
        raise ValueError(f'expected (B, T, C), got {tuple(x.shape)}')
    t = x.shape[1]
    frames = torch.arange(t, device=x.device)
    h = x.float()
    for i in range(n_conv):
        kernel = params[f'Conv_{i}']['kernel']               # [k, C_in, C_out]
        taps, half = kernel.shape[0], kernel.shape[0] // 2
        hc = h.to(compute_dtype).float()
        wc = kernel.to(compute_dtype).float()
        acc = None
        for j in range(taps):
            src = torch.clamp(frames + (j - half), 0, t - 1)  # replicate padding
            z = hc[:, src, :] @ wc[j]
            acc = z if acc is None else acc + z
        h = _elu(acc + params[f'Conv_{i}']['bias'].float())
    if output_data_format != 'all_frames':
        h = h[:, -1:, :]
    for j in range(fc_depth - 1):
        p = params[f'Dense_{j}']
        h = _elu(h.to(compute_dtype).float() @ p['kernel'].to(compute_dtype).float()
                 + p['bias'].float())
    head = params[f'Dense_{fc_depth - 1}']['kernel']
    return h.to(compute_dtype).float() @ head.to(compute_dtype).float()


@dataclass(frozen=True)
class PackedGroundlink:
    """Weights padded, cast and laid out once for the kernel.

    ``weights``: bf16, layer after layer (the convs, the hidden FC layers,
    the head), each padded to ``[taps * pwidths[l], pwidths[l + 1]]`` (a
    conv's rows tap-major) and laid out in mma fragment order
    (``_layout.fragment_order``); ``biases``: f32, padded, end to end, for
    every layer but the head. Padding is zero. ``params`` holds the unpadded
    tree (kernels bf16, biases f32) for the plain version.
    """
    weights: torch.Tensor
    biases: torch.Tensor
    widths: Tuple[int, ...]       # C_in, then every layer's output width
    pwidths: Tuple[int, ...]      # the same, padded
    n_conv: int
    fc_depth: int
    taps: int
    params: Dict[str, Dict[str, torch.Tensor]]

    @property
    def device(self) -> torch.device:
        return self.weights.device


def pack_groundlink_params(params: Mapping, device) -> PackedGroundlink:
    """Pad every layer's input width to a multiple of 64 and the head's
    output to a multiple of 16 with zeros, cast kernels to bf16 and biases to
    f32, flatten each conv kernel ``[k, C_in, C_out]`` to ``[k * C_in,
    C_out]`` (``groundlink_params_from_tree``'s layout), lay it out in
    fragment order and place everything on ``device``.

    Zero padding is exact: padded input channels meet zero weight rows, and
    padded hidden channels are elu(0 + 0) = 0.
    """
    n_conv, n_fc = _layer_names(params)
    layers = [params[f'Conv_{i}'] for i in range(n_conv)] + \
             [params[f'Dense_{j}'] for j in range(n_fc)]
    taps = int(layers[0]['kernel'].shape[0])
    widths = [int(layers[0]['kernel'].shape[1])]
    for l, p in enumerate(layers):
        kernel, bias = p['kernel'], p.get('bias')
        want = (taps, widths[-1]) if l < n_conv else (widths[-1],)
        if tuple(kernel.shape[:-1]) != want:
            raise ValueError(f'layer {l}: kernel {tuple(kernel.shape)} after '
                             f'width {widths[-1]} ({taps} taps)')
        widths.append(int(kernel.shape[-1]))
        if (bias is None) != (l == len(layers) - 1):
            raise ValueError('every layer but the last Dense (the head) has a bias')
        if bias is not None and tuple(bias.shape) != (widths[-1],):
            raise ValueError(f'layer {l}: bias {tuple(bias.shape)} for width {widths[-1]}')
    pwidths = [_round_up(d, _K_UNIT) for d in widths[:-1]] + \
              [_round_up(widths[-1], _N_UNIT)]
    weights, biases, plain = [], [], {}
    names = [f'Conv_{i}' for i in range(n_conv)] + [f'Dense_{j}' for j in range(n_fc)]
    for l, (name, p) in enumerate(zip(names, layers)):
        kernel = torch.as_tensor(p['kernel']).to(device=device, dtype=torch.bfloat16)
        lt = taps if l < n_conv else 1
        wp = torch.zeros(lt, pwidths[l], pwidths[l + 1], dtype=torch.bfloat16,
                         device=device)
        wp[:, :widths[l], :widths[l + 1]] = kernel.reshape(lt, widths[l], widths[l + 1])
        weights.append(fragment_order(wp.reshape(lt * pwidths[l], pwidths[l + 1])))
        plain[name] = {'kernel': kernel}
        if p.get('bias') is not None:
            bias = torch.as_tensor(p['bias']).to(device=device, dtype=torch.float32)
            biases.append(torch.nn.functional.pad(bias, (0, pwidths[l + 1] - widths[l + 1])))
            plain[name]['bias'] = bias
    return PackedGroundlink(torch.cat(weights), torch.cat(biases), tuple(widths),
                            tuple(pwidths), n_conv, n_fc, taps, plain)


def check_kernel_shape(t: int, pwidths: Sequence[int], n_conv: int, fc_depth: int,
                       taps: int) -> None:
    """Raise if the kernel cannot take this model.

    Its limits: 1 <= T <= 64 frames (a block owns whole windows in at most
    four 16-row tiles); an odd number of taps; at least one conv and one
    Dense layer (the head), at most 12 layers in all; every layer's input
    width, after padding to a multiple of 64, at most 512 (two bf16 buffers
    of 64 rows in a block's shared memory).
    """
    if not 1 <= t <= 16 * MAX_ROW_TILES:
        raise ValueError(f'fused GroundLink kernel takes 1..{16 * MAX_ROW_TILES} '
                         f'frames a window, got {t}')
    if taps < 1 or taps % 2 != 1:
        raise ValueError(f'fused GroundLink kernel takes an odd kernel size, got {taps}')
    if n_conv < 1 or fc_depth < 1 or n_conv + fc_depth > MAX_LAYERS:
        raise ValueError(f'fused GroundLink kernel takes 1+ convs and 1+ Dense layers, '
                         f'{MAX_LAYERS} in all at most; got {n_conv} + {fc_depth}')
    if max(pwidths[:-1]) > MAX_WIDTH:
        raise ValueError(f'fused GroundLink kernel takes layer widths up to '
                         f'{MAX_WIDTH}, got {max(pwidths[:-1])} (padded)')


def fused_groundlink_forward(x: torch.Tensor, packed: PackedGroundlink,
                             output_data_format: str = 'all_frames') -> torch.Tensor:
    """x [B, T, C_in] float32 -> head vector [B, out_frames, 30] float32
    through the fused kernel; ``out_frames`` is T for ``all_frames``, else 1.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`groundlink_reference`; any other device raises.
    """
    global launches
    if x.device.type == 'cpu':
        return groundlink_reference(x, packed.params, output_data_format,
                                    packed.fc_depth)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_groundlink_forward: no kernel for device {x.device}')
    if x.dtype != torch.float32 or x.ndim != 3 or not x.is_contiguous():
        raise ValueError(f'fused_groundlink_forward takes a contiguous float32 '
                         f'[B, T, C] tensor, got {x.dtype} {tuple(x.shape)}')
    if x.shape[2] != packed.widths[0]:
        raise ValueError(f'input width {x.shape[2]} != packed width {packed.widths[0]}')
    if packed.device != x.device:
        raise ValueError(f'weights on {packed.device}, input on {x.device}')
    batch, t = int(x.shape[0]), int(x.shape[1])
    check_kernel_shape(t, packed.pwidths, packed.n_conv, packed.fc_depth, packed.taps)
    last_frame = output_data_format != 'all_frames'
    c_out = packed.widths[-1]
    out = torch.empty((batch, 1 if last_frame else t, c_out), dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    lib = _build.library()
    pwidths = (ctypes.c_int * len(packed.pwidths))(*packed.pwidths)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ib_fused_groundlink_forward(
            x.data_ptr(), batch, t, x.shape[2], packed.weights.data_ptr(),
            packed.biases.data_ptr(), pwidths, packed.n_conv, packed.fc_depth,
            packed.taps, int(last_frame), out.data_ptr(), c_out, stream)
    _build.check(lib, code, 'fused_groundlink_forward launch')
    launches += 1
    return out
