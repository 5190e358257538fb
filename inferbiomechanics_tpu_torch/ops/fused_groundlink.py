"""Fused GroundLink forward: one CUDA kernel for the conv stack and the head.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/pallas_groundlink.py``.
The kernel itself is ``csrc/fused_groundlink.cu`` (it replaces the Pallas
``_gl_kernel``); this module holds its plain PyTorch version
(:func:`groundlink_reference`), the one-time weight packing
(:func:`pack_groundlink_params`, counterpart of
``groundlink_params_from_tree``) and the wrapper
(:func:`fused_groundlink_forward`), which launches the kernel in one of two
shapes that :func:`plan_groundlink` picks from the shape of the call: up to
:data:`SMALL_BATCH_MAX` windows a cluster of blocks splits every layer's
columns, above it one block takes a tile of many windows. In ``last_frame``
mode both trim each conv to the frames the head needs
(:func:`layer_frames`).

Parameters keep the JAX package's layout at this module's public functions,
the flax ``Groundlink`` tree with tensors for leaves::

    {'Conv_{i}': {'kernel': [k, C_in, C_out], 'bias': [C_out]}, ...,
     'Dense_{j}': {'kernel': [in, out], 'bias': [out]}, ...,
     'Dense_{fc_depth-1}': {'kernel': [in, 30]}}          # the head, no bias

:func:`fused_groundlink_forward` launches the kernel for a CUDA tensor and
uses :func:`groundlink_reference` only for a CPU tensor; any other device
raises; nothing falls back. ``launches`` counts the kernel launches in this
process, ``shape_launches`` the same by shape.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch

from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops._layout import fragment_order

# the kernel's limits (see csrc/fused_groundlink.cu and check_kernel_shape)
MAX_FRAMES = 64        # frames a window
MAX_LAYERS = 12        # convs + FC layers + head
MAX_WIDTH = 512        # any layer's input width, after padding
MAX_SMEM = 232448      # bytes of shared memory a block may use
_K_UNIT = 64           # a layer's input width is padded to a multiple of this
_N_UNIT = 16           # the head's output width is padded to a multiple of this

# the kernel's two shapes (plan_groundlink): the warps of a block, the most
# 16-row tiles a warp of the small shape holds, the ints of a plan, the cycle
# counters a block. The largest batch the small shape takes, the most windows
# a block of the large shape takes (last_frame, all_frames: untrimmed, a
# 16-window tile leaves room for one block a multiprocessor), and the blocks
# the large shape spreads a batch over, which ops/tune.py sets by timing both
# shapes on an H100
_WARPS = 8
_SMALL_ROW_TILES = 4
_PLAN_INTS = 11 + MAX_LAYERS
_SMS = 132            # multiprocessors of an H100 SXM
_TWO_BLOCKS_SMEM = 115712   # the most shared memory a block may take for two to share one
_CHUNK = 4             # k-steps a chunk; a tap is a whole number of them
_PHASES = 1 + 2 * MAX_LAYERS
SMALL_BATCH_MAX = 128
LARGE_WINDOWS = 16
LARGE_WINDOWS_ALL_FRAMES = 6
LARGE_BLOCKS = 132
# blocks of small-shape clusters an H100 runs at once (14 clusters of 8;
# fused_encoder's measurement)
_SMALL_BLOCKS_AT_ONCE = 112

# kernel launches so far (for checking that a path went through the kernel),
# and by the shape that ran
launches = 0
shape_launches = {'small': 0, 'large': 0}
# None, or an int64 CUDA tensor that the next launches fill with each block's
# cycles by phase ([blocks, 25]: stage x, then each layer's product and the
# exchange after it; phase_names; ops/tune.py reads them)
phase_clocks: Optional[torch.Tensor] = None


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

    Its limits: 1 <= T <= 64 frames (a tile holds whole windows); an odd
    number of taps; at least one conv and one Dense layer (the head), at most
    12 layers in all; every layer's input width, after padding to a multiple
    of 64, at most 512. Every shape inside them has a plan
    (:func:`plan_groundlink`).
    """
    if not 1 <= t <= MAX_FRAMES:
        raise ValueError(f'fused GroundLink kernel takes 1..{MAX_FRAMES} '
                         f'frames a window, got {t}')
    if taps < 1 or taps % 2 != 1:
        raise ValueError(f'fused GroundLink kernel takes an odd kernel size, got {taps}')
    if n_conv < 1 or fc_depth < 1 or n_conv + fc_depth > MAX_LAYERS:
        raise ValueError(f'fused GroundLink kernel takes 1+ convs and 1+ Dense layers, '
                         f'{MAX_LAYERS} in all at most; got {n_conv} + {fc_depth}')
    if max(pwidths[:-1]) > MAX_WIDTH:
        raise ValueError(f'fused GroundLink kernel takes layer widths up to '
                         f'{MAX_WIDTH}, got {max(pwidths[:-1])} (padded)')


def layer_frames(t: int, n_conv: int, taps: int, last_frame: bool
                 ) -> Tuple[int, Tuple[int, ...]]:
    """``(frames of x, frames of each conv's output)`` that the forward must
    compute for every window: the last ones of the window.

    ``all_frames`` needs all T everywhere. ``last_frame`` reads frame T-1 of
    the last conv only, and a conv's frame f reads frames f - k/2 .. f + k/2
    (clamped to the window), so conv l must produce the last
    ``min(T, 1 + (n_conv - 1 - l) * (k // 2))`` frames and x the last
    ``min(T, 1 + n_conv * (k // 2))``: 13 -> 10, 7, 4, 1 at T = 10, k = 7,
    four convs (x is clamped to 10).
    """
    if not last_frame:
        return t, (t,) * n_conv
    half = taps // 2
    keep = tuple(min(t, 1 + (n_conv - 1 - l) * half) for l in range(n_conv))
    return min(t, 1 + n_conv * half), keep


def owned_blocks(ncb: int, cluster: int, rank: int) -> Tuple[int, int]:
    """``(first, count)`` of the 16-column blocks of a layer with ``ncb`` of
    them that block ``rank`` of a cluster of ``cluster`` computes: a balanced
    split into contiguous runs, so each is computed by exactly one block (the
    two of a 32-wide head by two blocks of eight)."""
    first = rank * ncb // cluster
    return first, (rank + 1) * ncb // cluster - first


def layer_split(n_own: int, nk: int) -> int:
    """Parts the small shape splits a layer's ``nk`` k-steps into, where a
    block owns ``n_own`` column blocks: one warp an item, so ``8 // n_own``,
    at most one a chunk of 4 k-steps (the kernel's ``layer_split``); part p
    takes chunks ``[p * nk/4 // split, (p + 1) * nk/4 // split)``."""
    if n_own <= 0:
        return 1
    return max(1, min(_WARPS // n_own, nk // _CHUNK))


def small_cluster(pwidths: Sequence[int]) -> int:
    """Blocks of the small shape's cluster: 8 where every layer but the head
    has at least 8 column blocks (128 columns), else 4 (every such layer has
    at least 4: widths are multiples of 64)."""
    return 8 if min(pwidths[1:-1]) >= 8 * 16 else 4


@dataclass(frozen=True)
class GroundlinkPlan:
    """The launch :func:`plan_groundlink` chose.

    ``shape`` is ``'small'`` (a cluster of ``cluster`` blocks shares a tile of
    ``windows`` windows; each owns a balanced share of every layer's
    16-column blocks, :func:`owned_blocks`, and splits its k-steps over the
    warps where it owns fewer blocks than it has warps, :func:`layer_split`)
    or ``'large'`` (one block a tile, all the columns). ``row_tiles`` is the
    most 16-row mma tiles a warp holds accumulators for (1 or 4 small, 4
    large: a layer with more row tiles splits them into groups), ``depth``
    the k-steps of weights a warp keeps in flight: 16, but 8 in a large grid
    where two blocks share a multiprocessor (more blocks than
    multiprocessors, and room for two in shared memory). ``keep_in``
    and ``keep`` are the frames of each window of x and of every layer's
    output that the tile holds (:func:`layer_frames`; an FC layer keeps what
    the last conv kept), ``rows_x`` and ``rows`` their rows, padded to 16.
    Offsets are bytes into the block's shared memory: buffer P (x and the
    outputs of odd layers) at 0, Q (even layers) at ``off_q``, the f32
    biases of every layer but the head at ``off_v``, the f32 scratch of split
    products (``scratch_floats``) at ``off_s``, the small shape's mbarriers
    (one a layer but the head) at ``off_b``.
    """
    shape: str
    cluster: int
    windows: int
    row_tiles: int
    depth: int
    keep_in: int
    keep: Tuple[int, ...]
    rows_x: int
    rows: Tuple[int, ...]
    off_q: int
    off_v: int
    off_s: int
    scratch_floats: int
    off_b: int
    smem_bytes: int

    def as_ints(self) -> Tuple[int, ...]:
        keep = self.keep + (0,) * (MAX_LAYERS - len(self.keep))
        return (int(self.shape == 'small'), self.cluster, self.windows, self.row_tiles,
                self.depth, self.keep_in, self.off_q, self.off_v, self.off_s, self.scratch_floats,
                self.off_b,
                *keep)

    def blocks(self, batch: int) -> int:
        return -(-batch // self.windows) * self.cluster


def _layout(shape: str, t: int, pwidths: Sequence[int], n_conv: int, taps: int,
            last_frame: bool, windows: int, cluster: int,
            depth: int = 16) -> Optional[GroundlinkPlan]:
    """Shared memory of one shape at one tile; None if it does not fit."""
    n_layers = len(pwidths) - 1
    keep_in, conv_keep = layer_frames(t, n_conv, taps, last_frame)
    keep = conv_keep + (conv_keep[-1],) * (n_layers - n_conv)
    rows_x = _round_up(windows * keep_in, 16)
    rows = tuple(_round_up(windows * k, 16) for k in keep)
    # layer l writes Q for even l, P for odd l; the head writes device memory
    p_bytes = max([rows_x * pwidths[0] * 2] +
                  [rows[l] * pwidths[l + 1] * 2 for l in range(1, n_layers - 1, 2)])
    q_bytes = max([rows[l] * pwidths[l + 1] * 2 for l in range(0, n_layers - 1, 2)])
    off_q = _round_up(p_bytes, 16)
    off_v = off_q + _round_up(q_bytes, 16)
    off_s = off_v + _round_up(4 * sum(pwidths[1:-1]), 16)
    scratch = 0
    if shape == 'small':
        if max(rows) > 16 * _SMALL_ROW_TILES:
            return None
        row_tiles = 1 if max(rows) <= 16 else _SMALL_ROW_TILES
        for l in range(n_layers):
            ncb = pwidths[l + 1] // 16
            nk = (taps if l < n_conv else 1) * pwidths[l] // 16
            for rank in range(cluster):
                n_own = owned_blocks(ncb, cluster, rank)[1]
                split = layer_split(n_own, nk)
                if split > 1:
                    scratch = max(scratch, split * n_own * rows[l] * 16)
        off_b = off_s + scratch * 4
        end = off_b + 8 * (n_layers - 1)
    else:
        row_tiles = 4
        off_b = end = off_s
    if end > MAX_SMEM:
        return None
    return GroundlinkPlan(shape, cluster, windows, row_tiles, depth, keep_in, keep, rows_x, rows,
                          off_q, off_v, off_s, scratch, off_b, end)


def plan_groundlink(batch: int, t: int, pwidths: Sequence[int], n_conv: int,
                    fc_depth: int, taps: int, last_frame: bool) -> GroundlinkPlan:
    """Which shape of the kernel takes ``batch`` windows of ``t`` frames of a
    model with padded widths ``pwidths``, and its shared-memory layout; a
    function of these alone. Raises for a shape outside the kernel's limits
    (:func:`check_kernel_shape`).

    Small, up to :data:`SMALL_BATCH_MAX` windows: a cluster of
    :func:`small_cluster` blocks a tile of the fewest windows with which all
    the batch's clusters run at once (14 clusters of 8), at most as many as 64
    rows hold. Otherwise large: one block a tile of ``ceil(batch /
    LARGE_BLOCKS)`` windows (at most one block on each multiprocessor), at
    most :data:`LARGE_WINDOWS` (``last_frame``) or
    :data:`LARGE_WINDOWS_ALL_FRAMES`, fewer where shared memory runs out.
    """
    return _plan_groundlink(batch, t, tuple(pwidths), n_conv, fc_depth, taps,
                            bool(last_frame), SMALL_BATCH_MAX,
                            LARGE_WINDOWS if last_frame else LARGE_WINDOWS_ALL_FRAMES,
                            LARGE_BLOCKS)


@functools.lru_cache(maxsize=512)
def _plan_groundlink(batch: int, t: int, pwidths: Tuple[int, ...], n_conv: int,
                     fc_depth: int, taps: int, last_frame: bool, small_batch_max: int,
                     large_windows: int, large_blocks: int) -> GroundlinkPlan:
    """:func:`plan_groundlink` at given thresholds, computed once a shape."""
    if batch < 1:
        raise ValueError(f'plan_groundlink: batch {batch}')
    if len(pwidths) != n_conv + fc_depth + 1:
        raise ValueError(f'{len(pwidths)} widths for {n_conv} convs and {fc_depth} Dense layers')
    check_kernel_shape(t, pwidths, n_conv, fc_depth, taps)
    if batch <= small_batch_max:
        cluster = small_cluster(pwidths)
        at_once = _SMALL_BLOCKS_AT_ONCE // cluster
        windows = min(max(1, 16 * _SMALL_ROW_TILES // t), -(-batch // at_once))
        plan = _layout('small', t, pwidths, n_conv, taps, last_frame, windows, cluster)
        if plan is not None:
            return plan
    windows = max(1, min(large_windows, -(-batch // large_blocks)))
    while True:
        plan = _layout('large', t, pwidths, n_conv, taps, last_frame, windows, 1, 8)
        if plan is not None:
            if -(-batch // windows) <= _SMS or plan.smem_bytes > _TWO_BLOCKS_SMEM:
                plan = _layout('large', t, pwidths, n_conv, taps, last_frame, windows, 1, 16)
            break
        if windows == 1:
            break
        windows -= 1
    if plan is None:
        raise ValueError(f'fused GroundLink kernel: a window of {t} frames at widths '
                         f'{pwidths} does not fit a block')
    return plan


def phase_names(n_conv: int, fc_depth: int) -> Tuple[str, ...]:
    """Names of the first ``1 + 2 (n_conv + fc_depth)`` of the kernel's cycle
    counters (:data:`phase_clocks`)."""
    layers = [f'conv {i}' for i in range(n_conv)] + \
             [f'fc {j}' for j in range(fc_depth - 1)] + ['head']
    return ('stage x',) + tuple(f'{name} {what}' for name in layers
                                for what in ('product', 'exchange'))


def fused_groundlink_forward(x: torch.Tensor, packed: PackedGroundlink,
                             output_data_format: str = 'all_frames') -> torch.Tensor:
    """x [B, T, C_in] float32 -> head vector [B, out_frames, 30] float32
    through the fused kernel; ``out_frames`` is T for ``all_frames``, else 1.

    A CUDA tensor launches the kernel in the shape :func:`plan_groundlink`
    names (or raises); a CPU tensor takes :func:`groundlink_reference`; any
    other device raises. While ``torch.export`` traces, the call is the
    ``ib_torch::fused_groundlink`` operator (``ops/library.py``), which an
    exported program keeps.
    """
    global launches
    if torch.compiler.is_exporting():
        from inferbiomechanics_tpu_torch.ops import library
        return library.groundlink(x, packed, output_data_format)
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
    last_frame = output_data_format != 'all_frames'
    plan = plan_groundlink(max(batch, 1), t, packed.pwidths, packed.n_conv, packed.fc_depth,
                           packed.taps, last_frame)
    c_out = packed.widths[-1]
    out = torch.empty((batch, 1 if last_frame else t, c_out), dtype=torch.float32,
                      device=x.device)
    if batch == 0:
        return out
    clocks = None
    if phase_clocks is not None:
        need = plan.blocks(batch) * _PHASES
        if (phase_clocks.dtype != torch.int64 or phase_clocks.device != x.device
                or phase_clocks.numel() < need):
            raise ValueError(f'phase_clocks: an int64 tensor on {x.device} of at least '
                             f'{need} elements')
        clocks = phase_clocks.data_ptr()
    lib = _build.library()
    pwidths = (ctypes.c_int * len(packed.pwidths))(*packed.pwidths)
    plan_ints = (ctypes.c_int * _PLAN_INTS)(*plan.as_ints())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.ib_fused_groundlink_forward(
            x.data_ptr(), batch, t, x.shape[2], packed.weights.data_ptr(),
            packed.biases.data_ptr(), pwidths, packed.n_conv, packed.fc_depth,
            packed.taps, int(last_frame), out.data_ptr(), c_out, plan_ints,
            plan.smem_bytes, clocks, stream)
    _build.check(lib, code, 'fused_groundlink_forward launch')
    launches += 1
    shape_launches[plan.shape] += 1
    return out
