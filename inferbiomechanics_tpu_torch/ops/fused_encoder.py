"""Fused transformer encoder layer: one CUDA kernel for the whole layer.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/pallas_encoder.py``. The
kernel itself is ``csrc/fused_encoder.cu`` (it replaces the Pallas
``encoder_layer_pallas``, both of its kernel versions); this module holds
its plain PyTorch version (:func:`encoder_layer_reference`), the weight
packing (:func:`pack_encoder_params`) and the wrapper
(:func:`fused_encoder_layer`), which launches the kernel in one of three
shapes that :func:`plan_encoder` picks from the shape of the call: up to
:data:`SMALL_BATCH_MAX` windows a cluster of blocks splits every product's
columns, from :data:`PAIR_BATCH_MIN` windows at d = 256 clusters of two
blocks share one weight stream (``fused_encoder_kernel_pair``), else one
block takes a row tile. The layer's backward is
``csrc/fused_encoder_bwd.cu`` (it replaces the Pallas
``encoder_layer_bwd_pallas``), with its plain version
(:func:`encoder_layer_bwd_reference`), its wrapper
(:func:`fused_encoder_layer_bwd`, whose tile kernel takes one of three
shapes that :func:`plan_encoder_bwd` picks from the shape of the call: up to
:data:`BWD_SMALL_BATCH_MAX` windows a cluster splits the columns, from
:data:`BWD_PAIR_BATCH_MIN` windows at d = 256 clusters of two blocks share one
weight stream, else one block takes a tile; its weight-gradient stage,
laid out by :func:`plan_wgrad`, also runs alone on a given workspace:
:func:`encoder_wgrad`, plain version :func:`encoder_wgrad_reference`) and
the differentiable layer (:class:`FusedEncoderLayerFn`: kernel forward,
kernel backward).

One pre-LN layer: LayerNorm -> QKV projection -> softmax attention over the
window's T frames, per head -> output projection -> residual -> LayerNorm ->
MLP (GELU, tanh form) -> residual. Parameters keep the JAX package's layout
at this module's public functions: a flat tuple in :data:`PARAM_NAMES`
order, kernels ``[in, out]``, the ``3 d`` QKV columns ordered
``[q | k | v]``, each ``[H, dh]``.

:func:`fused_encoder_layer` launches the kernel for a CUDA tensor and uses
:func:`encoder_layer_reference` only for a CPU tensor; any other device
raises; :func:`fused_encoder_layer_bwd` does the same with the backward
kernels and :func:`encoder_layer_bwd_reference`. Nothing falls back: on a
CUDA tensor a kernel that fails to build or launch raises. ``launches``,
``bwd_launches`` and ``wgrad_launches`` count the kernel launches in this
process, ``shape_launches`` the forward's by shape and
``bwd_shape_launches`` the backward's tile kernel by shape
(:func:`plan_encoder_bwd`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops._layout import fragment_order

# parameter order of the flat tuple interface
PARAM_NAMES = ('ln1_scale', 'ln1_bias', 'wqkv', 'bqkv', 'wproj', 'bproj',
               'ln2_scale', 'ln2_bias', 'wmlp1', 'bmlp1', 'wmlp2', 'bmlp2')
_WEIGHTS = (2, 4, 8, 10)          # indices of the four kernels in PARAM_NAMES
_ROWS = (0, 1, 3, 5, 6, 7, 9, 11)  # ... and of the eight f32 rows

LN_EPS = 1e-6

# the envelope of shapes the kernels take (plan_tile): whole windows of at
# most 48 frames, in 1..3 mma row tiles of 16 rows beside their f32 q/k/v, in
# the shared memory a block may use
MAX_FRAMES = 48
MAX_SMEM = 232448
_MAX_ROW_TILES = 3
_PAD = 8

# the forward's three shapes (csrc/fused_encoder.cu, plan_encoder): the warps
# of a block, the largest batch the small shape takes and the smallest the
# pair shape takes, which ops/tune.py --kernel encoder sets by timing the
# shapes on an H100 (PERF.md §6, its runs T1 and T3: the small shape ~37.5
# us up to 60 windows, 15 clusters of 8 in one wave, and ~72 from 61, two
# waves; the pair ~41 us from 1 window to 396)
_WARPS = 16
SMALL_BATCH_MAX = 60
PAIR_BATCH_MIN = 61
# blocks of small-shape clusters an H100 runs at once: 14 clusters of 8 took
# one wave (56 windows, 4 a cluster), 16 two (ops/tune.py); the pair shape's
# clusters and the large shape's blocks one a multiprocessor (132)
_SMALL_BLOCKS_AT_ONCE = 112
_PAIR_CLUSTERS_AT_ONCE = 66
_LARGE_BLOCKS_AT_ONCE = 132

# the backward (csrc/fused_encoder_bwd.cu): launches a call (tile kernel,
# weight gradients, reduce)
BWD_LAUNCHES_PER_LAYER = 3
# the weight-gradient stage (encoder_wgrad_kernel; plan_wgrad): rows a TMA
# box (a range of rows is whole boxes), output rows a tile and the tile
# widths, the multiprocessors its items are laid out for (an H100's; the
# plan is the shape's alone, so the order of every sum is fixed on any
# card), the most ranges it cuts the rows into, and its cost model, fitted
# to the stage's device times on an H100 over 56 plans at B = 1, 64, 512 and
# 4096 (PERF.md §6): us a block for a box of a 256- or 128-wide tile and
# for an item's start and store; the bytes of workspace and partial tiles a
# us the card moves; us of reduce a range a million outputs
_WG_BOX = 64
_WG_M = 128
_WG_TILE_N = (256, 128)
_WG_SMS = 132
_WG_MAX_SPLITS = 64
_WG_BOX_US = {256: 0.643, 128: 0.423}
_WG_ITEM_US = 2.97
_WG_BYTES_PER_US = 2.70e6
_WG_SPLIT_US_PER_MOUT = 1.33
# the largest batch the backward's small (cluster) shape takes, and the
# smallest the pair shape takes, which ops/tune.py --kernel encoder_bwd sets
# by timing the shapes on an H100
BWD_SMALL_BATCH_MAX = 44
BWD_PAIR_BATCH_MIN = 45
# the small shape's exchanges (a, h2, dz1, dy2, dqkv, dy1): one mbarrier each
_BWD_EXCHANGES = 6
# the pair shape (csrc/fused_encoder_bwd.cu's kP* constants): the width it
# takes, a block's rows, the longest window, the head widths, the hidden
# columns of an MLP chunk, and the ring of weights: a slot holds 4 k-steps of
# 16 column blocks in fragment order (32 KB), kSlots of them
PAIR_D = 256
_PAIR_ROWS = 32
_PAIR_MAX_FRAMES = 16
_PAIR_HEAD_WIDTHS = (16, 32, 64)
_PAIR_CHUNK = 256
_SLOT_KS = 4
_SLOT_BYTES = 16 * _SLOT_KS * 512
_SLOTS = 3
# the forward's pair shape (csrc/fused_encoder.cu's kF* constants): the same
# rows, frames and head widths; an MLP up to 1024 wide (its hidden and the
# next tile's x take the f32 q/k/v's room); a ring of two 32 KB slots of 4
# k-steps
_PAIR_MAX_MLP = 1024
_FWD_SLOT_KS = 4
_FWD_SLOT_BYTES = 16 * _FWD_SLOT_KS * 512
_FWD_SLOTS = 2

# kernel launches so far (for checking that a path went through the kernel),
# and the forward's by the shape that ran
launches = 0
bwd_launches = 0
# the weight-gradient stage's launches through encoder_wgrad (the stage alone;
# the backward's own count in bwd_launches)
wgrad_launches = 0
shape_launches = {'small': 0, 'pair': 0, 'large': 0}
# the backward's tile-kernel launches by the shape that ran (one a call)
bwd_shape_launches = {'small': 0, 'pair': 0, 'large': 0}
# None, or an int64 CUDA tensor that the next forward launches fill with
# each block's cycles by phase ([blocks, len(plan.phases)]: PHASES for the
# small and large shapes, PAIR_PHASES for the pair, each phase summed over
# the block's tiles and last the cycles its warp 0 waited for weights in
# them; ops/tune.py reads them)
phase_clocks: Optional[torch.Tensor] = None
PHASES = ('stage x, LN1', 'q/k/v', 'attention', 'a to all', 'projection', 'h to all',
          'LN2', 'W1', 'u to all', 'W2, store')
PAIR_PHASES = ('stage x, LN1', 'q/k/v', 'attention', 'projection', 'LN2', 'W1',
               'W2, store', 'waiting for weights')
# the same for the backward's small shape ([blocks, 18], BWD_PHASES) and its
# pair shape ([blocks, 14], BWD_PAIR_PHASES: each phase summed over the
# block's tiles, and last the cycles its warp 0 waited for weights in them)
bwd_phase_clocks: Optional[torch.Tensor] = None
BWD_PHASES = ('stage x, LN1', 'q/k/v', 'attention', 'a exchanged', 'projection',
              'h2 exchanged', 'LN2, g', 'MLP products', 'dz1 exchanged', 'dy2',
              'dy2 exchanged', "LN2's VJP", 'da', 'attention backward', 'dqkv exchanged',
              'dy1', 'dy1 exchanged', "LN1's VJP")
BWD_PAIR_PHASES = ('stage x, LN1', 'q/k/v', 'attention', 'projection', 'LN2, g',
                   'MLP products', "dy2, LN2's sums", "LN2's VJP", 'da',
                   'attention backward', 'dqkv out, x again', "dy1, LN1's sums",
                   "LN1's VJP", 'waiting for weights')


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
    (``_layout.fragment_order``), end to end (Wqkv, Wproj, W1, W2);
    ``rows``: f32, the eight vectors end to end (g1, b1, bqkv, bproj, g2,
    b2, bm1, bm2). ``params`` is the flat tuple (kernels bf16, vectors f32)
    for the plain version. ``weights_t``: the four transposes (Wqkv^T,
    Wproj^T, W1^T, W2^T) laid out the same way, which the backward
    multiplies by; ``None`` when packed for inference only.
    """
    weights: torch.Tensor
    rows: torch.Tensor
    d_model: int
    mlp_dim: int
    params: Tuple[torch.Tensor, ...]
    weights_t: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.weights.device


def pack_encoder_params(params: Sequence[torch.Tensor], device, *,
                        transposes: bool = False) -> PackedEncoderLayer:
    """Cast the kernels to bf16 and the vectors to f32, lay the kernels
    (with ``transposes``, their transposes too, for the backward) out in
    fragment order and place everything on ``device``."""
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
    weights_t = (torch.cat([fragment_order(cast[i].t()) for i in _WEIGHTS])
                 if transposes else None)
    return PackedEncoderLayer(
        torch.cat([fragment_order(cast[i]) for i in _WEIGHTS]),
        torch.cat([cast[i] for i in _ROWS]), d, m, tuple(cast), weights_t)


def plan_tile(t: int, d: int, m: int, num_heads: int) -> Tuple[int, int]:
    """``(row_tiles, windows)`` of a row tile that holds the f32 q/k/v of all
    heads beside the residual and one bf16 operand: the forward kernel's
    large shape (:func:`plan_encoder`); raises if the kernels cannot take
    the shape. The envelope of both directions' kernels.

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


@dataclass(frozen=True)
class EncoderPlan:
    """The launch :func:`plan_encoder` chose for the forward kernel.

    ``shape`` is ``'small'`` (a cluster of ``cluster`` blocks shares a row
    tile, each owning 1/``cluster`` of every product's columns: its heads'
    q/k/v, ``d / cluster`` columns of the projection and of W2, ``m /
    cluster`` of W1), ``'pair'`` (clusters of two blocks, each block its own
    tile with all the columns, both fed by one stream of weights through a
    ring of ``slots`` slots of ``slot_bytes`` at ``off_ring``, their full
    and empty ``mbarrier``s at ``off_b``: :func:`_pair_layout`) or ``'large'``
    (one block a row tile, all the columns).
    ``row_tiles`` 16-row mma tiles hold ``windows`` whole windows. Strides
    are in elements, offsets in bytes from the start of the block's shared
    memory, where the f32 residual ``[rows, d + 8]`` lies: the LayerNorm
    output and the attention output (bf16, ``[rows, d + 8]`` each), the
    block's f32 q/k/v (stride ``ld_q``), the bf16 MLP hidden (``ld_u``), the
    f32 scratch of products split along K (``scratch_floats``) and the f32
    rows staged at ``off_v``: ``staged`` 2, all of them (LayerNorm's, then
    the biases), 1, LayerNorm's, 0, none (read from device memory). The
    small shape's three ``mbarrier``s, on which the other blocks' parts of
    the attention output, the residual and the hidden land, lie at
    ``off_b``.
    """
    shape: str
    cluster: int
    row_tiles: int
    windows: int
    ld_q: int
    ld_u: int
    off_y: int
    off_a: int
    off_q: int
    off_u: int
    off_s: int
    scratch_floats: int
    off_v: int
    staged: int
    off_b: int
    smem_bytes: int
    off_ring: int = 0
    slot_bytes: int = 0
    slots: int = 0

    def tiles(self, batch: int) -> int:
        return -(-batch // self.windows)

    def as_ints(self) -> Tuple[int, ...]:
        """What ``ib_fused_encoder_forward`` (small, large) or
        ``ib_fused_encoder_forward_pair`` (pair) reads, in its order."""
        if self.shape == 'pair':
            return (self.windows, self.off_y, self.off_q, self.off_ring, self.off_b,
                    self.slot_bytes, self.slots)
        return (int(self.shape == 'small'), self.cluster, self.row_tiles, self.windows,
                self.ld_q, self.ld_u, self.off_y, self.off_a, self.off_q, self.off_u,
                self.off_s, self.scratch_floats, self.off_v, self.staged, self.off_b)

    @property
    def phases(self) -> Tuple[str, ...]:
        """What :data:`phase_clocks` gets a block of this shape."""
        return PAIR_PHASES if self.shape == 'pair' else PHASES


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def small_cluster(d: int, num_heads: int) -> int:
    """Blocks of the small shape's cluster: the most, up to 8, among which
    the heads divide so that each block's q (k, v) columns fill whole
    16-column blocks; 1 where none does (the shape then cannot be split)."""
    dh = d // num_heads
    for c in (8, 4, 2):
        if num_heads % c == 0 and (num_heads // c * dh) % 16 == 0:
            return c
    return 1


def _layout(shape: str, t: int, d: int, m: int, num_heads: int, row_tiles: int,
            cluster: int) -> Optional[EncoderPlan]:
    """Shared memory of one shape at one row tile; None if it does not fit.

    The residual (f32), the LayerNorm output and the attention output (bf16)
    are ``[rows, d + 8]``, the block's q/k/v ``[rows, 3 d / C + 4]`` (f32), the
    MLP hidden ``[rows, m + 8]`` (bf16). Small: all the f32 rows, then the
    attention output and q/k/v, whose place the hidden takes once both are
    dead in every block (the others store into it), then the scratch in
    what is left. Large: the attention output in the LayerNorm output's place, the hidden
    in q/k/v's, then LayerNorm's rows where they fit and the scratch in what
    is left.
    """
    rows = 16 * row_tiles
    ld_q = 3 * d // cluster + _PAD // 2
    ld_u = m + _PAD
    r_bytes = rows * (d + _PAD) * 4
    y_bytes = rows * (d + _PAD) * 2
    q_bytes = _round16(rows * ld_q * 4)
    u_bytes = rows * ld_u * 2
    # partial sums of a product split along K: every part of every column
    # block, at most one a warp (splits stop where the scratch runs out)
    want_scratch = _WARPS * row_tiles * 256 * 4
    ln_bytes, all_bytes = 4 * d * 4, (9 * d + m) * 4     # the f32 rows to stage
    off_y = r_bytes
    if shape == 'small':
        off_b = off_y + y_bytes
        off_v = off_b + 64
        off_a = off_u = off_v + all_bytes
        off_q = off_a + y_bytes
        off_s = max(off_q + q_bytes, off_a + _round16(u_bytes))
        scratch = max(min(want_scratch, (MAX_SMEM - off_s) // 16 * 16), 0)
        end, staged = off_s + scratch, 2
    else:
        off_b = 0
        off_a, off_q = off_y, off_y + y_bytes
        off_u = off_q
        off_v = off_q + max(q_bytes, _round16(u_bytes))
        staged = 1 if off_v + ln_bytes <= MAX_SMEM else 0
        off_s = off_v + staged * ln_bytes
        scratch = max(min(want_scratch, (MAX_SMEM - off_s) // 16 * 16), 0)
        end = off_s + scratch
    if end > MAX_SMEM or 16 * row_tiles < t:
        return None
    return EncoderPlan(shape, cluster, row_tiles, 16 * row_tiles // t, ld_q, ld_u, off_y,
                       off_a, off_q, off_u, off_s, scratch // 4, off_v, staged, off_b, end)


def fwd_pair_takes(t: int, d: int, m: int, num_heads: int) -> bool:
    """Whether the forward's pair shape takes the shape: the backward's
    pair envelope (:func:`pair_takes`: d = 256, at most 16 frames, heads 16,
    32 or 64 wide) with an MLP of whole pairs of 256-column groups (one a
    group of consumer warps), 512 or 1024 columns: its bf16 hidden and the
    next tile's x take the f32 q/k/v's room."""
    return (pair_takes(t, d, m, num_heads) and m % (2 * _PAIR_CHUNK) == 0
            and m <= _PAIR_MAX_MLP)


def _pair_layout(t: int, d: int, m: int, num_heads: int) -> Optional[EncoderPlan]:
    """The forward's pair shape's shared memory (:class:`EncoderPlan`); None
    where it does not take the shape (:func:`fwd_pair_takes`).

    A block's 32-row tile: the f32 residual ``[rows, d + 4]`` at 0, the
    LayerNorm output and later the attention output (bf16 ``[rows, d + 8]``)
    at ``off_y``, the f32 q/k/v ``[rows, 3 d + 4]`` and later the bf16 MLP
    hidden ``[rows, m + 8]`` at ``off_q`` with the next tile's x (f32
    ``[rows, d]``) past it, then the ring of weights and the mbarriers
    (``off_b``: the slots' full, then empty, then the x's). The f32 q/k/v of
    all heads (98.8 KB) leave room for two 32 KB slots, four k-steps of 16
    column blocks each."""
    if not fwd_pair_takes(t, d, m, num_heads):
        return None
    rows = _PAIR_ROWS
    ld_q, ld_u = 3 * d + _PAD // 2, m + _PAD
    off_y = rows * (d + _PAD // 2) * 4
    off_q = off_y + rows * (d + _PAD) * 2
    off_ring = off_q + rows * ld_q * 4
    off_b = off_ring + _FWD_SLOTS * _FWD_SLOT_BYTES
    smem = off_b + (2 * _FWD_SLOTS + 1) * 8
    if smem > MAX_SMEM or rows * ld_u * 2 + rows * d * 4 > off_ring - off_q:
        return None
    return EncoderPlan('pair', 2, rows // 16, rows // t, ld_q, ld_u, off_y, off_y, off_q,
                       off_q, 0, 0, 0, 0, off_b, smem, off_ring=off_ring,
                       slot_bytes=_FWD_SLOT_BYTES, slots=_FWD_SLOTS)


def pair_stream(m: int) -> Tuple[Tuple[str, int, int, int], ...]:
    """The fills of the forward's pair ring for one tile, in the order the
    producer puts them: ``(weight, k-steps of the weight, first of the
    fill's 16 column blocks, first of its 4 k-steps)``, weights in
    :class:`PackedEncoderLayer` fragment order. The two groups of consumer
    warps take alternate fills (group 0 the even ones, the ring's first
    slot): q and k interleaved, a group each, then v and the projection,
    every other fill a group, W1 two column groups at a time interleaved,
    then W2, every other fill a group."""
    d = PAIR_D
    fills = []

    def put(name, nk, b0):
        fills.extend((name, nk, b0, ks) for ks in range(0, nk, _FWD_SLOT_KS))

    def both(name, b0):
        for ks in range(0, d // 16, _FWD_SLOT_KS):
            fills.extend(((name, d // 16, b0, ks), (name, d // 16, b0 + 16, ks)))

    both('wqkv', 0)
    put('wqkv', d // 16, 32)
    put('wproj', d // 16, 0)
    for c0 in range(0, m, 2 * _PAIR_CHUNK):
        both('wmlp1', c0 // 16)
    put('wmlp2', m // 16, 0)
    return tuple(fills)


def thresholds(shape: str) -> Tuple[int, int]:
    """``(SMALL_BATCH_MAX, PAIR_BATCH_MIN)`` with which ``shape`` takes every
    batch it can (tests and ``ops/tune.py`` set them so; the pair's 0 also
    lifts :func:`plan_encoder`'s one-wave rule)."""
    return {'small': (1 << 30, 1 << 30), 'pair': (0, 0), 'large': (0, 1 << 30)}[shape]


def encoder_blocks(plan: EncoderPlan, batch: int, sms: int) -> int:
    """Blocks of the forward kernel in ``plan`` at ``batch`` on a card of
    ``sms`` multiprocessors: a cluster a tile (small), one block a tile
    (large), a pair of blocks a pair of tiles up to one block a
    multiprocessor (pair)."""
    tiles = plan.tiles(batch)
    if plan.shape == 'pair':
        return 2 * min(-(-tiles // 2), sms // 2)
    return tiles * plan.cluster


def plan_encoder(batch: int, t: int, d: int, m: int, num_heads: int) -> EncoderPlan:
    """Which shape of the forward kernel takes ``batch`` windows of ``t``
    frames at width ``d``, MLP width ``m`` and ``num_heads`` heads, and its
    shared-memory layout; a function of these alone. Raises for a shape
    outside the kernel's envelope (:func:`plan_tile`).

    Small, up to :data:`SMALL_BATCH_MAX` windows where the heads split over a
    cluster (:func:`small_cluster`) and a window fits: the fewest mma row
    tiles (at most 3) with which the batch's clusters all run at once, else
    the most. Else pair, from :data:`PAIR_BATCH_MIN` windows where it takes
    the shape (:func:`fwd_pair_takes`), unless the pairs of tiles need more
    than one wave of clusters where the large shape's tiles fit in one (the
    pair takes ~41 us a wave at the served width, the large tile ~69: at T
    = 10 the large shape takes B = 397-528); a :data:`PAIR_BATCH_MIN` of 0
    gives the pair every batch it takes. Otherwise large: the row tile of
    :func:`plan_tile`.
    """
    return _plan_encoder(batch, t, d, m, num_heads, SMALL_BATCH_MAX, PAIR_BATCH_MIN)


@functools.lru_cache(maxsize=256)
def _plan_encoder(batch: int, t: int, d: int, m: int, num_heads: int,
                  small_batch_max: int, pair_batch_min: int) -> EncoderPlan:
    """:func:`plan_encoder` at given thresholds, computed once a shape."""
    row_tiles, _ = plan_tile(t, d, m, num_heads)
    cluster = small_cluster(d, num_heads)
    if batch <= small_batch_max and cluster > 1:
        fits = [p for p in (_layout('small', t, d, m, num_heads, rt, cluster)
                            for rt in range(1, _MAX_ROW_TILES + 1)) if p]
        if fits:
            at_once = [p for p in fits
                       if -(-batch // p.windows) * cluster <= _SMALL_BLOCKS_AT_ONCE]
            return (at_once or fits[::-1])[0]
    large = _layout('large', t, d, m, num_heads, row_tiles, 1)
    pair = _pair_layout(t, d, m, num_heads) if batch >= pair_batch_min else None
    if (pair and pair_batch_min > 0 and -(-pair.tiles(batch) // 2) > _PAIR_CLUSTERS_AT_ONCE
            and large.tiles(batch) <= _LARGE_BLOCKS_AT_ONCE):
        return large
    return pair or large


def fused_encoder_layer(x: torch.Tensor, packed: PackedEncoderLayer,
                        num_heads: int) -> torch.Tensor:
    """x [B, T, d] float32 -> [B, T, d] float32 through the fused kernel.

    A CUDA tensor launches the kernel (or raises); a CPU tensor takes
    :func:`encoder_layer_reference`; any other device raises. While
    ``torch.export`` traces, the call is the ``ib_torch::fused_encoder_layer``
    operator (``ops/library.py``), which an exported program keeps.
    """
    global launches
    if torch.compiler.is_exporting():
        from inferbiomechanics_tpu_torch.ops import library
        return library.encoder_layer(x, packed, num_heads)
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
    plan = plan_encoder(max(batch, 1), t, d, packed.mlp_dim, num_heads)
    out = torch.empty_like(x)
    if batch == 0:
        return out
    lib = _build.library()
    ints = plan.as_ints()
    plan_ints = (ctypes.c_int * len(ints))(*ints)
    blocks = encoder_blocks(
        plan, batch, torch.cuda.get_device_properties(x.device).multi_processor_count)
    clocks = None
    if phase_clocks is not None:
        need = blocks * len(plan.phases)
        if (phase_clocks.dtype != torch.int64 or phase_clocks.device != x.device
                or phase_clocks.numel() < need):
            raise ValueError(f'phase_clocks: an int64 tensor on {x.device} of at least '
                             f'{need} elements')
        clocks = phase_clocks.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if plan.shape == 'pair':
            code = lib.ib_fused_encoder_forward_pair(
                x.data_ptr(), batch, t, d, packed.mlp_dim, num_heads,
                packed.weights.data_ptr(), packed.rows.data_ptr(), out.data_ptr(),
                plan_ints, plan.smem_bytes, blocks, clocks, stream)
        else:
            code = lib.ib_fused_encoder_forward(
                x.data_ptr(), batch, t, d, packed.mlp_dim, num_heads,
                packed.weights.data_ptr(), packed.rows.data_ptr(), out.data_ptr(),
                plan_ints, plan.smem_bytes, clocks, stream)
    _build.check(lib, code, 'fused_encoder_layer launch')
    launches += 1
    shape_launches[plan.shape] += 1
    return out


# ---------------------------------------------------------------------------
# The backward: recompute the forward, then the hand-derived VJP.
# ---------------------------------------------------------------------------

_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715


def _gelu_tanh_grad(z: torch.Tensor) -> torch.Tensor:
    u = _SQRT_2_OVER_PI * (z + _GELU_C * z * z * z)
    th = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * z * z)
    return 0.5 * (1.0 + th) + 0.5 * z * (1.0 - th * th) * du


def _ln_fwd(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    rs = torch.rsqrt(((x - mu) ** 2).mean(-1, keepdim=True) + LN_EPS)
    xhat = (x - mu) * rs
    return xhat * scale + bias, xhat, rs


def _ln_bwd(dy, xhat, rs, scale):
    """LayerNorm's VJP: (dx, dscale, dbias)."""
    dxhat = dy * scale
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return rs * (dxhat - m1 - xhat * m2), (dy * xhat).sum(0), dy.sum(0)


def _bwd_math(x: torch.Tensor, g: torch.Tensor, params: Sequence[torch.Tensor],
              num_heads: int, cd: torch.dtype):
    """The backward's math on whole tensors, but for the four weight
    products: ``(dx, vectors, operands)``, the eight vector gradients in
    :data:`PARAM_NAMES` order and the eight ``[n, *]`` f32 row operands of
    the weight products in the workspace's order (y1, dqkv, a, dh2, y2,
    dz1, u, g)."""
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.float() for p in params)
    b, t, d = x.shape
    n, dh = b * t, d // num_heads
    scale = dh ** -0.5

    def heads(a):                                      # [n, d] -> [B, T, H, dh]
        return a.reshape(b, t, num_heads, dh)

    # ---- the forward, keeping what the VJP reads ----
    h = x.float().reshape(n, d)
    y1, xhat1, rs1 = _ln_fwd(h, g1, b1)
    qkv = _dot(y1, wqkv, cd) + bqkv
    q, k, v = heads(qkv[:, :d] * scale), heads(qkv[:, d:2 * d]), heads(qkv[:, 2 * d:])
    scores = (q[:, :, None] * k[:, None, :]).sum(-1)   # [B, Ti, Tj, H]
    probs = torch.softmax(scores, dim=2)
    attn = (probs[..., None] * v[:, None]).sum(2).reshape(n, d)
    h2 = h + _dot(attn, wproj, cd) + bproj
    y2, xhat2, rs2 = _ln_fwd(h2, g2, b2)
    z1 = _dot(y2, w1, cd) + bm1
    m1 = F.gelu(z1, approximate='tanh')

    # ---- the VJP ----
    go = g.float().reshape(n, d)
    dbm2 = go.sum(0)
    dz1 = _dot(go, w2.t(), cd) * _gelu_tanh_grad(z1)
    dbm1 = dz1.sum(0)
    dh2_ln, dg2, db2 = _ln_bwd(_dot(dz1, w1.t(), cd), xhat2, rs2, g2)
    dh2 = go + dh2_ln
    dbproj = dh2.sum(0)
    da = heads(_dot(dh2, wproj.t(), cd))               # [B, Ti, H, dh]
    dv = (probs[..., None] * da[:, :, None]).sum(1)    # [B, Tj, H, dh]
    dp = (da[:, :, None] * v[:, None]).sum(-1)         # [B, Ti, Tj, H]
    ds = probs * (dp - (probs * dp).sum(2, keepdim=True))
    dk = (ds[..., None] * q[:, :, None]).sum(1)        # q carries the scale
    dq = (ds[..., None] * k[:, None]).sum(2) * scale
    dqkv = torch.cat([a.reshape(n, d) for a in (dq, dk, dv)], dim=1)
    dbqkv = dqkv.sum(0)
    dh_ln, dg1, db1 = _ln_bwd(_dot(dqkv, wqkv.t(), cd), xhat1, rs1, g1)
    dx = (dh2 + dh_ln).reshape(b, t, d)
    return (dx, (dg1, db1, dbqkv, dbproj, dg2, db2, dbm1, dbm2),
            (y1, dqkv, attn, dh2, y2, dz1, m1, go))


def encoder_layer_bwd_reference(x: torch.Tensor, g: torch.Tensor,
                                params: Sequence[torch.Tensor], num_heads: int,
                                compute_dtype: torch.dtype = torch.bfloat16
                                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version of the backward kernels: ``(dx, grads)`` for the
    upstream gradient ``g``, ``grads`` in :data:`PARAM_NAMES` order, f32.

    The math of ``pallas_encoder.py::_encoder_bwd_math`` on whole tensors:
    the forward of :func:`encoder_layer_reference` recomputed from ``x``,
    then the VJP written out by hand, every matmul operand (activations,
    gradients, weights and their transposes) rounded to ``compute_dtype``
    and summed in f32; the vector gradients are f32 sums of unrounded terms.
    """
    cd = compute_dtype
    dx, vectors, (y1, dqkv, attn, dh2, y2, dz1, m1, go) = _bwd_math(
        x, g, params, num_heads, cd)
    dg1, db1, dbqkv, dbproj, dg2, db2, dbm1, dbm2 = vectors
    dwqkv = _dot(y1.t(), dqkv, cd)
    dwproj = _dot(attn.t(), dh2, cd)
    dw1 = _dot(y2.t(), dz1, cd)
    dw2 = _dot(m1.t(), go, cd)
    return dx, (dg1, db1, dwqkv, dbqkv, dwproj, dbproj, dg2, db2,
                dw1, dbm1, dw2, dbm2)


def encoder_bwd_workspace_reference(x: torch.Tensor, g: torch.Tensor,
                                    params: Sequence[torch.Tensor], num_heads: int
                                    ) -> torch.Tensor:
    """The workspace the backward's tile kernels write for the
    weight-gradient stage, by the plain version's math: the eight row
    operands of the weight products rounded to bf16, ``[n, *]`` arrays end
    to end in the order y1 ``[n, d]``, dqkv ``[n, 3 d]``, a, dh2, y2 (each
    ``[n, d]``), dz1, u (each ``[n, m]``), g ``[n, d]``; flat, ``n (8 d +
    2 m)`` values. :func:`encoder_wgrad` of it gives the weight gradients of
    :func:`encoder_layer_bwd_reference`."""
    _, _, operands = _bwd_math(x, g, params, num_heads, torch.bfloat16)
    return torch.cat([a.to(torch.bfloat16).reshape(-1) for a in operands])


def plan_bwd_tile(t: int, d: int, m: int, num_heads: int
                  ) -> Tuple[int, int, int, int]:
    """``(row_tiles, windows, chunk, smem_bytes)`` of a block of the
    backward's tile kernel, as ``csrc/fused_encoder_bwd.cu`` lays it out;
    raises if the kernel cannot take the shape.

    The limits on ``d``, ``m``, the head width and ``t`` are the forward's.
    A block holds, in shared memory, three f32 and one bf16 ``[rows, d]``
    buffers, the f32 q/k/v ``[rows, 3 d]`` (the MLP phase reuses that space
    for a chunk of ``chunk`` hidden columns) and the attention's
    probabilities, so its row tile is smaller than the forward's: 32 rows
    (three windows of 10 frames) at ``d = 256``, 48 at ``d = 128``, 16 at
    ``d = 384`` and ``d = 512``; ``d`` above 512 with a 4x MLP does not fit.
    """
    plan_tile(t, d, m, num_heads)          # the forward's limits on the shape
    chunk = 256 if d >= 256 and m % 256 == 0 else 128
    for row_tiles in range(_MAX_ROW_TILES, 0, -1):
        rows = 16 * row_tiles
        if rows < t:
            break
        windows = rows // t
        h_bytes = rows * (d + _PAD) * 4
        ab_bytes = rows * (d + _PAD) * 2
        mlp_bytes = ab_bytes + rows * (chunk + _PAD) * 6
        big = max(rows * (3 * d + _PAD) * 4, mlp_bytes)
        ps_bytes = -(-(2 * 4 * windows * num_heads * t * t) // 16) * 16
        smem = 2 * h_bytes + ab_bytes + big + ps_bytes + 4 * rows * 4
        if smem <= MAX_SMEM:
            return row_tiles, windows, chunk, smem
    raise ValueError(f'fused encoder backward kernel: a window of {t} frames '
                     f'at d_model {d}, MLP width {m} does not fit the '
                     f'{MAX_SMEM} bytes of shared memory a block may use')


def bwd_split(items: int, nk: int) -> int:
    """Parts the small backward shape splits a product's ``nk`` k-steps
    into, where ``items`` (products x 16-column blocks) leave warps idle: the
    most with which every item's parts still fit the 16 warps and each part
    is whole chunks of 4 k-steps (the kernel checks its end once a chunk).
    ``csrc/fused_encoder_bwd.cu::small_split`` is the same rule."""
    best = 1
    for split in range(2, _WARPS + 1):
        if items * split <= _WARPS and nk % split == 0 and (nk // split) % 4 == 0:
            best = split
    return best


def bwd_products(d: int, m: int, cluster: int
                 ) -> Tuple[Tuple[str, int, int, int], ...]:
    """The small backward shape's products as one block of a cluster of
    ``cluster`` runs them: ``(name, products, 16-column blocks, k-steps)``.
    A block owns ``d / C`` columns (whole heads) of every d-wide output and
    ``m / C`` of the MLP's hidden ones; the two MLP products that meet in
    dz1 (y2 W1 and g W2^T) run as one item list."""
    nd, nm = d // 16 // cluster, m // 16 // cluster
    return (('qkv', 1, 3 * nd, d // 16), ('proj', 1, nd, d // 16),
            ('mlp', 2, nm, d // 16), ('dy2', 1, nd, m // 16),
            ('da', 1, nd, d // 16), ('dy1', 1, nd, 3 * d // 16))


def bwd_columns(d: int, m: int, num_heads: int, cluster: int, rank: int
                ) -> Tuple[range, range, range]:
    """Which columns block ``rank`` of a small-shape cluster owns: its heads,
    its ``d / C`` columns of every d-wide output (the same columns as those
    heads' q, k or v), and its ``m / C`` hidden columns."""
    mine = num_heads // cluster
    gw, gm = d // cluster, m // cluster
    return (range(rank * mine, (rank + 1) * mine), range(rank * gw, (rank + 1) * gw),
            range(rank * gm, (rank + 1) * gm))


@dataclass(frozen=True)
class BwdPlan:
    """The launch :func:`plan_encoder_bwd` chose for the backward's tile
    kernel; the weight-gradient kernel and the reduce launch the same way
    after either, :data:`BWD_LAUNCHES_PER_LAYER` launches a call.

    ``shape`` is ``'small'`` (a cluster of ``cluster`` blocks shares a row
    tile of ``windows`` whole windows; each block owns 1/C of every
    product's output columns, :func:`bwd_columns`, and hands them to the
    others in six exchanges), ``'pair'`` (clusters of two blocks, each
    block its own tile of ``windows`` windows with all the columns, both fed
    by one stream of weights: :func:`_bwd_pair_layout`) or ``'large'`` (one
    persistent block a tile, all the columns, :func:`plan_bwd_tile`,
    ``chunk`` hidden columns at a time). ``row_tiles`` 16-row mma tiles make
    ``rows``. The small shape's
    shared memory, offsets in bytes from the f32 residual ``[rows, d + 8]``
    at 0: ``off_y`` the LayerNorm outputs, later dh2 (bf16) and then the
    attention's f32 da; ``off_a`` the attention output, later g (bf16) and
    then dk (f32); ``off_q`` this block's f32 q/k/v (stride ``ld_q``);
    ``off_z`` the full dz1 (bf16, stride ``ld_z``), later the full dqkv
    (``ld_dq``); ``off_f`` dy2, later dy1 (f32 ``[rows, d + 8]``); ``off_s``
    the products' partial sums (``scratch_floats``); ``off_v`` the eight f32
    rows; ``off_p`` the attention's P and dS; ``off_st`` the two
    LayerNorms' means and 1/std; ``off_bar`` six mbarriers. The pair
    shape's, at d = 256 (stride ``ld_q`` of its bf16 q/k/v): an f32
    ``[rows, d + 4]`` at 0 (x, h2, dh2, x again; columns d .. d + 3 the LN
    statistics), ``off_b`` bf16 ``[rows, d + 8]`` (y1, a, y2, dh2),
    ``off_q`` q/k/v and then dq/dk/dv in place, ``off_m`` g (bf16) over the
    MLP with a chunk of dz1 at ``off_dz``, then dy2 (f32), da (bf16) and dy1
    (f32); ``off_ring`` ``slots`` slots of ``slot_bytes`` of weights,
    ``off_bar`` their full and empty mbarriers.
    """
    shape: str
    cluster: int
    row_tiles: int
    windows: int
    chunk: int
    smem_bytes: int
    ld_q: int = 0
    ld_z: int = 0
    ld_dq: int = 0
    off_y: int = 0
    off_a: int = 0
    off_q: int = 0
    off_z: int = 0
    off_f: int = 0
    off_s: int = 0
    scratch_floats: int = 0
    off_v: int = 0
    off_p: int = 0
    off_st: int = 0
    off_bar: int = 0
    off_b: int = 0
    off_m: int = 0
    off_dz: int = 0
    off_ring: int = 0
    slot_bytes: int = 0
    slots: int = 0
    launches: int = BWD_LAUNCHES_PER_LAYER

    @property
    def rows(self) -> int:
        return 16 * self.row_tiles

    def tiles(self, batch: int) -> int:
        return -(-batch // self.windows)

    def as_ints(self) -> Tuple[int, ...]:
        """What ``ib_fused_encoder_backward_cluster`` (small) or
        ``ib_fused_encoder_backward_pair`` (pair) reads, in its order."""
        if self.shape == 'pair':
            return (self.windows, self.off_b, self.off_q, self.off_m, self.off_dz,
                    self.off_ring, self.off_bar, self.slot_bytes, self.slots)
        return (self.cluster, self.row_tiles, self.windows, self.ld_q, self.ld_z,
                self.ld_dq, self.off_y, self.off_a, self.off_q, self.off_z, self.off_f,
                self.off_s, self.scratch_floats, self.off_v, self.off_p, self.off_st,
                self.off_bar)

    @property
    def phases(self) -> Tuple[str, ...]:
        """What :data:`bwd_phase_clocks` gets a block of this shape."""
        return {'small': BWD_PHASES, 'pair': BWD_PAIR_PHASES}.get(self.shape, ())


def _bwd_small_layout(t: int, d: int, m: int, num_heads: int, row_tiles: int,
                      cluster: int) -> Optional[BwdPlan]:
    """The small backward shape's shared memory at one row tile; None if it
    does not fit. Buffers share room only where the kernel's order of
    exchanges keeps them apart in time (dz1 and dqkv; the products' partial
    sums and the attention's da and dk take rooms whose earlier content is
    dead in this block and no longer read by a copy to another)."""
    rows = 16 * row_tiles
    if rows < t:
        return None
    gw = d // cluster
    windows = rows // t
    ld_r, ld_q, ld_z, ld_dq = d + _PAD, 3 * gw + _PAD // 2, m + _PAD, 3 * d + _PAD
    scratch = max(n_prod * n * bwd_split(n_prod * n, nk) * rows * 16
                  for _, n_prod, n, nk in bwd_products(d, m, cluster))
    off_y = rows * ld_r * 4
    off_a = off_y + rows * ld_r * 2
    off_q = off_a + rows * ld_r * 2
    off_z = off_q + _round16(rows * ld_q * 4)
    off_f = off_z + _round16(rows * max(ld_z, ld_dq) * 2)
    off_s = off_f + rows * ld_r * 4
    off_v = off_s + scratch * 4
    off_p = off_v + (9 * d + m) * 4
    off_st = off_p + _round16(2 * windows * (num_heads // cluster) * t * t * 4)
    off_bar = off_st + 4 * rows * 4
    end = off_bar + 8 * _BWD_EXCHANGES
    if end > MAX_SMEM:
        return None
    return BwdPlan('small', cluster, row_tiles, windows, 0, end, ld_q, ld_z, ld_dq,
                   off_y, off_a, off_q, off_z, off_f, off_s, scratch, off_v, off_p,
                   off_st, off_bar)


def pair_takes(t: int, d: int, m: int, num_heads: int) -> bool:
    """Whether the backward's pair shape takes the shape: d = 256 (its
    layout fills the shared memory there), at most 16 frames (a window's
    attention is one 16 x 16 mma tile), a head width of 16, 32 or 64, and
    an MLP width of whole 256-column chunks. The large tile takes the
    others (d = 128, 384, 512; T = 17 .. 48; one or two heads)."""
    return (d == PAIR_D and 1 <= t <= _PAIR_MAX_FRAMES and m > 0 and m % _PAIR_CHUNK == 0
            and d % num_heads == 0 and d // num_heads in _PAIR_HEAD_WIDTHS)


def _bwd_pair_layout(t: int, d: int, m: int, num_heads: int) -> Optional[BwdPlan]:
    """The pair shape's shared memory (:class:`BwdPlan`); None where it
    does not take the shape (:func:`pair_takes`).

    Why 32-row tiles on clusters of two rather than a 64-row tile: the
    proven 32-row passes stay, and a weight byte read from L2 serves 64
    rows. To leave room for a ring of 32 KB slots beside them, q/k/v stay
    bf16 (the attention runs on mma, whose operands they are), the
    attention's P and dS stay in registers, the MLP's gelu' is used in the
    epilogue that makes it, dy2 accumulates in registers over the chunks,
    and the LN statistics lie in the f32 rows' padding. Buffers share room
    only where their live spans do not meet: g, the dz1 chunk, dy2, da
    and dy1 take turns at ``off_m``."""
    if not pair_takes(t, d, m, num_heads):
        return None
    rows = _PAIR_ROWS
    ld_f, ld_b, ld_q = d + 4, d + _PAD, 3 * d + _PAD
    off_b = rows * ld_f * 4
    off_q = off_b + rows * ld_b * 2
    off_m = off_q + rows * ld_q * 2
    off_dz = off_m + rows * ld_b * 2
    off_ring = off_dz + rows * ld_b * 2
    off_bar = off_ring + _SLOTS * _SLOT_BYTES
    smem = off_bar + 2 * _SLOTS * 8
    if smem > MAX_SMEM:
        return None
    return BwdPlan('pair', 2, rows // 16, rows // t, _PAIR_CHUNK, smem, ld_q=ld_q,
                   off_q=off_q, off_bar=off_bar, off_b=off_b, off_m=off_m, off_dz=off_dz,
                   off_ring=off_ring, slot_bytes=_SLOT_BYTES, slots=_SLOTS)


def bwd_pair_stream(m: int) -> Tuple[Tuple[str, int, int, int], ...]:
    """The fills of the pair shape's weight ring for one tile, in the order
    both the producer and the consumers walk them: ``(weight, k-steps of
    the weight, first of the fill's 16 column blocks, first of its 4
    k-steps)``, weights in :class:`PackedEncoderLayer` fragment order
    (``wqkv`` ... of ``weights``, ``wqkv_t`` ... of ``weights_t``)."""
    d = PAIR_D
    fills = []

    def put(name, nk, b0, ks0, k_steps):
        fills.extend((name, nk, b0, ks) for ks in range(ks0, ks0 + k_steps, _SLOT_KS))

    for grp in range(3):
        put('wqkv', d // 16, 16 * grp, 0, d // 16)
    put('wproj', d // 16, 0, 0, d // 16)
    for c0 in range(0, m, _PAIR_CHUNK):
        put('wmlp1', d // 16, c0 // 16, 0, d // 16)
        put('wmlp2_t', d // 16, c0 // 16, 0, d // 16)
        put('wmlp1_t', m // 16, 0, c0 // 16, _PAIR_CHUNK // 16)
    put('wproj_t', d // 16, 0, 0, d // 16)
    put('wqkv_t', 3 * d // 16, 0, 0, 3 * d // 16)
    return tuple(fills)


def bwd_thresholds(shape: str) -> Tuple[int, int]:
    """``(BWD_SMALL_BATCH_MAX, BWD_PAIR_BATCH_MIN)`` with which ``shape``
    takes every batch it can (tests and ``ops/tune.py`` set them so)."""
    return {'small': (1 << 30, 1 << 30), 'pair': (0, 0), 'large': (0, 1 << 30)}[shape]


def plan_encoder_bwd(batch: int, t: int, d: int, m: int, num_heads: int) -> BwdPlan:
    """Which shape of the backward's tile kernel takes ``batch`` windows of
    ``t`` frames at width ``d``, MLP width ``m`` and ``num_heads`` heads, and
    its layout; a function of these alone. Raises for a shape outside the
    kernels' envelope (:func:`plan_bwd_tile`).

    Small, up to :data:`BWD_SMALL_BATCH_MAX` windows where the heads split
    over a cluster (:func:`small_cluster`) and a row tile fits: the fewest
    mma row tiles with which the batch's clusters all run at once, else the
    most that fit. Else pair, from :data:`BWD_PAIR_BATCH_MIN` windows where
    it takes the shape (:func:`pair_takes`). Otherwise large:
    :func:`plan_bwd_tile`'s tile.
    """
    return _plan_encoder_bwd(batch, t, d, m, num_heads, BWD_SMALL_BATCH_MAX,
                             BWD_PAIR_BATCH_MIN)


@functools.lru_cache(maxsize=256)
def _plan_encoder_bwd(batch: int, t: int, d: int, m: int, num_heads: int,
                      small_batch_max: int, pair_batch_min: int) -> BwdPlan:
    """:func:`plan_encoder_bwd` at given thresholds, computed once a shape."""
    row_tiles, windows, chunk, smem = plan_bwd_tile(t, d, m, num_heads)
    cluster = small_cluster(d, num_heads)
    if batch <= small_batch_max and cluster > 1:
        fits = [p for p in (_bwd_small_layout(t, d, m, num_heads, rt, cluster)
                            for rt in range(1, _MAX_ROW_TILES + 1)) if p]
        if fits:
            at_once = [p for p in fits
                       if p.tiles(batch) * cluster <= _SMALL_BLOCKS_AT_ONCE]
            return (at_once or fits[::-1])[0]
    pair = _bwd_pair_layout(t, d, m, num_heads) if batch >= pair_batch_min else None
    return pair or BwdPlan('large', 1, row_tiles, windows, chunk, smem)


def bwd_blocks(plan: BwdPlan, batch: int, sms: int) -> int:
    """Blocks of the tile kernel in ``plan`` at ``batch`` on a card of
    ``sms`` multiprocessors: a cluster a tile (small), a pair of blocks a
    pair of tiles up to one block an SM (pair), one block a tile up to one
    an SM (large). Each block sums into its own slab of vector gradients."""
    tiles = plan.tiles(batch)
    if plan.shape == 'small':
        return tiles * plan.cluster
    if plan.shape == 'pair':
        return 2 * min(-(-tiles // 2), sms // 2)
    return min(tiles, sms)


def wgrad_products(d: int, m: int) -> Tuple[Tuple[int, int, int], ...]:
    """The weight-gradient stage's four products A^T G (dWqkv = y1^T dqkv,
    dWproj = a^T dh2, dW1 = y2^T dz1, dW2 = u^T g) as ``(rows, cols,
    offset)``: the output's shape and its offset in the flat gradient."""
    return ((d, 3 * d, 0), (d, d, 3 * d * d), (d, m, 4 * d * d), (m, d, 4 * d * d + d * m))


@functools.lru_cache(maxsize=None)
def wgrad_tiles(d: int, m: int, tile_n: int) -> Tuple[Tuple[int, int, int, int], ...]:
    """The output tiles ``(product, i0, j0, columns)`` of the stage in its
    order (``csrc/fused_encoder_bwd.cu::wg_tile``): the products in the flat
    gradient's order, then blocks of 128 rows, then of ``tile_n`` columns,
    the last of a row of tiles 128 wide where ``tile_n`` does not divide."""
    return tuple((p, i0, j0, min(tile_n, cols - j0))
                 for p, (rows, cols, _) in enumerate(wgrad_products(d, m))
                 for i0 in range(0, rows, _WG_M) for j0 in range(0, cols, tile_n))


@dataclass(frozen=True)
class WgradPlan:
    """The weight-gradient stage's schedule: output tiles of 128 rows by
    ``tile_n`` columns (:func:`wgrad_tiles`), the ``n`` rows cut into
    ranges of ``boxes_per_split`` 64-row boxes (the last range may be
    shorter, the last box ragged: its rows past ``n`` arrive as zeros);
    item ``s * len(tiles) + t`` is tile ``t`` over range ``s``, and
    ``blocks(sms)`` persistent blocks walk the items, block b the items b,
    b + blocks, .... The reduce adds the ranges' partial tiles in range
    order; with one range the kernel writes the gradient itself."""
    n: int
    d: int
    m: int
    tile_n: int
    boxes_per_split: int

    @property
    def boxes(self) -> int:
        return -(-self.n // _WG_BOX)

    @property
    def splits(self) -> int:
        return -(-self.boxes // self.boxes_per_split)

    @property
    def tiles(self) -> Tuple[Tuple[int, int, int, int], ...]:
        return wgrad_tiles(self.d, self.m, self.tile_n)

    @property
    def items(self) -> int:
        return len(self.tiles) * self.splits

    @property
    def partials(self) -> int:
        """Partial gradients the reduce adds (none with one range: the kernel
        writes the gradient itself)."""
        return self.splits if self.splits > 1 else 0

    @property
    def stage_launches(self) -> int:
        """Launches of the stage alone (:func:`encoder_wgrad`): the kernel,
        and the reduce where there are partials to add."""
        return 1 + (self.partials > 0)

    def rows(self, split: int) -> Tuple[int, int]:
        """The rows ``[r0, r1)`` of range ``split``."""
        r0 = split * self.boxes_per_split * _WG_BOX
        return r0, min(self.n, r0 + self.boxes_per_split * _WG_BOX)

    def blocks(self, sms: int) -> int:
        return min(self.items, sms)

    def as_ints(self, sms: int) -> Tuple[int, int, int, int]:
        """What ``csrc/fused_encoder_bwd.cu`` takes: tile_n, splits,
        boxes_per_split, blocks."""
        return self.tile_n, self.splits, self.boxes_per_split, self.blocks(sms)


def _wgrad_cost(plan: WgradPlan) -> float:
    """Modelled us of the stage on an H100 (see ``_WG_BOX_US``): the longer
    of each wave of items' longest range of boxes with an item's start and
    store, and the workspace and the partial tiles through device memory;
    then the reduce, a partial gradient a range."""
    waves = -(-plan.items // _WG_SMS)
    w_total = 4 * plan.d * plan.d + 2 * plan.d * plan.m
    blocks = waves * (plan.boxes_per_split * _WG_BOX_US[plan.tile_n] + _WG_ITEM_US)
    memory = (plan.n * (8 * plan.d + 2 * plan.m) * 2 + plan.splits * w_total * 4) \
        / _WG_BYTES_PER_US
    return max(blocks, memory) + plan.splits * _WG_SPLIT_US_PER_MOUT * w_total / 1e6


@functools.lru_cache(maxsize=None)
def plan_wgrad(n: int, d: int, m: int) -> WgradPlan:
    """The weight-gradient stage's plan for ``n`` rows at widths ``d`` and
    ``m`` (multiples of 128): a function of the shape alone, so that the
    order of every sum is fixed. Of the tile widths and up to
    ``_WG_MAX_SPLITS`` ranges, the one the cost model (:func:`_wgrad_cost`)
    finds fastest; on a tie, fewer ranges, then wider tiles. More ranges
    fill more of the card, but each adds a partial gradient written and read
    back, which on an H100 costs more than the idle multiprocessors do at B =
    64 and 4096 (PERF.md §6)."""
    if n < 1 or d < 128 or d % 128 or m < 128 or m % 128:
        raise ValueError(f'plan_wgrad takes n >= 1 and d, m multiples of 128, got '
                         f'n={n} d={d} m={m}')
    boxes = -(-n // _WG_BOX)
    plans = {WgradPlan(n, d, m, tile_n, -(-boxes // s))
             for tile_n in _WG_TILE_N for s in range(1, min(boxes, _WG_MAX_SPLITS) + 1)}
    return min(plans, key=lambda p: (_wgrad_cost(p), p.splits, -p.tile_n))


def encoder_wgrad_reference(ws: torch.Tensor, n: int, d: int, m: int
                            ) -> Tuple[torch.Tensor, ...]:
    """Plain version of the weight-gradient stage: ``(dWqkv, dWproj, dW1,
    dW2)``, f32, the products A^T G of the bf16 workspace's views (the
    layout of :func:`encoder_bwd_workspace_reference`) summed in f32."""
    widths = (d, 3 * d, d, d, d, m, m, d)
    views = ws.reshape(-1)[:n * sum(widths)].split([n * w for w in widths])
    y1, dqkv, attn, dh2, y2, dz1, u, go = (v.view(n, w).float() for v, w in zip(views, widths))
    return tuple(a.t() @ b for a, b in ((y1, dqkv), (attn, dh2), (y2, dz1), (u, go)))


def encoder_wgrad(ws: torch.Tensor, n: int, d: int, m: int,
                  plan: Optional[WgradPlan] = None) -> Tuple[torch.Tensor, ...]:
    """The weight-gradient stage alone on a bf16 workspace of ``n`` rows
    (the layout of :func:`encoder_bwd_workspace_reference`): ``(dWqkv,
    dWproj, dW1, dW2)``, f32, ``[in, out]``. A CUDA tensor launches the
    stage's kernels in ``plan`` (default :func:`plan_wgrad`'s; the reduce
    only where it has more than one range) or raises; a CPU tensor takes :func:`encoder_wgrad_reference`; any other
    device raises."""
    global wgrad_launches
    want = n * (8 * d + 2 * m)
    if ws.dtype != torch.bfloat16 or ws.numel() != want or not ws.is_contiguous():
        raise ValueError(f'encoder_wgrad takes a contiguous bf16 workspace of n (8 d + 2 m) = '
                         f'{want} values, got {ws.dtype} {tuple(ws.shape)}')
    if ws.device.type == 'cpu':
        return encoder_wgrad_reference(ws, n, d, m)
    if ws.device.type != 'cuda':
        raise ValueError(f'encoder_wgrad: no kernel for device {ws.device}')
    if ws.data_ptr() % 16:
        raise ValueError('encoder_wgrad takes a 16-byte aligned workspace')
    plan = plan or plan_wgrad(n, d, m)
    if (plan.n, plan.d, plan.m) != (n, d, m):
        raise ValueError(f'a plan for {(plan.n, plan.d, plan.m)} given for {(n, d, m)}')
    w_total = 4 * d * d + 2 * d * m
    f32 = dict(dtype=torch.float32, device=ws.device)
    out = torch.empty(w_total, **f32)
    wpart = torch.empty(plan.partials * w_total, **f32)
    ints = plan.as_ints(torch.cuda.get_device_properties(ws.device).multi_processor_count)
    lib = _build.library()
    with torch.cuda.device(ws.device):
        stream = torch.cuda.current_stream(ws.device).cuda_stream
        code = lib.ib_encoder_wgrad(ws.data_ptr(), n, d, m, (ctypes.c_int * 4)(*ints),
                                    wpart.data_ptr(), out.data_ptr(), stream)
    _build.check(lib, code, 'encoder_wgrad launch')
    wgrad_launches += plan.stage_launches
    return tuple(out[off:off + rows * cols].view(rows, cols)
                 for rows, cols, off in wgrad_products(d, m))


def _split_grads(flat: torch.Tensor, d: int, m: int) -> Tuple[torch.Tensor, ...]:
    """The kernel's flat gradient (the four kernels, then the eight rows in
    ``rows`` order) as views in :data:`PARAM_NAMES` order."""
    sizes = [3 * d * d, d * d, d * m, m * d, d, d, 3 * d, d, d, d, m, d]
    dwqkv, dwproj, dw1, dw2, dg1, db1, dbqkv, dbproj, dg2, db2, dbm1, dbm2 = (
        flat.split(sizes))
    return (dg1, db1, dwqkv.view(d, 3 * d), dbqkv, dwproj.view(d, d), dbproj,
            dg2, db2, dw1.view(d, m), dbm1, dw2.view(m, d), dbm2)


def fused_encoder_layer_bwd(x: torch.Tensor, g: torch.Tensor,
                            packed: PackedEncoderLayer, num_heads: int
                            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``(dx, grads)`` of the layer at ``x`` for the upstream gradient ``g``
    (both [B, T, d] float32), ``grads`` f32 in :data:`PARAM_NAMES` order.

    A CUDA tensor launches the backward kernels (three launches, the tile
    kernel in the shape :func:`plan_encoder_bwd` picks; two calls on the
    same inputs give bitwise equal results) or raises; a CPU tensor
    takes :func:`encoder_layer_bwd_reference`; any other device raises.
    """
    global bwd_launches
    if x.shape != g.shape:
        raise ValueError(f'x {tuple(x.shape)} and g {tuple(g.shape)} differ')
    if x.device.type == 'cpu':
        return encoder_layer_bwd_reference(x, g, packed.params, num_heads)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_encoder_layer_bwd: no kernel for device {x.device}')
    for name, a in (('x', x), ('g', g)):
        if (a.dtype != torch.float32 or a.ndim != 3 or not a.is_contiguous()
                or a.data_ptr() % 16 or a.device != x.device):
            raise ValueError(f'fused_encoder_layer_bwd takes contiguous, 16-byte '
                             f'aligned float32 [B, T, d] tensors on one device, '
                             f'got {name} {a.dtype} {tuple(a.shape)} on {a.device}')
    batch, t, d = x.shape
    m = packed.mlp_dim
    if d != packed.d_model:
        raise ValueError(f'input width {d} != packed d_model {packed.d_model}')
    if packed.device != x.device:
        raise ValueError(f'weights on {packed.device}, input on {x.device}')
    if packed.weights_t is None:
        raise ValueError('the backward needs the transposed weights: pack with '
                         'pack_encoder_params(..., transposes=True)')
    plan = plan_encoder_bwd(max(batch, 1), t, d, m, num_heads)
    n_rows = batch * t
    w_total, n_vec = 4 * d * d + 2 * d * m, 9 * d + m
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    flat = torch.empty(w_total + n_vec, **f32)
    if batch == 0:
        return dx, _split_grads(flat.zero_(), d, m)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    grid = bwd_blocks(plan, batch, sms)
    wplan = plan_wgrad(n_rows, d, m)
    wints = (ctypes.c_int * 4)(*wplan.as_ints(sms))
    ws = torch.empty(n_rows * (8 * d + 2 * m), dtype=torch.bfloat16, device=x.device)
    vpart = torch.empty(grid * n_vec, **f32)
    wpart = torch.empty(wplan.partials * w_total, **f32)
    lib = _build.library()
    clocks = None
    if bwd_phase_clocks is not None and plan.phases:
        need = grid * len(plan.phases)
        if (bwd_phase_clocks.dtype != torch.int64 or bwd_phase_clocks.device != x.device
                or bwd_phase_clocks.numel() < need):
            raise ValueError(f'bwd_phase_clocks: an int64 tensor on {x.device} of at least '
                             f'{need} elements')
        clocks = bwd_phase_clocks.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        ints = plan.as_ints()
        if plan.shape == 'small':
            code = lib.ib_fused_encoder_backward_cluster(
                x.data_ptr(), g.data_ptr(), batch, t, d, m, num_heads,
                packed.weights.data_ptr(), packed.weights_t.data_ptr(),
                packed.rows.data_ptr(), dx.data_ptr(), flat.data_ptr(),
                ws.data_ptr(), vpart.data_ptr(), wpart.data_ptr(),
                (ctypes.c_int * len(ints))(*ints), plan.smem_bytes, wints, clocks, stream)
        elif plan.shape == 'pair':
            code = lib.ib_fused_encoder_backward_pair(
                x.data_ptr(), g.data_ptr(), batch, t, d, m, num_heads,
                packed.weights.data_ptr(), packed.weights_t.data_ptr(),
                packed.rows.data_ptr(), dx.data_ptr(), flat.data_ptr(),
                ws.data_ptr(), vpart.data_ptr(), wpart.data_ptr(),
                (ctypes.c_int * len(ints))(*ints), plan.smem_bytes, grid, wints, clocks,
                stream)
        else:
            scratch = torch.empty(grid * plan.rows * 3 * d, **f32)
            code = lib.ib_fused_encoder_backward(
                x.data_ptr(), g.data_ptr(), batch, t, d, m, num_heads,
                packed.weights.data_ptr(), packed.weights_t.data_ptr(),
                packed.rows.data_ptr(), dx.data_ptr(), flat.data_ptr(),
                ws.data_ptr(), scratch.data_ptr(), vpart.data_ptr(),
                wpart.data_ptr(), plan.row_tiles, grid, wints, stream)
    _build.check(lib, code, 'fused_encoder_layer_bwd launch')
    bwd_launches += plan.launches
    bwd_shape_launches[plan.shape] += 1
    return dx, _split_grads(flat, d, m)


class FusedEncoderLayerFn(torch.autograd.Function):
    """The differentiable fused layer: ``apply(x, packed, num_heads,
    *params)`` with ``params`` the 12 tensors of :data:`PARAM_NAMES` that
    ``packed`` was made from (with ``transposes=True``).

    Forward is :func:`fused_encoder_layer`; only ``x`` is saved (the
    parameters live in ``packed``). Backward is
    :func:`fused_encoder_layer_bwd`, which recomputes the forward; it
    returns the gradients of ``x`` and of the 12 parameters.
    """

    @staticmethod
    def forward(ctx, x, packed, num_heads, *params):
        if len(params) != len(PARAM_NAMES):
            raise ValueError(f'expected {len(PARAM_NAMES)} parameters, got {len(params)}')
        ctx.save_for_backward(x)
        ctx.packed, ctx.num_heads = packed, num_heads
        ctx.param_dtypes = tuple(p.dtype for p in params)
        return fused_encoder_layer(x, packed, num_heads)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        dx, grads = fused_encoder_layer_bwd(x, g.contiguous(), ctx.packed,
                                            ctx.num_heads)
        return (dx, None, None,
                *(gr.to(dt) for gr, dt in zip(grads, ctx.param_dtypes)))
