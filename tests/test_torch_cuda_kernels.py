"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a GPU. On a machine with one (no jax
there, so skip the JAX-side conftest):

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -m cuda -q
"""

import math
import time

import pytest
import torch

from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm
from inferbiomechanics_tpu_torch.ops.tune import random_groundlink_params

pytestmark = pytest.mark.cuda

# one bf16 ulp below 2.0 (7.8e-3): the kernel and the plain version sum the
# f32 products in another order, which can flip the last bf16 rounding
ATOL = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU')
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain version's f32 matmuls
    return torch.device('cuda')


FULL = [1770, 512, 512, 30]
EDGE = fm.SMALL_BATCH_MAX       # the largest batch of K1's small-batch kernel


@pytest.mark.parametrize('batch,dims,activation', [
    # both kernels, either side of the batch where the choice turns, full and
    # ragged tiles, odd batches (rows the tensor map of x cannot hold)
    *[(b, FULL, 'sigmoid') for b in (1, 2, 17, 63, 64, 65, EDGE - 1, EDGE, EDGE + 1,
                                     4096, 4099)],
    *[(b, FULL, a) for b in (33, EDGE + 33) for a in ('relu', 'tanh', 'gelu', 'elu')],
    (37, [1770, 512, 512, 300], 'gelu'),
    (5, [708, 64, 48, 30], 'elu'),            # widths that 64 does not divide
    (300, [708, 64, 48, 30], 'elu'),
    (70, [177, 256, 256, 256, 30], 'tanh'),
    (300, [177, 256, 256, 256, 30], 'tanh'),
    (9, [33, 30], 'relu'),                    # one layer, an odd input width
    (250, [33, 30], 'relu'),
    (3, [100] + [72] * 7 + [30], 'sigmoid'),  # eight layers
    (260, [100] + [72] * 7 + [30], 'sigmoid'),
    (16, [2048, 1024, 1024], 'sigmoid'),      # the stated maximum widths
    (200, [2048, 1024, 1024], 'sigmoid'),
])
def test_fused_mlp_kernel_matches_plain(cuda, batch, dims, activation):
    gen = torch.Generator().manual_seed(batch)
    params = [((torch.rand(d0, d1, generator=gen) * 2 - 1) / d0 ** 0.5,
               (torch.rand(d1, generator=gen) * 2 - 1) / d0 ** 0.5)
              for d0, d1 in zip(dims[:-1], dims[1:])]
    packed = fm.pack_mlp_params(params, cuda)
    x = torch.randn(batch, dims[0], generator=gen).to(cuda)
    before = fm.launches
    out = fm.fused_mlp_forward(x, packed, activation)
    assert fm.launches == before + 1
    ref = fm.mlp_reference(x, packed.layers, activation)
    torch.cuda.synchronize()
    assert out.shape == (batch, dims[-1]) and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=0, atol=ATOL)


def random_encoder_params(gen, d, m):
    """Seeded parameters whose biases and LayerNorm rows are not the zeros
    and ones of ``init_encoder_params``, so that a wrong bias add shows."""
    params = list(fe.init_encoder_params(gen, d, m // d))
    for i, p in enumerate(params):
        if p.ndim == 1:
            noise = torch.randn(p.shape, generator=gen)
            params[i] = (1.0 + 0.2 * noise) if i in (0, 6) else 0.3 * noise
    return tuple(params)


# the JAX suite's tolerance for the Pallas kernel against its reference in
# bf16 (tests/test_pallas_encoder.py) is rtol = atol = 5e-2; the kernel and
# the plain version differ only in the order of the f32 sums and in bf16
# roundings that those flip, which stays below 1e-2 on outputs of a few units
ENC_TOL = dict(rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize('batch,t,d,heads,mlp_ratio', [
    (1, 10, 256, 8, 4),
    (37, 10, 256, 8, 4),
    (4096, 10, 256, 8, 4),
    (37, 4, 128, 4, 4),
    (37, 10, 384, 8, 4),      # 48-wide heads, two row tiles
    (5, 7, 128, 4, 2),        # a frame count with no unrolled attention
    (3, 16, 768, 8, 4),       # the widest d_model the kernel takes
    (2, 48, 256, 8, 4),       # the longest window
    (300, 48, 256, 8, 4),     # ... in the large shape
    (300, 16, 768, 8, 4),     # the widest d_model in the large shape
    (300, 10, 384, 8, 4),     # 48-wide heads in the large shape
    (300, 10, 128, 64, 4),    # 2-wide heads: eight a pass
    (40, 10, 128, 1, 4),      # one head: no cluster splits it, so the large shape
])
def test_fused_encoder_kernel_matches_plain(cuda, batch, t, d, heads, mlp_ratio):
    gen = torch.Generator().manual_seed(batch + t + d)
    packed = fe.pack_encoder_params(
        random_encoder_params(gen, d, d * mlp_ratio), cuda)
    x = torch.randn(batch, t, d, generator=gen).to(cuda)
    before = fe.launches
    out = fe.fused_encoder_layer(x, packed, heads)
    assert fe.launches == before + 1
    ref = fe.encoder_layer_reference(x, packed.params, heads)
    torch.cuda.synchronize()
    assert out.shape == x.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **ENC_TOL)


@pytest.mark.parametrize('shape', ['small', 'pair', 'large'])
@pytest.mark.parametrize('batch', sorted({
    1, 2, 4,
    5,                            # one past the four windows of a 48-row tile
    fe.SMALL_BATCH_MAX,           # the plan's thresholds
    fe.SMALL_BATCH_MAX + 1,
    fe.PAIR_BATCH_MIN - 1,
    fe.PAIR_BATCH_MIN,
    57, 64, 65, 128,              # one pass of pairs; the default training batch
    4099,
}))
def test_fused_encoder_kernel_both_shapes_match_plain(cuda, monkeypatch, shape, batch):
    """The served shape (T = 10, d = 256, H = 8, 4x MLP) through each of the
    forward's three shapes at every batch, the plan's thresholds moved so
    that the named shape takes it."""
    monkeypatch.setattr(fe, 'SMALL_BATCH_MAX', fe.thresholds(shape)[0])
    monkeypatch.setattr(fe, 'PAIR_BATCH_MIN', fe.thresholds(shape)[1])
    gen = torch.Generator().manual_seed(batch)
    packed = fe.pack_encoder_params(random_encoder_params(gen, 256, 1024), cuda)
    x = torch.randn(batch, 10, 256, generator=gen).to(cuda)
    before = dict(fe.shape_launches)
    out = fe.fused_encoder_layer(x, packed, 8)
    assert fe.shape_launches == {k: v + (k == shape) for k, v in before.items()}
    ref = fe.encoder_layer_reference(x, packed.params, 8)
    torch.cuda.synchronize()
    assert out.shape == x.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **ENC_TOL)


@pytest.mark.parametrize('batch,t,heads,mlp', [
    (64, 4, 16, 1024),     # eight windows a tile, heads 16 wide
    (65, 7, 8, 512),       # rows past the windows, one pair of W1 groups
    (57, 16, 4, 1024),     # two windows of 16 frames, heads 64 wide
    (128, 10, 8, 512),     # the narrowest MLP the pair takes
    (1, 1, 8, 512),        # one window of one frame, one pair of W1 groups
    (4099, 4, 16, 512),
])
def test_fused_encoder_pair_shape_matches_plain_at_other_shapes(cuda, monkeypatch, batch, t,
                                                                 heads, mlp):
    """The pair shape at the frame counts, head widths and MLP widths it
    takes besides the served one (the large shape has the others:
    test_fused_encoder_kernel_matches_plain)."""
    monkeypatch.setattr(fe, 'SMALL_BATCH_MAX', fe.thresholds('pair')[0])
    monkeypatch.setattr(fe, 'PAIR_BATCH_MIN', fe.thresholds('pair')[1])
    assert fe.plan_encoder(batch, t, 256, mlp, heads).shape == 'pair'
    gen = torch.Generator().manual_seed(batch + t)
    packed = fe.pack_encoder_params(random_encoder_params(gen, 256, mlp), cuda)
    x = torch.randn(batch, t, 256, generator=gen).to(cuda)
    before = fe.shape_launches['pair']
    out = fe.fused_encoder_layer(x, packed, heads)
    assert fe.shape_launches['pair'] == before + 1
    ref = fe.encoder_layer_reference(x, packed.params, heads)
    torch.cuda.synchronize()
    assert out.shape == x.shape and torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, **ENC_TOL)


# The backward kernels and their plain version round the same operands to
# bf16 and sum in f32 in another order, which flips bf16 roundings of the
# recomputed activations and of the gradients that are operands of later
# products. Each tensor is held to 2e-2 x its largest plain value (the JAX
# suite allows its Pallas backward 5e-2 x max against jax.vjp in bf16,
# tests/test_pallas_encoder.py).
BWD_REL = 2e-2


@pytest.mark.parametrize('batch,t,d,heads,mlp_ratio', [
    (1, 10, 256, 8, 4),
    (19, 10, 256, 8, 4),      # no multiple of the tile's three windows
    (4096, 10, 256, 8, 4),
    (37, 4, 256, 8, 4),
    (37, 10, 128, 4, 4),      # three row tiles, 128-column MLP chunks
    (700, 10, 128, 4, 2),     # several tiles a block, several row splits
    (5, 7, 128, 4, 2),        # a frame count with no unrolled attention
    (9, 10, 512, 8, 4),       # one row tile: one window a tile
])
def test_fused_encoder_bwd_kernels_match_plain(cuda, batch, t, d, heads, mlp_ratio):
    gen = torch.Generator().manual_seed(batch + t + d)
    packed = fe.pack_encoder_params(
        random_encoder_params(gen, d, d * mlp_ratio), cuda, transposes=True)
    x = torch.randn(batch, t, d, generator=gen).to(cuda)
    g = torch.randn(batch, t, d, generator=gen).to(cuda)
    before = fe.bwd_launches
    dx, grads = fe.fused_encoder_layer_bwd(x, g, packed, heads)
    assert fe.bwd_launches == before + fe.BWD_LAUNCHES_PER_LAYER
    dx2, grads2 = fe.fused_encoder_layer_bwd(x, g, packed, heads)
    ref_dx, ref_grads = fe.encoder_layer_bwd_reference(x, g, packed.params, heads)
    torch.cuda.synchronize()
    for name, got, again, ref in zip(('x',) + fe.PARAM_NAMES, (dx,) + grads,
                                     (dx2,) + grads2, (ref_dx,) + ref_grads):
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        assert torch.equal(got, again), f'{name}: two calls differ'
        err = float((got - ref).abs().max())
        assert err <= BWD_REL * float(ref.abs().max()), (name, err)


def test_fused_encoder_layer_fn_trains_through_the_kernels(cuda):
    gen = torch.Generator().manual_seed(3)
    params = [p.to(cuda).requires_grad_(True)
              for p in random_encoder_params(gen, 256, 1024)]
    x = torch.randn(19, 10, 256, generator=gen).to(cuda).requires_grad_(True)
    g = torch.randn(19, 10, 256, generator=gen).to(cuda)
    packed = fe.pack_encoder_params(params, cuda, transposes=True)
    fwd, bwd = fe.launches, fe.bwd_launches
    out = fe.FusedEncoderLayerFn.apply(x, packed, 8, *params)
    got = torch.autograd.grad(out, [x] + params, g)
    assert fe.launches == fwd + 1
    assert fe.bwd_launches == bwd + fe.BWD_LAUNCHES_PER_LAYER
    ref_dx, ref_grads = fe.encoder_layer_bwd_reference(
        x.detach(), g, packed.params, 8)
    for a, b in zip(got, (ref_dx,) + ref_grads):
        assert float((a - b).abs().max()) <= BWD_REL * float(b.abs().max())



# The weight-gradient stage against its plain version: both sum the same
# exact bf16 products in f32, in other orders (the kernel in k-steps of 16
# rows a range, the ranges in order); f32 roundings of sums as large as a
# product's largest value, a few a k-step, stay far below 1e-4 of it.
WGRAD_REL = 1e-4


@pytest.mark.parametrize('n,d,m,plan', [
    (1, 128, 128, None), (10, 256, 1024, None), (190, 256, 1024, None),
    (640, 256, 1024, None), (650, 256, 1024, None), (5120, 256, 1024, None),
    (40960, 256, 1024, None), (40990, 256, 1024, None), (2800, 128, 256, None),
    (650, 384, 1536, None), (5120, 512, 2048, None),
    (5120, 256, 1024, (128, 3)), (5120, 256, 1024, (256, 80)),   # forced plans
    (650, 384, 384, (256, 2)),
])
def test_encoder_wgrad_stage_matches_plain(cuda, n, d, m, plan):
    """The stage alone on a random bf16 workspace: every product within
    WGRAD_REL x its max|plain|, two calls bitwise equal."""
    gen = torch.Generator().manual_seed(n + d + m)
    ws = torch.randn(n * (8 * d + 2 * m), generator=gen).to(torch.bfloat16).to(cuda)
    plan = fe.plan_wgrad(n, d, m) if plan is None else fe.WgradPlan(n, d, m, *plan)
    before = fe.wgrad_launches
    one, two = fe.encoder_wgrad(ws, n, d, m, plan), fe.encoder_wgrad(ws, n, d, m, plan)
    assert fe.wgrad_launches == before + 2 * plan.stage_launches
    ref = fe.encoder_wgrad_reference(ws, n, d, m)
    torch.cuda.synchronize()
    for name, got, again, r in zip(('wqkv', 'wproj', 'wmlp1', 'wmlp2'), one, two, ref):
        assert got.shape == r.shape and torch.isfinite(got).all(), name
        assert torch.equal(got, again), f'{name}: two calls differ'
        assert float((got - r).abs().max()) <= WGRAD_REL * float(r.abs().max()), name


def _bwd_case(cuda, batch, t, d, heads, mlp_ratio=4):
    gen = torch.Generator().manual_seed(batch + t + d)
    packed = fe.pack_encoder_params(
        random_encoder_params(gen, d, d * mlp_ratio), cuda, transposes=True)
    x = torch.randn(batch, t, d, generator=gen).to(cuda)
    g = torch.randn(batch, t, d, generator=gen).to(cuda)
    return packed, x, g


def _force_bwd_shape(monkeypatch, shape):
    small, pair = fe.bwd_thresholds(shape)
    monkeypatch.setattr(fe, 'BWD_SMALL_BATCH_MAX', small)
    monkeypatch.setattr(fe, 'BWD_PAIR_BATCH_MIN', pair)


@pytest.mark.parametrize('shape,batch,t,d,heads', [
    *[(shape, b, 10, 256, 8) for shape in ('small', 'pair', 'large') for b in (1, 8, 19, 64)],
    *[(shape, b, 10, 128, 4) for shape in ('small', 'large') for b in (1, 8, 19, 64)],
    ('small', 37, 4, 256, 8),     # four windows a row tile
    ('small', 5, 7, 128, 4),      # a frame count with no unrolled attention
    ('large', 9, 10, 512, 8),     # no small shape fits d = 512
    # the pair shape past the small one's batches, its frame counts and head
    # widths; the widths it leaves to the large tile at the same batches
    *[('pair', b, 10, 256, 8) for b in (65, 128, 4099)],
    ('pair', 37, 4, 256, 8),      # eight windows a tile
    ('pair', 19, 16, 256, 16),    # two windows of 16 frames, heads 16 wide
    ('pair', 23, 7, 256, 4),      # rows past the windows, heads 64 wide
    *[('large', b, 10, d, h) for b in (65, 128, 4099) for d, h in ((128, 4), (256, 8),
                                                                    (512, 8))],
])
def test_fused_encoder_bwd_kernels_both_shapes_match_plain(cuda, monkeypatch, shape, batch, t,
                                                           d, heads):
    """Each shape of the backward's tile kernel at the same batches, the
    plan's thresholds moved so that the named shape takes them: dx and every
    gradient within BWD_REL x its max|plain|, two calls bitwise equal."""
    _force_bwd_shape(monkeypatch, shape)
    packed, x, g = _bwd_case(cuda, batch, t, d, heads)
    assert fe.plan_encoder_bwd(batch, t, d, 4 * d, heads).shape == shape
    before, launches = dict(fe.bwd_shape_launches), fe.bwd_launches
    dx, grads = fe.fused_encoder_layer_bwd(x, g, packed, heads)
    dx2, grads2 = fe.fused_encoder_layer_bwd(x, g, packed, heads)
    assert fe.bwd_shape_launches[shape] == before[shape] + 2
    assert fe.bwd_launches == launches + 2 * fe.BWD_LAUNCHES_PER_LAYER
    ref_dx, ref_grads = fe.encoder_layer_bwd_reference(x, g, packed.params, heads)
    torch.cuda.synchronize()
    for name, got, again, ref in zip(('x',) + fe.PARAM_NAMES, (dx,) + grads,
                                     (dx2,) + grads2, (ref_dx,) + ref_grads):
        assert got.shape == ref.shape and torch.isfinite(got).all(), name
        assert torch.equal(got, again), f'{name}: two calls differ'
        err = float((got - ref).abs().max())
        assert err <= BWD_REL * float(ref.abs().max()), (name, err)


@pytest.mark.parametrize('shape', ['small', 'pair', 'large'])
def test_fused_encoder_layer_fn_trains_through_each_bwd_shape(cuda, monkeypatch, shape):
    _force_bwd_shape(monkeypatch, shape)
    gen = torch.Generator().manual_seed(4)
    params = [p.to(cuda).requires_grad_(True)
              for p in random_encoder_params(gen, 256, 1024)]
    x = torch.randn(8, 10, 256, generator=gen).to(cuda).requires_grad_(True)
    g = torch.randn(8, 10, 256, generator=gen).to(cuda)
    packed = fe.pack_encoder_params(params, cuda, transposes=True)
    before = dict(fe.bwd_shape_launches)
    out = fe.FusedEncoderLayerFn.apply(x, packed, 8, *params)
    got = torch.autograd.grad(out, [x] + params, g)
    assert fe.bwd_shape_launches[shape] == before[shape] + 1
    ref_dx, ref_grads = fe.encoder_layer_bwd_reference(x.detach(), g, packed.params, 8)
    for a, b in zip(got, (ref_dx,) + ref_grads):
        assert float((a - b).abs().max()) <= BWD_REL * float(b.abs().max())

# The kernel and the plain version round the same operands to bf16 and sum
# in f32; they differ in the order of the sums and in the bf16 roundings of
# activations that this flips. A flip (2^-8 relative) in an early layer is
# carried through up to six more layers with a rounding each, so the chain
# amplifies it: the plain version on the CPU, with every f32 sum perturbed by
# 1e-6 relative, moves its own outputs by up to 3.4e-3 x max|out| at full
# width (0.034 on outputs up to 10). Held at 1e-2 x max|ref|; a wrong tap, row
# or bias shows as errors of the outputs' own size. The JAX suite allows its
# fused forward 5e-2 x max|ref| against the flax model in bf16
# (tests/test_pallas_groundlink.py).
GL_REL = 1e-2
FULL = (128, 128, 256, 256)


@pytest.mark.parametrize('batch,t,c_in,features,fc_depth,fmt', [
    (1, 10, 177, FULL, 3, 'last_frame'),
    (37, 10, 177, FULL, 3, 'all_frames'),
    (4096, 10, 177, FULL, 3, 'last_frame'),
    (4096, 10, 177, FULL, 3, 'all_frames'),
    (37, 4, 177, (16, 16, 24, 24), 3, 'all_frames'),   # the small test shape
    (37, 4, 177, (16, 16, 24, 24), 3, 'last_frame'),
    (37, 10, 177, FULL, 1, 'last_frame'),              # the head alone after the convs
    (5, 7, 100, (64, 48), 2, 'all_frames'),            # two convs, another T
    (3, 64, 177, (32, 32), 2, 'last_frame'),           # the longest window: one a block
    (200, 1, 177, (512,), 2, 'all_frames'),            # T = 1, the widest layer
    (9, 10, 177, (32, 32), 3, 'all_frames'),           # 3 taps
])
def test_fused_groundlink_kernel_matches_plain(cuda, batch, t, c_in, features,
                                               fc_depth, fmt):
    gen = torch.Generator().manual_seed(batch + t + c_in)
    taps = 3 if batch == 9 else 7
    packed = fg.pack_groundlink_params(
        random_groundlink_params(gen, c_in, features, fc_depth, taps), cuda)
    x = torch.randn(batch, t, c_in, generator=gen).to(cuda)
    before = fg.launches
    out = fg.fused_groundlink_forward(x, packed, fmt)
    assert fg.launches == before + 1
    ref = fg.groundlink_reference(x, packed.params, fmt, fc_depth)
    torch.cuda.synchronize()
    assert out.shape == (batch, t if fmt == 'all_frames' else 1, 30)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= GL_REL * float(ref.abs().max())


@pytest.mark.parametrize('fmt', ['last_frame', 'all_frames'])
@pytest.mark.parametrize('shape', ['small', 'large'])
@pytest.mark.parametrize('batch', [
    1, 2, 7,
    fg.SMALL_BATCH_MAX,           # the plan's threshold
    fg.SMALL_BATCH_MAX + 1,
    4099,                         # a ragged last tile in either shape
])
def test_fused_groundlink_kernel_both_shapes_match_plain(cuda, monkeypatch, shape, batch,
                                                         fmt):
    """The served model (177 -> 128 -> 128 -> 256 -> 256, k = 7, T = 10,
    fc_depth 3) through each of the kernel's two shapes at every batch, the
    plan's threshold moved so that the named shape takes it."""
    monkeypatch.setattr(fg, 'SMALL_BATCH_MAX', 1 << 30 if shape == 'small' else 0)
    gen = torch.Generator().manual_seed(batch)
    packed = fg.pack_groundlink_params(random_groundlink_params(gen, 177, FULL, 3), cuda)
    x = torch.randn(batch, 10, 177, generator=gen).to(cuda)
    before = dict(fg.shape_launches)
    out = fg.fused_groundlink_forward(x, packed, fmt)
    assert fg.shape_launches[shape] == before[shape] + 1
    ref = fg.groundlink_reference(x, packed.params, fmt, 3)
    torch.cuda.synchronize()
    assert out.shape == (batch, 10 if fmt == 'all_frames' else 1, 30)
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= GL_REL * float(ref.abs().max())


@pytest.mark.parametrize('shape,batch', [('small', 1), ('small', 37), ('large', 4099)])
def test_fused_groundlink_kernel_is_deterministic(cuda, monkeypatch, shape, batch):
    """Two launches on the same input are bitwise equal: split k-steps meet in
    a fixed order and nothing is added atomically."""
    monkeypatch.setattr(fg, 'SMALL_BATCH_MAX', 1 << 30 if shape == 'small' else 0)
    gen = torch.Generator().manual_seed(batch)
    packed = fg.pack_groundlink_params(random_groundlink_params(gen, 177, FULL, 3), cuda)
    x = torch.randn(batch, 10, 177, generator=gen).to(cuda)
    first = fg.fused_groundlink_forward(x, packed, 'last_frame')
    again = fg.fused_groundlink_forward(x, packed, 'last_frame')
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.parametrize('model_type,accum', [('pallas', 1), ('pallas', 2), ('vpu', 1),
                                              ('feedforward', 1), ('groundlink', 1)])
def test_captured_chunks_are_per_step_calls_bitwise(cuda, tmp_path, model_type, accum):
    """Chunks of train steps replayed from a CUDA graph (two eager steps,
    one capture, then replays; a remainder chunk replays the same graph)
    against per-step eager calls from the same weights, for every trained
    model and with gradient accumulation: every step's loss and the
    parameters bitwise equal (GroundLink with its dropout masks); the
    wrappers count the eager steps' launches and the capture's, and the
    profiler trace of the chunks holds every step's, replays included."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from inferbiomechanics_tpu_torch.config import Config
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
    from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
    from inferbiomechanics_tpu_torch.models.common import generator_masks
    from inferbiomechanics_tpu_torch.train import loop
    from inferbiomechanics_tpu_torch.train import step as step_mod
    from inferbiomechanics_tpu_torch.train.device_data import (
        DeviceResidentData, make_device_chunked_step, make_device_train_step,
    )
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import create_train_state

    write_synthetic_subject(str(tmp_path / 's.b3d'), num_trials=2, trial_length=200, seed=0)
    ds = WindowDataset(str(tmp_path), window_size=50, stride=5, skip_loading_skeletons=True)
    data = DeviceResidentData(ds, cuda)
    cfg = Config()
    if model_type in ('pallas', 'vpu'):
        cfg.model_type, cfg.attn_impl, cfg.d_model, cfg.num_layers, cfg.num_heads = (
            'transformer', model_type, 128, 2, 4)
    else:
        cfg.model_type = model_type
    lc = loop.loss_config_from(cfg)
    idx = np.stack([np.random.default_rng(i).permutation(len(ds))[:16] for i in range(7)])

    def fresh():
        model = loop.build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(0),
                                             device=cuda)
        state = create_train_state(model, make_optimizer(
            model.named_parameters(), 'adam', 1e-3, lr_schedule='warmup_cosine',
            lr_decay_steps=10, lr_warmup_steps=2))
        if hasattr(model, 'dropout_masks'):
            state.dropout_gen, state.dropout_seed = torch.Generator(device=cuda), 3
            model.dropout_masks = generator_masks(state.dropout_gen)
        return model, state

    model, per = fresh()
    step = make_device_train_step(model, data, lc, grad_accum=accum)
    fe.launches = fe.bwd_launches = 0
    want = [float(step(per, torch.from_numpy(i).to(cuda))['loss']) for i in idx]
    launched = (fe.launches, fe.bwd_launches)
    model_c, chunked = fresh()
    chunk = make_device_chunked_step(model_c, data, lc, grad_accum=accum)
    fe.launches = fe.bwd_launches = 0
    replays = step_mod.replays
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # the trace's window opens and closes away from the work it counts
        # (chip_smoke.py::_traced: a window that opened with the work missed
        # its first kernels once)
        torch.cuda.synchronize()
        time.sleep(0.05)
        got = [float(r['loss'])
               for r in chunk(chunked, idx[:4]).rows() + chunk(chunked, idx[4:]).rows()]
        torch.cuda.synchronize()
        time.sleep(0.05)
    assert got == want
    assert step_mod.replays - replays == len(idx) - step_mod.GraphedStep.WARMUP_STEPS
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    k3_names = ('encoder_bwd_tile_kernel', 'encoder_wgrad_kernel', 'encoder_bwd_reduce_kernel')
    traced = (sum('fused_encoder_kernel' in n for n in names),
              sum(any(k in n for k in k3_names) for n in names))
    assert traced == launched
    called = step_mod.GraphedStep.WARMUP_STEPS + 1
    assert (fe.launches, fe.bwd_launches) == tuple(n // len(idx) * called for n in launched)
    assert chunked.step == per.step == len(idx)
    for (n, p), q in zip(model.named_parameters(), model_c.parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize('batch', [1, 64, 65])
def test_captured_diffusion_chunks_are_per_step_calls_bitwise(cuda, tmp_path, batch):
    """The full-width denoiser's train step (``--cond-dropout 0.1
    --ema-decay 0.999``) in chunks replayed from a CUDA graph (two eager
    steps, one capture, then replays; a remainder chunk replays the same
    graph) against per-step eager calls from the same weights: every step's
    loss, the parameters, the optimizer state and the EMA bitwise equal. The
    draws come from the state's generator, which the graph registers; the
    EMA update is inside the graph."""
    import numpy as np

    from inferbiomechanics_tpu_torch.config import Config
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
    from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
    from inferbiomechanics_tpu_torch.models.diffusion import DDPMSchedule
    from inferbiomechanics_tpu_torch.train import loop
    from inferbiomechanics_tpu_torch.train import step as step_mod
    from inferbiomechanics_tpu_torch.train.device_data import (
        DeviceResidentData, make_device_diffusion_chunked_step, make_device_diffusion_train_step,
    )
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import ParamEMA, create_train_state

    write_synthetic_subject(str(tmp_path / 's.b3d'), num_trials=2, trial_length=200, seed=0)
    ds = WindowDataset(str(tmp_path), window_size=50, stride=5, output_data_format='all_frames',
                       skip_loading_skeletons=True)
    data = DeviceResidentData(ds, cuda)
    cfg = Config()
    cfg.model_type, cfg.output_data_format = 'diffusion', 'all_frames'
    sched = DDPMSchedule(cfg.diffusion_timesteps, device=cuda)
    idx = np.stack([np.random.default_rng(i).permutation(len(ds))[:batch] for i in range(7)])

    def fresh():
        model = loop.build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(0),
                                             device=cuda)
        state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop',
                                                         1e-3))
        state.dropout_gen, state.dropout_seed = torch.Generator(device=cuda), 3
        state.ema = ParamEMA(model, 0.999)
        return model, state

    model, per = fresh()
    step = make_device_diffusion_train_step(model, data, sched, 0.1)
    want = [float(step(per, torch.from_numpy(i).to(cuda))['loss']) for i in idx]
    model_c, chunked = fresh()
    chunk = make_device_diffusion_chunked_step(model_c, data, sched, 0.1)
    replays, captures = step_mod.replays, step_mod.captures
    got = [float(r['loss']) for r in chunk(chunked, idx[:4]).rows() + chunk(chunked, idx[4:]).rows()]
    assert got == want
    assert step_mod.captures - captures == 1
    assert step_mod.replays - replays == len(idx) - step_mod.GraphedStep.WARMUP_STEPS
    assert chunked.step == per.step == len(idx)
    for (n, p), q in zip(model.named_parameters(), model_c.parameters()):
        assert torch.equal(p, q), n
    for n, e in per.ema.state_dict().items():
        assert torch.equal(e, chunked.ema.state_dict()[n]), n
    for i, st in per.optimizer.state_dict()['state'].items():
        for k, v in st.items():
            assert torch.equal(v, chunked.optimizer.state_dict()['state'][i][k]), (i, k)


@pytest.mark.parametrize('batch,kw', [(1, {}), (2, {'eta': 1.0}),
                                      (64, {'guidance_scale': 2.0})])
def test_diffusion_chain_through_k2_matches_the_plain_chain(cuda, monkeypatch, batch, kw):
    """The full-width denoiser's chains with every layer through K2 against
    the same chains through K2's plain version, same generator, within
    5e-2 x max|plain| (the JAX suite's limit for its fused forward against
    model.apply). The 50-step chain from the top of the schedule: four
    launches a step, finite answers, and each step's eps on the plain
    chain's own x_t held to the limit. Its answers are not compared: at its
    first step x0 = 8 sign(x_t - eps), so where x_t and eps nearly tie a
    rounding difference flips an element's sign. A partial chain
    (partial_frac 0.3: from t = 300, 15 steps) is well conditioned, and each
    head of its answer is held element by element."""
    from inferbiomechanics_tpu_torch.models import diffusion, get_model
    model = get_model('diffusion', num_dofs=23, num_contact_bodies=2, history_len=50,
                      stride=5, root_history_len=10,
                      generator=torch.Generator().manual_seed(batch), device=cuda).eval()
    cond = torch.randn(batch, 10, 177, generator=torch.Generator().manual_seed(1)).to(cuda)
    init = torch.randn(batch, 10, 30, generator=torch.Generator().manual_seed(2)).to(cuda)
    sampler = diffusion.make_sampler(model, num_steps=50, fused_inference=True, **kw)
    partial = diffusion.make_sampler(model, num_steps=50, fused_inference=True,
                                     partial_frac=0.3, **kw)

    def run(trace=None):
        whole = sampler(model, cond, torch.Generator(device=cuda).manual_seed(0), trace=trace)
        part = partial(model, cond, torch.Generator(device=cuda).manual_seed(0), init=init)
        return whole, part

    fe.launches = 0
    got, got_part = run()
    assert fe.launches == 4 * (50 + 15)
    trace = []
    with monkeypatch.context() as m:
        m.setattr(fe, 'fused_encoder_layer', lambda x, layer, heads:
                  fe.encoder_layer_reference(x, layer.params, heads))
        _, want_part = run(trace)
    rows = torch.cat([cond, torch.zeros_like(cond)]) if 'guidance_scale' in kw else cond
    with torch.no_grad():
        for t, x in trace:
            xb = torch.cat([x, x]) if 'guidance_scale' in kw else x
            tb = torch.full((xb.shape[0],), t, device=cuda)
            a = diffusion.fused_denoiser_eps(model, xb, tb, rows)
            b = diffusion.fused_denoiser_eps(model, xb, tb, rows, use_kernel=False)
            assert (a - b).abs().max() <= 5e-2 * b.abs().max(), t
    for k in got:
        assert torch.isfinite(got[k]).all(), k
        err = (got_part[k] - want_part[k]).abs().max()
        assert err <= 5e-2 * want_part[k].abs().max(), (k, float(err))


def _batchnorm_model(cuda, seed=0):
    """The default feedforward model at full width with batchnorm and
    dropout, its BatchNorms' scales, biases and running statistics seeded
    away from their defaults: input channels with offsets of up to a few
    units and variances from 0.05 to 4, hidden units with the means and the
    small variances of sigmoid outputs (folded scales up to ~14)."""
    from inferbiomechanics_tpu_torch.models import get_model
    gen = torch.Generator().manual_seed(seed)
    model = get_model('feedforward', num_dofs=23, num_contact_bodies=2, history_len=50,
                      stride=5, root_history_len=10, batchnorm=True, dropout=True,
                      dropout_prob=0.1, generator=gen, device=cuda)
    with torch.no_grad():
        for i, norm in enumerate(model.norms):
            n = norm.weight.numel()
            norm.weight.copy_(1 + 0.2 * torch.randn(n, generator=gen))
            norm.bias.copy_(0.2 * torch.randn(n, generator=gen))
            if i == 0:
                norm.running_mean.copy_(3 * torch.randn(n, generator=gen))
                norm.running_var.copy_(0.05 + 4 * torch.rand(n, generator=gen))
            else:
                norm.running_mean.copy_(0.3 + 0.4 * torch.rand(n, generator=gen))
                norm.running_var.copy_(0.005 + 0.045 * torch.rand(n, generator=gen))
    return model.eval(), gen


def k1_limit(ref: torch.Tensor) -> float:
    """K1's limit for outputs up to max|ref|: ATOL below 2 (a flipped final
    bf16 rounding moves an output by one ulp, 7.8e-3 below 2), doubled for
    each octave above, where the ulp doubles."""
    return ATOL * 2.0 ** max(0, math.ceil(math.log2(float(ref.abs().max()) / 2)))


@pytest.mark.parametrize('batch', [1, 64, 512, 4096])
def test_fused_mlp_kernel_with_folded_batchnorm_matches_plain(cuda, batch):
    """K1 on a batchnorm model's packing (each BatchNorm's eval affine map
    folded into the Dense layer after it) against its plain version on the
    same packing, at K1's limit for the outputs' octave (the head after a
    BatchNorm gives outputs beyond 2, where one bf16 ulp is 1.6e-2); the
    model's eval forward is one K1 launch."""
    model, gen = _batchnorm_model(cuda, batch)
    norm = model.norms[0]
    x = (norm.running_mean.cpu() + norm.running_var.cpu().sqrt()
         * torch.randn(batch, 1770, generator=gen)).to(cuda)
    packed = model.packed()
    before = fm.launches
    with torch.no_grad():
        out = model(x.reshape(batch, 10, 177))
    assert fm.launches == before + 1
    flat = torch.cat([out[k].reshape(batch, -1) for k in out], 1)
    got = fm.fused_mlp_forward(x, packed, 'sigmoid')
    ref = fm.mlp_reference(x, packed.layers, 'sigmoid')
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and flat.shape == got.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=k1_limit(ref))


def _bn_chunk_case(cuda, tmp_path, batch, aug_draws=None):
    import numpy as np

    from inferbiomechanics_tpu_torch.config import Config
    from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
    from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
    from inferbiomechanics_tpu_torch.train import loop
    from inferbiomechanics_tpu_torch.train.device_data import DeviceResidentData
    from inferbiomechanics_tpu_torch.train.optimizers import make_optimizer
    from inferbiomechanics_tpu_torch.train.state import create_train_state

    write_synthetic_subject(str(tmp_path / 's.b3d'), num_trials=2, trial_length=200, seed=0)
    ds = WindowDataset(str(tmp_path), window_size=50, stride=5, skip_loading_skeletons=True)
    cfg = Config()
    cfg.batchnorm, cfg.dropout, cfg.dropout_prob = True, True, 0.1
    cfg.augment_mirror, cfg.augment_noise_std = True, 0.05
    idx = np.stack([np.random.default_rng(i).permutation(len(ds))[:batch] for i in range(7)])

    def fresh():
        model = loop.build_model_for_dataset(cfg, ds, generator=torch.Generator().manual_seed(0),
                                             device=cuda)
        state = create_train_state(model, make_optimizer(model.named_parameters(), 'rmsprop',
                                                         1e-3))
        return model, state, loop.per_step_generators(cfg, state, ds, cuda)

    return DeviceResidentData(ds, cuda), loop.loss_config_from(cfg), idx, fresh


@pytest.mark.parametrize('batch', [1, 64, 65])
def test_captured_batchnorm_dropout_augmented_chunks_are_per_step_calls_bitwise(
        cuda, tmp_path, batch):
    """The full-width feedforward model with batchnorm, dropout 0.1 and
    mirror + noise augmentation: chunks replayed from a CUDA graph (the
    dropout and the augmentation generators registered with it, the running
    statistics updated in place inside it) against per-step eager calls from
    the same weights: every step's loss, the parameters, the running
    statistics and the optimizer state bitwise equal."""
    from inferbiomechanics_tpu_torch.train import step as step_mod
    from inferbiomechanics_tpu_torch.train.device_data import (
        make_device_chunked_step, make_device_train_step,
    )
    data, lc, idx, fresh = _bn_chunk_case(cuda, tmp_path, batch)
    model, per, aug = fresh()
    step = make_device_train_step(model, data, lc, augment=aug)
    want = [float(step(per, torch.from_numpy(i).to(cuda))['loss']) for i in idx]
    model_c, chunked, aug_c = fresh()
    chunk = make_device_chunked_step(model_c, data, lc, augment=aug_c)
    replays, captures = step_mod.replays, step_mod.captures
    got = [float(r['loss']) for r in chunk(chunked, idx[:4]).rows() + chunk(chunked, idx[4:]).rows()]
    assert got == want
    assert step_mod.captures - captures == 1
    assert step_mod.replays - replays == len(idx) - step_mod.GraphedStep.WARMUP_STEPS
    for (n, p), q in zip(model.state_dict().items(), model_c.state_dict().values()):
        assert torch.equal(p, q), n
    assert not torch.equal(model.norms[1].running_mean,
                           torch.zeros_like(model.norms[1].running_mean))
    for i, st in per.optimizer.state_dict()['state'].items():
        for k, v in st.items():
            assert torch.equal(v, chunked.optimizer.state_dict()['state'][i][k]), (i, k)


def test_augmentation_draws_anew_in_every_replay(cuda, tmp_path):
    """The coins of a chunk of 8 steps at B=64, recorded inside the step (a
    device-side row counter, so replays record too): every step's differ
    from every other's, and about half the samples are mirrored."""
    from inferbiomechanics_tpu_torch.train import augment
    from inferbiomechanics_tpu_torch.train.device_data import make_device_chunked_step
    data, lc, idx, fresh = _bn_chunk_case(cuda, tmp_path, 64)
    model, state, aug = fresh()
    coins = torch.zeros(8, 64, dtype=torch.bool, device=cuda)
    row = torch.zeros(1, dtype=torch.int64, device=cuda)
    base = augment.generator_aug_draws(state.aug_gen)

    def coin(b, p, device):
        c = base.coin(b, p, device)
        coins.index_copy_(0, row, c[None])
        row.add_(1)
        return c

    chunk = make_device_chunked_step(model, data, lc, augment=aug,
                                     aug_draws=augment.AugmentDraws(coin=coin, noise=base.noise))
    chunk(state, [idx[k % len(idx)] for k in range(8)]).rows()
    assert int(row) == 8
    seen = coins.cpu()
    assert all(not torch.equal(seen[a], seen[b]) for a in range(8) for b in range(a))
    assert 0.3 < float(seen.float().mean()) < 0.7
