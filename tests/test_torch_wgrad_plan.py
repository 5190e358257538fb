"""The schedule of the port's weight-gradient stage
(inferbiomechanics_tpu_torch/ops/fused_encoder.py::plan_wgrad, which
csrc/fused_encoder_bwd.cu::encoder_wgrad_kernel walks) and its plain version
(encoder_wgrad_reference), on the CPU.

The stage sums dWqkv = y1^T dqkv, dWproj = a^T dh2, dW1 = y2^T dz1 and
dW2 = u^T g over the n rows of the bf16 workspace that the backward's tile
kernels write: items of (product, output tile, range of 64-row boxes), each
item's partial tile summed box by box in k-steps of 16 rows, the ranges'
partial tiles added in range order. Held here: the items cover each
(product, output element, row) once for every width K3 takes and n from 1 to
10^6; the plan is the shape's alone and runs in one wave on an H100 at B =
64 and 4096; a
float32 replay of that order of summation against float64; and, fed the
workspace of the plain backward (encoder_bwd_workspace_reference), the
stage gives that backward's weight gradients, which are held to jax.vjp as
tests/test_torch_fused_encoder_bwd.py holds them. The kernel itself is held
to the plain version on the card (tests/test_torch_cuda_kernels.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.ops import pallas_encoder as jpe
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe

F32_TOL = dict(rtol=1e-4, atol=1e-5)
# two float32 sums of the same products in other orders, on a layer's
# gradients (up to ~100): each f32 addition rounds at 2^-24 of a partial sum
# as large as the tensor's largest value, so an element near zero differs by
# up to a few such roundings a k-step; held at rtol 1e-4 and 1e-6 x max|plain|
F32_SCALED = 1e-6
BF16_REL = 5e-2          # x max|jax|, as the bf16 backward is held to jax.vjp
SMS = 132                # an H100's multiprocessors
# every (d, m) the backward's tile kernels take (fe.plan_bwd_tile: d 128 ..
# 512, m a multiple of 128 that fits) at the MLP ratios the models use, and
# the narrowest MLP
WIDTHS = [(d, m) for d in (128, 256, 384, 512) for m in sorted({128, d, 2 * d, 4 * d})]
ROWS = (1, 2, 10, 63, 64, 65, 190, 511, 512, 640, 650, 1024, 5120, 16396, 40960, 40990,
        123457, 10 ** 6)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """One thread: the plain version's sums in one order whatever the
    worker's thread pool, and no fight with the other test processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _workspace(n, d, m, seed, scale=0.1):
    """A seeded bf16 workspace of n rows (values ~ N(0, scale^2))."""
    rng = np.random.default_rng(seed)
    w = (scale * rng.normal(size=n * (8 * d + 2 * m))).astype(np.float32)
    return torch.from_numpy(w).to(torch.bfloat16)


def _operands(ws, n, d, m):
    """The four products' (A, G) as float64 numpy arrays of the bf16 values."""
    widths = (d, 3 * d, d, d, d, m, m, d)
    flat = ws.float().numpy().astype(np.float64)
    views, at = [], 0
    for w in widths:
        views.append(flat[at:at + n * w].reshape(n, w))
        at += n * w
    return list(zip(views[0::2], views[1::2]))


def _replay(ws, n, d, m, plan):
    """The kernel's order of summation in float32: each item's partial tile
    summed over its boxes in k-steps of 16 rows (a k-step's 16 products
    summed, then added to the tile), rows past n zero; the ranges' partial
    tiles added in range order, from zero. Tiles do not change an element's
    order, so a product's whole output is replayed range by range."""
    box = 64
    out = []
    for a, g in _operands(ws, n, d, m):
        pad = plan.boxes * box - n
        a = np.concatenate([a, np.zeros((pad, a.shape[1]))])
        g = np.concatenate([g, np.zeros((pad, g.shape[1]))])
        total = np.zeros((a.shape[1], g.shape[1]), np.float32)
        for s in range(plan.splits):
            r0 = s * plan.boxes_per_split * box
            r1 = min(plan.boxes * box, r0 + plan.boxes_per_split * box)
            part = np.zeros_like(total)
            for k in range(r0, r1, 16):
                step = (a[k:k + 16].T @ g[k:k + 16]).astype(np.float32)
                part = (part + step).astype(np.float32)
            total = (total + part).astype(np.float32)
        out.append(total)
    return out


@pytest.mark.parametrize('d,m', WIDTHS)
def test_schedule_covers_each_output_and_row_once(d, m):
    """The tiles cover each element of the four products once, the ranges
    each row once (whole boxes, none empty, the last ragged at n); an item is
    a (tile, range) pair, range-major, so each (product, element, row) falls
    in exactly one item, for every n from 1 to 10^6 in ROWS."""
    w_total = 4 * d * d + 2 * d * m
    for tile_n in fe._WG_TILE_N:
        hits = np.zeros(w_total, np.int64)
        for p, i0, j0, nw in fe.wgrad_tiles(d, m, tile_n):
            rows, cols, off = fe.wgrad_products(d, m)[p]
            assert nw in (128, 256) and nw <= tile_n and i0 + 128 <= rows and j0 + nw <= cols
            block = hits[off:off + rows * cols].reshape(rows, cols)
            block[i0:i0 + 128, j0:j0 + nw] += 1
        assert (hits == 1).all(), (d, m, tile_n)
    for n in ROWS:
        plan = fe.plan_wgrad(n, d, m)
        ranges = [plan.rows(s) for s in range(plan.splits)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n, (n, ranges[:2], ranges[-1])
        assert all(r0 < r1 and r0 % 64 == 0 for r0, r1 in ranges)
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(r1 - r0 == plan.boxes_per_split * 64 for r0, r1 in ranges[:-1])
        assert plan.items == len(plan.tiles) * plan.splits
        assert 1 <= plan.blocks(SMS) <= min(plan.items, SMS)
        assert plan.as_ints(SMS) == (plan.tile_n, plan.splits, plan.boxes_per_split,
                                     plan.blocks(SMS))
        # one range: no partials to add, the kernel writes the gradient
        assert plan.partials == (plan.splits if plan.splits > 1 else 0)
        assert plan.stage_launches == 1 + (plan.splits > 1)


def test_row_ranges_depend_on_the_shape_alone(monkeypatch):
    """The plan is a function of (n, d, m) alone: computed anew without a
    card to ask, it is the same; another card changes only how many blocks
    walk the items, never the items or their ranges."""
    shapes = [(n, d, m) for n in (10, 640, 5120, 40960) for d, m in ((256, 1024), (128, 512))]
    first = {s: fe.plan_wgrad(*s) for s in shapes}
    fe.plan_wgrad.cache_clear()

    def no_card(*_a, **_k):
        raise AssertionError('the plan asked the card')
    monkeypatch.setattr(torch.cuda, 'get_device_properties', no_card)
    for s in shapes:
        plan = fe.plan_wgrad(*s)
        assert plan == first[s]
        assert plan.as_ints(114)[:3] == plan.as_ints(132)[:3]


@pytest.mark.parametrize('batch,tile_n,splits', [(64, 128, 2), (4096, 256, 4)])
def test_schedule_runs_in_one_wave_at_the_default_batch_and_4096(batch, tile_n, splits):
    """At the default batch and at B = 4096 (T = 10, the served widths) the
    plan is the one measured fastest on an H100 (PERF.md §6): 96 items,
    one a block in one wave, on 96 of the card's 132 multiprocessors. Each
    more range would fill more of the card but writes and reads back one
    more partial gradient (3.1 MB): 240 items took 14.6 us against 9.9 at B =
    64, 264 took 146.3 against 123.5 at B = 4096."""
    plan = fe.plan_wgrad(batch * 10, 256, 1024)
    assert (plan.tile_n, plan.splits) == (tile_n, splits)
    assert plan.items == 96 and plan.blocks(SMS) == plan.items


@pytest.mark.parametrize('n,d,m,tile_n,bps', [
    (10, 256, 1024, None, None),      # one ragged box
    (650, 128, 512, None, None),      # a ragged last box and range
    (2048, 128, 256, 128, 5),         # forced: 7 ranges, the last short
    (5120, 384, 384, None, None),     # 128-wide tiles where 256 does not divide
])
def test_float32_replay_of_the_kernels_order_matches_float64(n, d, m, tile_n, bps):
    plan = fe.plan_wgrad(n, d, m)
    if tile_n is not None:
        plan = fe.WgradPlan(n, d, m, tile_n, bps)
    ws = _workspace(n, d, m, seed=n + d + m)
    got = _replay(ws, n, d, m, plan)
    for name, a, (x, g) in zip(('wqkv', 'wproj', 'wmlp1', 'wmlp2'), got,
                               _operands(ws, n, d, m)):
        np.testing.assert_allclose(a, x.T @ g, err_msg=f'd{name}', **F32_TOL)


@functools.lru_cache(maxsize=None)
def _jax_vjp_bf16(heads):
    def run(x, params, g):
        _, vjp = jax.vjp(lambda x_, p_: jpe.encoder_layer_reference(
            x_, p_, heads, compute_dtype=jnp.bfloat16), x, params)
        return vjp(g)
    return jax.jit(run)


def _layer_params(seed, d, m):
    rng = np.random.default_rng(seed)
    shapes = ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,), (d, m), (m,),
              (m, d), (d,))
    out = []
    for name, shape in zip(fe.PARAM_NAMES, shapes):
        if len(shape) == 2:
            p = rng.normal(0, shape[0] ** -0.5, shape)
        elif name.endswith('scale'):
            p = 1.0 + 0.2 * rng.normal(size=shape)
        else:
            p = 0.3 * rng.normal(size=shape)
        out.append(p.astype(np.float32))
    return out


@pytest.mark.parametrize('b,t,d,heads,ratio', [(19, 10, 128, 4, 4), (700, 4, 128, 4, 2)])
def test_the_stage_on_the_plain_backwards_workspace_gives_its_weight_gradients(
        b, t, d, heads, ratio):
    """The workspace of the plain backward through the stage's plain version
    and through the float32 replay of the kernel's order: the plain
    backward's four weight gradients (the plain version bitwise, the replay
    at rtol 1e-4 and F32_SCALED x max), and those within BF16_REL x max of
    jax.vjp's in bf16."""
    m = d * ratio
    params = _layer_params(b + t, d, m)
    rng = np.random.default_rng(b + 1)
    x = rng.normal(size=(b, t, d)).astype(np.float32)
    g = rng.normal(size=(b, t, d)).astype(np.float32)
    pt = [torch.from_numpy(p) for p in params]
    _, grads = fe.encoder_layer_bwd_reference(torch.from_numpy(x), torch.from_numpy(g), pt,
                                              heads)
    want = [grads[i] for i in (2, 4, 8, 10)]
    n = b * t
    ws = fe.encoder_bwd_workspace_reference(torch.from_numpy(x), torch.from_numpy(g), pt, heads)
    assert ws.dtype == torch.bfloat16 and ws.numel() == n * (8 * d + 2 * m)
    plain = fe.encoder_wgrad(ws, n, d, m)
    replayed = _replay(ws, n, d, m, fe.plan_wgrad(n, d, m))
    _, jax_grads = _jax_vjp_bf16(heads)(jnp.asarray(x), tuple(jnp.asarray(p) for p in params),
                                        jnp.asarray(g))
    for name, a, r, w, j in zip(('wqkv', 'wproj', 'wmlp1', 'wmlp2'), plain, replayed, want,
                                (jax_grads[i] for i in (2, 4, 8, 10))):
        assert torch.equal(a, w), name
        np.testing.assert_allclose(r, w.numpy(), rtol=1e-4,
                                   atol=F32_SCALED * float(w.abs().max()), err_msg=f'd{name}')
        j = np.asarray(j, np.float32)
        np.testing.assert_allclose(r, j, rtol=0, atol=BF16_REL * np.abs(j).max(),
                                   err_msg=f'd{name} against jax.vjp')


def test_encoder_wgrad_refuses_what_the_stage_does_not_take():
    ws = _workspace(10, 128, 128, seed=0)
    with pytest.raises(ValueError, match='bf16 workspace'):
        fe.encoder_wgrad(ws.float(), 10, 128, 128)
    with pytest.raises(ValueError, match='bf16 workspace'):
        fe.encoder_wgrad(ws[:-1], 10, 128, 128)
    with pytest.raises(ValueError, match='no kernel'):
        fe.encoder_wgrad(ws.to('meta'), 10, 128, 128)
    for n, d, m in ((0, 128, 128), (10, 200, 128), (10, 128, 100)):
        with pytest.raises(ValueError, match='plan_wgrad takes'):
            fe.plan_wgrad(n, d, m)


def test_tune_times_the_stage_beside_its_bound_and_the_library():
    """ops/tune.py's yardsticks for the stage: the bound (the workspace's
    bytes at 3.35 TB/s against the products at 989 TFLOP/s) and the library
    call, four bf16 torch.mm on the same views, which computes the same
    products (in bf16 out: one rounding)."""
    from inferbiomechanics_tpu_torch.ops import tune
    us, by = tune.wgrad_bound(40960, 256, 1024)
    assert by == 'bytes' and us == pytest.approx((40960 * 4096 * 2 + 786432 * 4) / 3.35e6)
    us, by = tune.wgrad_bound(1 << 20, 128, 128)     # 8 d^2 flops a row, 2.5 KB
    assert by == 'bytes'
    assert tune.wgrad_bound(40960, 256, 1024)[0] > 100.2
    n, d, m = 300, 128, 256
    ws = _workspace(n, d, m, seed=3)
    lib = tune.wgrad_library(ws, n, d, m)()
    for a, r in zip(lib, fe.encoder_wgrad_reference(ws, n, d, m)):
        assert a.dtype == torch.bfloat16 and a.shape == r.shape
        np.testing.assert_allclose(a.float().numpy(), r.numpy(), rtol=0,
                                   atol=1e-2 * float(r.abs().max()))
