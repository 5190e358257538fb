"""The plain version of the port's encoder-layer backward kernels
(inferbiomechanics_tpu_torch/ops/fused_encoder.py::
encoder_layer_bwd_reference) against the JAX package's
(inferbiomechanics_tpu/ops/pallas_encoder.py), on the same numpy inputs.

The CUDA kernels cannot run on the CPU; the plain version defines what they
compute and is held here against ``jax.vjp`` of the JAX reference layer and
against the Pallas backward kernel in interpret mode (tile_rows=8, a batch
of 19 that pads the last tile), at the JAX suite's own shapes and
tolerances (tests/test_pallas_encoder.py: T=10, d=128, H=4; f32 at rtol
2e-4 / atol 2e-5; bf16 at 5e-2 x the tensor's largest value), and against
``torch.autograd`` through the port's own forward. The kernels are held
against the plain version on the card (tests/test_torch_cuda_kernels.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from inferbiomechanics_tpu.ops import pallas_encoder as jpe
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops._layout import fragment_order

T, D, H = 10, 128, 4
F32_TOL = dict(rtol=2e-4, atol=2e-5)
BF16_REL = 5e-2
NAMES = ('x',) + fe.PARAM_NAMES


def _params(seed, d=D, mlp_ratio=4):
    """Seeded numpy parameters in PARAM_NAMES order, with random biases and
    LayerNorm rows so that every gradient term matters."""
    rng = np.random.default_rng(seed)
    m = d * mlp_ratio
    shapes = dict(zip(fe.PARAM_NAMES, (
        (d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,), (d, m), (m,),
        (m, d), (d,))))
    out = []
    for name in fe.PARAM_NAMES:
        shape = shapes[name]
        if len(shape) == 2:
            p = rng.normal(0, shape[0] ** -0.5, shape)
        elif name.endswith('scale'):
            p = 1.0 + 0.2 * rng.normal(size=shape)
        else:
            p = 0.3 * rng.normal(size=shape)
        out.append(p.astype(np.float32))
    return out


def _xg(seed, b, t=T, d=D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, t, d)).astype(np.float32),
            rng.normal(size=(b, t, d)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _jax_vjp(heads, dtype_name):
    """``(x, params, g) -> (dx, dparams)`` by jax.vjp of the reference
    layer, jitted once per (heads, dtype)."""
    dtype = {'f32': jnp.float32, 'bf16': jnp.bfloat16}[dtype_name]

    def run(x, params, g):
        _, vjp = jax.vjp(lambda x_, p_: jpe.encoder_layer_reference(
            x_, p_, heads, compute_dtype=dtype), x, params)
        return vjp(g)

    return jax.jit(run)


def _port(x, g, params, heads, dtype):
    dx, grads = fe.encoder_layer_bwd_reference(
        torch.from_numpy(x), torch.from_numpy(g),
        [torch.from_numpy(p) for p in params], heads, dtype)
    return [dx.numpy()] + [a.numpy() for a in grads]


def _want(x, g, params, heads, dtype_name):
    dx, dp = _jax_vjp(heads, dtype_name)(jnp.asarray(x),
                                         tuple(jnp.asarray(p) for p in params),
                                         jnp.asarray(g))
    return [np.asarray(dx)] + [np.asarray(a) for a in dp]


def _forward64(x, params, heads):
    """The reference layer's math in float64 (no rounding to f32)."""
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = params
    b, t, d = x.shape
    dh = d // heads
    qkv = (F.layer_norm(x, (d,), g1, b1, fe.LN_EPS) @ wqkv + bqkv).reshape(b, t, 3, heads, dh)
    q, k, v = qkv[:, :, 0] * dh ** -0.5, qkv[:, :, 1], qkv[:, :, 2]
    probs = torch.softmax((q[:, :, None] * k[:, None]).sum(-1), dim=2)
    h = x + (probs[..., None] * v[:, None]).sum(2).reshape(b, t, d) @ wproj + bproj
    y = F.gelu(F.layer_norm(h, (d,), g2, b2, fe.LN_EPS) @ w1 + bm1, approximate='tanh')
    return h + y @ w2 + bm2


def _oracle(x, g, params, heads):
    """dx and the 12 gradients by float64 autograd: what both sides
    approximate in f32."""
    xs = torch.from_numpy(x).double().requires_grad_(True)
    ps = [torch.from_numpy(p).double().requires_grad_(True) for p in params]
    grads = torch.autograd.grad(_forward64(xs, ps, heads), [xs, *ps],
                                torch.from_numpy(g).double())
    return [a.numpy() for a in grads]


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    """One thread: the port's sums in one order whatever the worker's thread
    pool, and no fight with the other test processes for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize('b,t,heads', [(3, 10, 4), (19, 10, 4), (5, 4, 4), (2, 10, 8),
                                       (1, 10, 4), (8, 10, 4)])   # the small shape's batches
def test_plain_backward_matches_jax_vjp_f32(b, t, heads):
    """Each side against the float64 oracle, then the port against JAX, all
    at F32_TOL: a side that moves is named by the first two."""
    params = _params(b)
    x, g = _xg(b + 1, b, t)
    got = _port(x, g, params, heads, torch.float32)
    want = _want(x, g, params, heads, 'f32')
    exact = _oracle(x, g, params, heads)
    for name, a, w, o in zip(NAMES, got, want, exact):
        assert a.shape == w.shape == o.shape and a.dtype == np.float32, name
        np.testing.assert_allclose(a, o, err_msg=f'd{name}: the port against float64',
                                   **F32_TOL)
        np.testing.assert_allclose(w, o, err_msg=f'd{name}: jax.vjp against float64',
                                   **F32_TOL)
        np.testing.assert_allclose(a, w, err_msg=f'd{name}', **F32_TOL)


@pytest.mark.parametrize('b,t', [(19, 10), (5, 4), (1, 10), (8, 10)])
def test_plain_backward_matches_jax_vjp_bf16(b, t):
    params = _params(b + 10)
    x, g = _xg(b + 11, b, t)
    got = _port(x, g, params, H, torch.bfloat16)
    want = _want(x, g, params, H, 'bf16')
    for name, a, w in zip(NAMES, got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=0, atol=BF16_REL * np.abs(w).max(),
                                   err_msg=f'd{name}')


def _check_against_the_pallas_kernel(b, dtype_name, torch_dtype):
    params = _params(4)
    x, g = _xg(5, b)
    dx, dp = jpe.encoder_layer_bwd_pallas(
        jnp.asarray(x), jnp.asarray(g), tuple(jnp.asarray(p) for p in params), H,
        tile_rows=8, compute_dtype={'f32': jnp.float32, 'bf16': jnp.bfloat16}[dtype_name],
        interpret=True)
    want = [np.asarray(dx)] + [np.asarray(a) for a in dp]
    got = _port(x, g, params, H, torch_dtype)
    for name, a, w in zip(NAMES, got, want):
        if dtype_name == 'f32':
            np.testing.assert_allclose(a, w, err_msg=f'd{name}', **F32_TOL)
        else:
            np.testing.assert_allclose(a, w, rtol=0, atol=BF16_REL * np.abs(w).max(),
                                       err_msg=f'd{name}')


@pytest.mark.parametrize('dtype_name,torch_dtype', [('f32', torch.float32),
                                                    ('bf16', torch.bfloat16)])
def test_plain_backward_matches_the_pallas_kernel_in_interpret_mode(dtype_name, torch_dtype):
    """b=19 with 8-row tiles: two full tiles and a padded one, gradients
    summed across tiles."""
    _check_against_the_pallas_kernel(19, dtype_name, torch_dtype)


@pytest.mark.parametrize('b', [1, 8])
@pytest.mark.parametrize('dtype_name,torch_dtype', [('f32', torch.float32),
                                                    ('bf16', torch.bfloat16)])
def test_plain_backward_matches_the_pallas_kernel_at_small_batches(b, dtype_name,
                                                                   torch_dtype):
    """The batches the backward's small shape takes: one padded tile."""
    _check_against_the_pallas_kernel(b, dtype_name, torch_dtype)


@pytest.mark.parametrize('dtype,rel', [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_plain_backward_matches_autograd_through_the_ports_forward(dtype, rel):
    """In f32 the hand-derived VJP is autograd's to rounding; in bf16 they
    differ in which gradient operands are rounded (autograd rounds none of
    its own): 2e-2 x the tensor's largest value."""
    params = _params(7)
    x, g = _xg(8, 6)
    xt = torch.from_numpy(x).requires_grad_(True)
    pt = [torch.from_numpy(p).requires_grad_(True) for p in params]
    out = fe.encoder_layer_reference(xt, pt, H, dtype)
    want = torch.autograd.grad(out, [xt] + pt, torch.from_numpy(g))
    got = _port(x, g, params, H, dtype)
    for name, a, w in zip(NAMES, got, want):
        w = w.numpy()
        np.testing.assert_allclose(a, w, rtol=0, atol=rel * np.abs(w).max(),
                                   err_msg=f'd{name}')


def test_zero_rows_add_nothing_to_the_gradients():
    """What the kernels' padding relies on: a window with x = 0 and g = 0
    contributes exactly zero to every parameter gradient."""
    params = _params(2)
    x, g = _xg(3, 4)
    x2 = np.concatenate([x, np.zeros((3, T, D), np.float32)])
    g2 = np.concatenate([g, np.zeros((3, T, D), np.float32)])
    a, b = _port(x, g, params, H, torch.bfloat16), _port(x2, g2, params, H, torch.bfloat16)
    assert np.array_equal(b[0][:4], a[0]) and not b[0][4:].any()
    for name, ga, gb in zip(fe.PARAM_NAMES, a[1:], b[1:]):
        np.testing.assert_allclose(gb, ga, rtol=0, atol=1e-6 * np.abs(ga).max(), err_msg=name)


def test_fused_encoder_layer_fn_on_the_cpu_takes_the_plain_versions():
    params = [torch.from_numpy(p).requires_grad_(True) for p in _params(9)]
    x, g = _xg(10, 5)
    xt = torch.from_numpy(x).requires_grad_(True)
    packed = fe.pack_encoder_params(params, 'cpu', transposes=True)
    fwd, bwd, shapes = fe.launches, fe.bwd_launches, dict(fe.bwd_shape_launches)
    out = fe.FusedEncoderLayerFn.apply(xt, packed, H, *params)
    got = torch.autograd.grad(out, [xt] + params, torch.from_numpy(g))
    assert (fe.launches, fe.bwd_launches) == (fwd, bwd)     # no kernel on the CPU
    assert fe.bwd_shape_launches == shapes
    with torch.no_grad():
        ref = fe.encoder_layer_reference(xt, packed.params, H)
        want = _port(x, g, [p.detach().numpy() for p in params], H, torch.bfloat16)
    assert torch.equal(out, ref)
    for name, a, w in zip(NAMES, got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=f'd{name}')
    with pytest.raises(ValueError, match='12 parameters'):
        fe.FusedEncoderLayerFn.apply(xt, packed, H, *params[:-1])


def test_wrapper_refuses_what_the_kernels_do_not_take():
    packed = fe.pack_encoder_params([torch.from_numpy(p) for p in _params(1)], 'cpu')
    x, g = (torch.from_numpy(a) for a in _xg(2, 3))
    with pytest.raises(ValueError, match='differ'):
        fe.fused_encoder_layer_bwd(x, g[:2], packed, H)
    with pytest.raises(ValueError, match='no kernel for device'):
        fe.fused_encoder_layer_bwd(x.to('meta'), g.to('meta'), packed, H)


def test_transposes_are_packed_in_fragment_order():
    """``weights_t`` holds W^T of each kernel in the layout the kernels
    stream, end to end; replayed in numpy from the layout's definition:
    for 16-column block nb and k-step ks, lane g * 4 + c holds, for n8 tile
    j and half h, the pair W[16 ks + 8 h + 2 c + e, 16 nb + 8 j + g]."""
    params = _params(6)
    packed = fe.pack_encoder_params([torch.from_numpy(p) for p in params], 'cpu',
                                    transposes=True)
    assert fe.pack_encoder_params([torch.from_numpy(p) for p in params],
                                  'cpu').weights_t is None
    offset = 0
    for i in (2, 4, 8, 10):
        wt = torch.from_numpy(params[i]).to(torch.bfloat16).float().numpy().T   # [k, n]
        k, n = wt.shape
        got = packed.weights_t[offset:offset + k * n].float().numpy().reshape(
            n // 16, k // 16, 8, 4, 2, 2, 2)                 # nb ks g c j h e
        rng = np.random.default_rng(i)
        for _ in range(200):
            nb, ks, g, c, j, h, e = (int(rng.integers(0, s)) for s in got.shape)
            assert got[nb, ks, g, c, j, h, e] == wt[16 * ks + 8 * h + 2 * c + e,
                                                    16 * nb + 8 * j + g]
        np.testing.assert_array_equal(
            packed.weights_t[offset:offset + k * n].float().numpy(),
            fragment_order(torch.from_numpy(wt.copy())).numpy())
        offset += k * n
    assert offset == packed.weights_t.numel() == packed.weights.numel()


@pytest.mark.parametrize('t,d,m,heads,want', [
    (10, 256, 1024, 8, (2, 3, 256)),      # the default model: three windows a tile
    (10, 128, 512, 4, (3, 4, 128)),
    (4, 256, 1024, 8, (2, 8, 256)),
    (10, 384, 1536, 8, (1, 1, 256)),
    (16, 512, 2048, 8, (1, 1, 256)),
    (10, 256, 640, 8, (2, 3, 128)),       # an MLP width that 256 does not divide
])
def test_plan_bwd_tile(t, d, m, heads, want):
    row_tiles, windows, chunk, smem = fe.plan_bwd_tile(t, d, m, heads)
    assert (row_tiles, windows, chunk) == want
    assert smem <= fe.MAX_SMEM and windows * t <= 16 * row_tiles
    # one more row tile would not fit (or is more than the kernel takes)
    rows = 16 * (row_tiles + 1)
    bigger = (2 * rows * (d + 8) * 4 + rows * (d + 8) * 2
              + max(rows * (3 * d + 8) * 4, rows * (d + 8) * 2 + rows * (chunk + 8) * 6))
    assert row_tiles == 3 or bigger > fe.MAX_SMEM


@pytest.mark.parametrize('t,d,m,heads,match', [
    (10, 768, 3072, 8, 'does not fit'),
    (10, 640, 2560, 8, 'does not fit'),
    (10, 200, 800, 8, 'multiples of 128'),
    (49, 256, 1024, 8, '1..48 frames'),
    (10, 256, 1024, 256, 'even head width'),
    (32, 384, 1536, 8, 'does not fit'),
])
def test_plan_bwd_tile_limits(t, d, m, heads, match):
    with pytest.raises(ValueError, match=match):
        fe.plan_bwd_tile(t, d, m, heads)


def test_row_splits_depend_on_the_shape_alone():
    """The weight-gradient stage's row ranges at the served widths
    (fe.plan_wgrad; tests/test_torch_wgrad_plan.py holds the schedule)."""
    assert [fe.plan_wgrad(n, 256, 1024).splits
            for n in (10, 190, 511, 512, 1024, 40960, 10 ** 6)] == [1, 1, 2, 2, 2, 4, 4]


# ---------------------------------------------------------------------------
# The backward's two shapes: the plan, and the small shape's column split
# replayed in float64.
# ---------------------------------------------------------------------------

SERVED = (10, 256, 1024, 8)           # t, d, m, heads of the default transformer


@pytest.fixture
def bwd_threshold(monkeypatch):
    """``bwd_threshold(shape)`` makes ``shape`` take every batch it can."""
    def move(shape):
        small, pair = fe.bwd_thresholds(shape)
        monkeypatch.setattr(fe, 'BWD_SMALL_BATCH_MAX', small)
        monkeypatch.setattr(fe, 'BWD_PAIR_BATCH_MIN', pair)
    return move


def test_plan_encoder_bwd_is_pure_and_switches_at_the_threshold(monkeypatch):
    monkeypatch.setattr(fe, 'BWD_SMALL_BATCH_MAX', 64)
    monkeypatch.setattr(fe, 'BWD_PAIR_BATCH_MIN', 1 << 30)     # small against large
    a = fe.plan_encoder_bwd(64, *SERVED)
    assert a == fe.plan_encoder_bwd(64, *SERVED) and a is fe.plan_encoder_bwd(64, *SERVED)
    assert (a.shape, a.cluster, a.row_tiles, a.windows) == ('small', 8, 2, 3)
    assert a.launches == fe.BWD_LAUNCHES_PER_LAYER and a.tiles(64) == 22
    one = fe.plan_encoder_bwd(1, *SERVED)
    assert (one.shape, one.row_tiles, one.windows, one.tiles(1)) == ('small', 1, 1, 1)
    # the fewest row tiles with which every cluster runs at once
    assert fe.plan_encoder_bwd(14, *SERVED).row_tiles == 1
    assert fe.plan_encoder_bwd(15, *SERVED).row_tiles == 2
    past = fe.plan_encoder_bwd(65, *SERVED)
    assert (past.shape, past.cluster, past.row_tiles, past.windows, past.chunk) == (
        'large', 1, 2, 3, 256)
    assert (past.row_tiles, past.windows, past.chunk, past.smem_bytes) == fe.plan_bwd_tile(
        *SERVED)
    assert fe.plan_encoder_bwd(4096, *SERVED) == past
    monkeypatch.setattr(fe, 'BWD_SMALL_BATCH_MAX', 0)
    assert fe.plan_encoder_bwd(1, *SERVED) == past
    # one head: no cluster splits it
    monkeypatch.setattr(fe, 'BWD_SMALL_BATCH_MAX', 1 << 30)
    assert fe.plan_encoder_bwd(3, 10, 128, 512, 1).shape == 'large'


def test_bwd_split_rule():
    assert [fe.bwd_split(items, 16) for items in (1, 2, 4, 6, 8, 16, 32)] == [
        4, 4, 4, 2, 2, 1, 1]
    assert fe.bwd_split(2, 48) == 6 and fe.bwd_split(2, 64) == 8 and fe.bwd_split(1, 8) == 2
    for items in range(1, 20):
        for nk in (8, 16, 24, 32, 48, 64, 96, 128):
            s = fe.bwd_split(items, nk)
            assert nk % s == 0 and (nk // s) % 4 == 0
            assert s == 1 or items * s <= 16


def _bwd_buffers(plan, t, d, m, heads):
    """The small shape's buffers: (name, offset, bytes, first, last), with the
    span of the kernel's phases in which each is live, counting a buffer
    that another block writes into from the earliest such copy, and one that
    is the source of a copy to another block until this block can know that
    the copy completed. Phases: 0 stage, LN1; 1 q/k/v; 2 attention; 3 a
    exchanged; 4 projection; 5 h2 exchanged; 6 LN2, g; 7 the MLP products;
    8 dz1 exchanged; 9 dy2; 10 dy2 sent; 11 dy2 received, LN2's VJP; 12 da;
    13 attention backward; 14 dqkv exchanged; 15 dy1; 16 dy1 exchanged; 17
    LN1's VJP."""
    rows, c = plan.rows, plan.cluster
    gw, ld_r = d // c, d + 8
    f32_r, bf_r = rows * ld_r * 4, rows * ld_r * 2
    ld_g = gw + 4
    return [
        ('resid', 0, f32_r, 0, 17),
        ('y1, y2, dh2', plan.off_y, bf_r, 0, 12),
        ('da', plan.off_y, rows * ld_g * 4, 12.5, 13.5),
        ('a', plan.off_a, bf_r, 2, 5),
        ('g', plan.off_a, bf_r, 6, 7),
        ('dk', plan.off_a, rows * ld_g * 4, 13, 13.5),
        ('q/k/v', plan.off_q, rows * plan.ld_q * 4, 1, 13.5),
        ('dz1', plan.off_z, rows * plan.ld_z * 2, 5, 10),
        ('dqkv', plan.off_z, rows * plan.ld_dq * 2, 10.25, 17),
        ('dy2', plan.off_f, f32_r, 8, 14),
        ('dy1', plan.off_f, f32_r, 14.5, 17),
        ('scratch', plan.off_s, plan.scratch_floats * 4, 0, 17),
        ('rows', plan.off_v, (9 * d + m) * 4, 0, 17),
        ('P, dS', plan.off_p, 2 * plan.windows * (heads // c) * t * t * 4, 2, 13.5),
        ('stats', plan.off_st, 4 * rows * 4, 0, 17),
        ('mbarriers', plan.off_bar, 8 * 6, 0, 17),
    ]


def _check_bwd_plan(plan, batch, t, d, m, heads):
    assert plan.launches == fe.BWD_LAUNCHES_PER_LAYER
    assert plan.smem_bytes <= fe.MAX_SMEM and plan.windows >= 1
    assert plan.windows * t <= plan.rows
    if plan.shape == 'pair':
        _check_pair_plan(plan, t, d, m, heads)
        return
    if plan.shape == 'large':
        assert plan.cluster == 1
        assert (plan.row_tiles, plan.windows, plan.chunk, plan.smem_bytes) == (
            fe.plan_bwd_tile(t, d, m, heads))
        return
    c = plan.cluster
    assert c == fe.small_cluster(d, heads) and c > 1
    assert heads % c == 0 and (d // 16) % c == 0 and (m // 16) % c == 0
    assert plan.row_tiles in (1, 2, 3)
    assert (plan.tiles(batch) * c <= fe._SMALL_BLOCKS_AT_ONCE or plan.row_tiles == 3
            or fe._bwd_small_layout(t, d, m, heads, plan.row_tiles + 1, c) is None)
    bufs = _bwd_buffers(plan, t, d, m, heads)
    for name, off, size, _, _ in bufs:
        assert off % 16 == 0 or name == 'mbarriers', name
        assert off + size <= plan.smem_bytes, name
    assert plan.off_bar % 8 == 0
    for i, (n1, o1, s1, a1, b1) in enumerate(bufs):
        for n2, o2, s2, a2, b2 in bufs[i + 1:]:
            if o1 < o2 + s2 and o2 < o1 + s1:
                assert b1 < a2 or b2 < a1, (n1, n2)
    # every product's partial sums fit the scratch
    for _, n_prod, n, nk in fe.bwd_products(d, m, c):
        assert n_prod * n * fe.bwd_split(n_prod * n, nk) * plan.rows * 16 <= plan.scratch_floats
    # exchanges: a copy a row and peer of 16-byte multiples from 16-byte aligned rows
    gw = d // c
    for pitch, width in (((d + 8) * 2, gw * 2), ((d + 8) * 4, gw * 4),
                         (plan.ld_z * 2, m // c * 2), (plan.ld_dq * 2, gw * 2)):
        assert pitch % 16 == 0 and width % 16 == 0


@pytest.mark.parametrize('t', [1, 4, 10, 16, 32, 48])
def test_plan_encoder_bwd_takes_every_shape_plan_bwd_tile_takes(monkeypatch, t):
    for threshold, pair_min in ((0, 1 << 30), (64, 65), (1 << 30, 0), (0, 0)):
        monkeypatch.setattr(fe, 'BWD_SMALL_BATCH_MAX', threshold)
        monkeypatch.setattr(fe, 'BWD_PAIR_BATCH_MIN', pair_min)
        for d in (128, 256, 384, 512, 640):
            for m in (d, 2 * d, 4 * d, 640):
                for heads in (1, 2, 4, 8, 16, 32, 64):
                    try:
                        fe.plan_bwd_tile(t, d, m, heads)
                    except ValueError:
                        with pytest.raises(ValueError):
                            fe.plan_encoder_bwd(1, t, d, m, heads)
                        continue
                    for batch in (1, 8, 19, 64, 65, 4096):
                        plan = fe.plan_encoder_bwd(batch, t, d, m, heads)
                        _check_bwd_plan(plan, batch, t, d, m, heads)
                        small = (batch <= threshold and fe.small_cluster(d, heads) > 1
                                 and any(fe._bwd_small_layout(t, d, m, heads, rt,
                                                              fe.small_cluster(d, heads))
                                         for rt in (1, 2, 3)))
                        pair = (not small and batch >= pair_min
                                and fe.pair_takes(t, d, m, heads))
                        assert plan.shape == ('small' if small else 'pair' if pair
                                              else 'large')


def _pair_buffers(plan, d):
    """The pair shape's buffers: (name, offset, bytes, first, last), with the
    span of the kernel's phases in which each is live. Phases: 0 stage x,
    LN1; 1 q/k/v; 2 attention; 3 projection; 4 LN2, g; 5 the MLP (a chunk:
    5.0 its products, 5.25 the epilogue writes dz1, 5.75 dz1 W1^T); 6 dy2
    out; 7 LN2's VJP; 8 da; 9 attention backward; 10 dqkv out, x again; 11
    dy1; 12 LN1's VJP."""
    rows = plan.rows
    f32_r, bf_r = rows * (d + 4) * 4, rows * (d + 8) * 2
    return [
        ('x, h2, dh2, x (+ LN statistics)', 0, f32_r, 0, 12),
        ('y1, a, y2, dh2', plan.off_b, bf_r, 0, 8),
        ('q/k/v, then dq/dk/dv', plan.off_q, rows * plan.ld_q * 2, 1, 11),
        ('g', plan.off_m, bf_r, 4, 5.75),
        ('dz1 chunk', plan.off_dz, bf_r, 5.25, 5.75),
        ('dy2', plan.off_m, f32_r, 6, 7),
        ('da', plan.off_m, bf_r, 8, 9),
        ('dy1', plan.off_m, f32_r, 11, 12),
        ('ring', plan.off_ring, plan.slots * plan.slot_bytes, 0, 12),
        ('mbarriers', plan.off_bar, 2 * plan.slots * 8, 0, 12),
    ]


def _check_pair_plan(plan, t, d, m, heads):
    assert fe.pair_takes(t, d, m, heads) and d == fe.PAIR_D
    assert (plan.cluster, plan.rows, plan.windows, plan.chunk) == (2, 32, 32 // t, 256)
    assert plan.slot_bytes >= 32 * 1024 and plan.slots >= 2 and plan.slot_bytes % (16 * 512) == 0
    bufs = _pair_buffers(plan, d)
    for name, off, size, _, _ in bufs:
        assert off % (128 if name == 'ring' else 16) == 0, name
        assert off + size <= plan.smem_bytes, name
    for i, (n1, o1, s1, a1, b1) in enumerate(bufs):
        for n2, o2, s2, a2, b2 in bufs[i + 1:]:
            if o1 < o2 + s2 and o2 < o1 + s1:
                assert b1 < a2 or b2 < a1, (n1, n2)
    # mma rows 16-byte aligned, the LN statistics in the f32 rows' 4 spare columns
    for pitch in ((d + 8) * 2, plan.ld_q * 2, (d + 4) * 4):
        assert pitch % 16 == 0
    assert plan.ld_q >= 3 * d and len(plan.as_ints()) == 9


def test_plan_encoder_bwd_switches_to_the_pair_shape_at_both_thresholds(monkeypatch):
    monkeypatch.setattr(fe, 'BWD_SMALL_BATCH_MAX', 64)
    monkeypatch.setattr(fe, 'BWD_PAIR_BATCH_MIN', 128)
    shapes = {b: fe.plan_encoder_bwd(b, *SERVED).shape for b in (1, 64, 65, 127, 128, 4096)}
    assert shapes == {1: 'small', 64: 'small', 65: 'large', 127: 'large', 128: 'pair',
                      4096: 'pair'}
    a = fe.plan_encoder_bwd(128, *SERVED)
    assert a is fe.plan_encoder_bwd(128, *SERVED) and a == fe.plan_encoder_bwd(4096, *SERVED)
    assert (a.cluster, a.row_tiles, a.windows, a.chunk, a.smem_bytes) == (2, 2, 3, 256, 231984)
    assert a.as_ints() == (3, 33280, 50176, 99840, 116736, 133632, 231936, 32768, 3)
    assert a.tiles(4096) == 1366 and a.phases == fe.BWD_PAIR_PHASES
    assert a.launches == fe.BWD_LAUNCHES_PER_LAYER
    _check_pair_plan(a, *SERVED)
    # a pair threshold below the small one: the small shape keeps its batches
    monkeypatch.setattr(fe, 'BWD_PAIR_BATCH_MIN', 0)
    assert [fe.plan_encoder_bwd(b, *SERVED).shape for b in (64, 65)] == ['small', 'pair']
    # shapes the pair does not take stay with the large tile at every batch
    for t, d, m, heads in ((10, 128, 512, 4), (10, 512, 2048, 8), (10, 384, 1536, 8),
                           (20, 256, 1024, 8), (10, 256, 1024, 2), (10, 256, 640, 8)):
        assert not fe.pair_takes(t, d, m, heads)
        assert fe.plan_encoder_bwd(4096, t, d, m, heads).shape == 'large'
    for t, heads in ((1, 16), (4, 8), (16, 4), (10, 8)):
        assert fe.pair_takes(t, 256, 512, heads)


@pytest.mark.parametrize('m', [256, 1024])
def test_pair_stream_brings_each_weight_fragment_once_a_tile(m):
    """The ring's fills for a tile: every (k-step, 16-column block) of the
    seven weights the tile multiplies by exactly once, in the order the
    consumers take them, 32 KB a fill."""
    d = fe.PAIR_D
    fills = fe.bwd_pair_stream(m)
    kn = {'wqkv': (d, 3 * d), 'wproj': (d, d), 'wmlp1': (d, m), 'wmlp2_t': (d, m),
          'wmlp1_t': (m, d), 'wproj_t': (d, d), 'wqkv_t': (3 * d, d)}
    seen = {name: np.zeros((k // 16, n // 16), int) for name, (k, n) in kn.items()}
    for name, nk, b0, ks in fills:
        k, n = kn[name]
        assert nk == k // 16 and ks % 4 == 0 and b0 % 16 == 0
        seen[name][ks:ks + 4, b0:b0 + 16] += 1
    for name, a in seen.items():
        assert (a == 1).all(), name
    assert len(fills) * 16 * 4 * 512 == 2 * (8 * d * d + 3 * d * m)
    order = [f[0] for f in fills[::4]]
    assert order == (['wqkv'] * 3 + ['wproj'] + ['wmlp1', 'wmlp2_t', 'wmlp1_t'] * (m // 256)
                     + ['wproj_t'] + ['wqkv_t'] * 3)


def test_pair_stream_offsets_pick_the_packed_fragments():
    """Where the kernel's producer copies a fill's 16 blocks from (2 KB each
    at ((b0 + i) nk + ks) x 512 bytes into the weight, the weights end to end
    as packed) holds those blocks' 4 k-steps in fragment order."""
    d, m = fe.PAIR_D, 256
    params = [torch.from_numpy(p) for p in _params(5, d, 1)]
    packed = fe.pack_encoder_params(params, 'cpu', transposes=True)
    w = {name: params[i].to(torch.bfloat16) for name, i in
         (('wqkv', 2), ('wproj', 4), ('wmlp1', 8), ('wmlp2', 10))}
    mats = dict(wqkv=(packed.weights, 0, w['wqkv']), wproj=(packed.weights, 3 * d * d, w['wproj']),
                wmlp1=(packed.weights, 4 * d * d, w['wmlp1']),
                wqkv_t=(packed.weights_t, 0, w['wqkv'].t()),
                wproj_t=(packed.weights_t, 3 * d * d, w['wproj'].t()),
                wmlp1_t=(packed.weights_t, 4 * d * d, w['wmlp1'].t()),
                wmlp2_t=(packed.weights_t, 4 * d * d + d * m, w['wmlp2'].t()))
    for name, nk, b0, ks in fe.bwd_pair_stream(m):
        flat, base, mat = mats[name]
        for i in range(16):
            off = base + ((b0 + i) * nk + ks) * 256
            want = fragment_order(mat[16 * ks:16 * ks + 64, 16 * (b0 + i):16 * (b0 + i) + 16])
            assert torch.equal(flat[off:off + 1024], want.reshape(-1)), (name, b0, ks, i)


def test_bwd_columns_cover_each_column_once():
    for d, m, heads, c in ((256, 1024, 8, 8), (128, 512, 4, 4), (384, 1536, 8, 8)):
        seen = np.zeros(3, dtype=object)
        heads_seen, d_seen, m_seen = [], [], []
        for rank in range(c):
            h, dc, mc = fe.bwd_columns(d, m, heads, c, rank)
            heads_seen += list(h)
            d_seen += list(dc)
            m_seen += list(mc)
            # a block's d columns are its heads' columns of q (k, v)
            dh = d // heads
            assert list(dc) == [hh * dh + i for hh in h for i in range(dh)]
        del seen
        assert sorted(heads_seen) == list(range(heads))
        assert sorted(d_seen) == list(range(d)) and sorted(m_seen) == list(range(m))


def _bf(a):
    """Round float64 values to bf16 (and back)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).double().numpy()


def _gelu64(z):
    return 0.5 * z * (1 + np.tanh(0.7978845608028654 * (z + 0.044715 * z ** 3)))


def _gelu_grad64(z):
    u = 0.7978845608028654 * (z + 0.044715 * z ** 3)
    th = np.tanh(u)
    du = 0.7978845608028654 * (1 + 3 * 0.044715 * z * z)
    return 0.5 * (1 + th) + 0.5 * z * (1 - th * th) * du


def _ln64(x, scale, bias):
    mu = x.mean(-1, keepdims=True)
    rs = 1 / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + fe.LN_EPS)
    xhat = (x - mu) * rs
    return xhat * scale + bias, xhat, rs


def _ln_bwd64(dy, xhat, rs, scale):
    dxhat = dy * scale
    return rs * (dxhat - dxhat.mean(-1, keepdims=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdims=True))


def _attn_fwd64(q, k, v, t):
    """q, k, v [rows, H', dh] of whole windows (q scaled) -> mix, probs."""
    w = q.shape[0] // t
    q, k, v = (a.reshape(w, t, *a.shape[1:]) for a in (q, k, v))
    s = np.einsum('wihc,wjhc->wijh', q, k)
    p = np.exp(s - s.max(2, keepdims=True))
    p /= p.sum(2, keepdims=True)
    return np.einsum('wijh,wjhc->wihc', p, v).reshape(w * t, *q.shape[2:]), p


def _attn_bwd64(q, k, v, p, da, t, scale):
    w = q.shape[0] // t
    q, k, v, da = (a.reshape(w, t, *a.shape[1:]) for a in (q, k, v, da))
    dv = np.einsum('wijh,wihc->wjhc', p, da)
    dp = np.einsum('wihc,wjhc->wijh', da, v)
    ds = p * (dp - (p * dp).sum(2, keepdims=True))
    dk = np.einsum('wijh,wihc->wjhc', ds, q)
    dq = np.einsum('wijh,wjhc->wihc', ds, k) * scale
    return tuple(a.reshape(w * t, *a.shape[2:]) for a in (dq, dk, dv))


def _bwd64(x, g, params, heads):
    """encoder_layer_bwd_reference in float64, operands rounded to bf16 at
    the same places."""
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.astype(np.float64) for p in params)
    b, t, d = x.shape
    n, dh = b * t, d // heads
    scale = dh ** -0.5
    Wq, Wp, W1, W2 = (_bf(w) for w in (wqkv, wproj, w1, w2))
    h = x.reshape(n, d).astype(np.float64)
    go = g.reshape(n, d).astype(np.float64)
    y1, xh1, rs1 = _ln64(h, g1, b1)
    qkv = _bf(y1) @ Wq + bqkv
    q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(n, heads, dh) for i in range(3))
    q = q * scale
    a, p = _attn_fwd64(q, k, v, t)
    a = a.reshape(n, d)
    h2 = h + _bf(a) @ Wp + bproj
    y2, xh2, rs2 = _ln64(h2, g2, b2)
    z1 = _bf(y2) @ W1 + bm1
    u = _gelu64(z1)
    dz1 = (_bf(go) @ W2.T) * _gelu_grad64(z1)
    dy2 = _bf(dz1) @ W1.T
    dh2 = go + _ln_bwd64(dy2, xh2, rs2, g2)
    da = (_bf(dh2) @ Wp.T).reshape(n, heads, dh)
    dq, dk, dv = _attn_bwd64(q, k, v, p, da, t, scale)
    dqkv = np.concatenate([a_.reshape(n, d) for a_ in (dq, dk, dv)], 1)
    dy1 = _bf(dqkv) @ Wq.T
    dx = dh2 + _ln_bwd64(dy1, xh1, rs1, g1)
    grads = ((dy1 * xh1).sum(0), dy1.sum(0), _bf(y1).T @ _bf(dqkv), dqkv.sum(0),
             _bf(a).T @ _bf(dh2), dh2.sum(0), (dy2 * xh2).sum(0), dy2.sum(0),
             _bf(y2).T @ _bf(dz1), dz1.sum(0), _bf(u).T @ _bf(go), go.sum(0))
    return dx.reshape(b, t, d), grads


def _replay_small(x, g, params, heads, plan):
    """The small shape as the kernel runs it, in float64: each block of a
    cluster computes its own columns from what it holds, the exchanges
    assemble full rows (each column from exactly one block), each block
    writes its own columns of the workspace and of dx and sums its own
    columns of the vector gradients over the valid rows; then the weight
    gradients from the workspace. Row tiles are padded with zero windows."""
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.astype(np.float64) for p in params)
    b, t, d = x.shape
    m, c = w1.shape[1], plan.cluster
    n, dh, rows = b * t, d // heads, plan.rows
    scale = dh ** -0.5
    Wq, Wp, W1, W2 = (_bf(w) for w in (wqkv, wproj, w1, w2))
    own = [fe.bwd_columns(d, m, heads, c, r) for r in range(c)]
    nan = lambda *s: np.full(s, np.nan)                                # noqa: E731
    ws = dict(y1=nan(n, d), dqkv=nan(n, 3 * d), attn=nan(n, d), dh2=nan(n, d),
              y2=nan(n, d), dz1=nan(n, m), u=nan(n, m), g=nan(n, d))
    dx = nan(n, d)
    vec = dict(dg1=np.zeros(d), db1=np.zeros(d), dbqkv=np.zeros(3 * d), dbproj=np.zeros(d),
               dg2=np.zeros(d), db2=np.zeros(d), dbm1=np.zeros(m), dbm2=np.zeros(d))
    count = {k: np.zeros_like(v) for k, v in vec.items()}

    def assemble(width, parts):
        """One exchange: every block's columns into full rows, each once."""
        full, hits = np.zeros((rows, width)), np.zeros(width, int)
        for cols, val in parts:
            full[:, cols] = val
            hits[cols] += 1
        assert (hits == 1).all()
        return full

    def sums(name, cols, val):
        vec[name][cols] += val[:valid].sum(0)
        count[name][cols] += 1

    def to_ws(name, cols, val):
        assert np.isnan(ws[name][r0:r0 + valid, cols]).all()
        ws[name][r0:r0 + valid, cols] = val[:valid]

    for tile in range(plan.tiles(b)):
        win0 = tile * plan.windows
        valid = min(plan.windows, b - win0) * t
        r0 = win0 * t
        tr = plan.windows * t                     # rows of whole windows
        X, G = np.zeros((rows, d)), np.zeros((rows, d))
        X[:valid] = x.reshape(n, d)[r0:r0 + valid]
        G[:valid] = g.reshape(n, d)[r0:r0 + valid]
        y1, xh1, rs1 = _ln64(X, g1, b1)           # every block, full rows
        y1 = _bf(y1)
        a_parts, held = [], []
        for hs, dc, _ in own:
            qkv_cols = [i * d + j for i in range(3) for j in dc]
            qkv = y1 @ Wq[:, qkv_cols] + bqkv[qkv_cols]
            gw = len(dc)
            q = qkv[:tr, :gw].reshape(tr, len(hs), dh) * scale
            k = qkv[:tr, gw:2 * gw].reshape(tr, len(hs), dh)
            v = qkv[:tr, 2 * gw:].reshape(tr, len(hs), dh)
            a, p = _attn_fwd64(q, k, v, t)
            a_own = np.zeros((rows, gw))
            a_own[:tr] = _bf(a.reshape(tr, gw))
            a_parts.append((dc, a_own))
            held.append((q, k, v, p))
            to_ws('y1', dc, y1[:, dc])
            to_ws('attn', dc, a_own)
        a_full = assemble(d, a_parts)
        h2 = assemble(d, [(dc, X[:, dc] + a_full @ Wp[:, dc] + bproj[dc]) for _, dc, _ in own])
        y2, xh2, rs2 = _ln64(h2, g2, b2)
        y2, gb = _bf(y2), _bf(G)
        dz_parts = []
        for _, dc, mc in own:
            to_ws('y2', dc, y2[:, dc])
            to_ws('g', dc, gb[:, dc])
            sums('dbm2', dc, G[:, dc])
            z = y2 @ W1[:, mc] + bm1[mc]
            dz = (gb @ W2.T[:, mc]) * _gelu_grad64(z)
            to_ws('u', mc, _bf(_gelu64(z)))
            to_ws('dz1', mc, _bf(dz))
            sums('dbm1', mc, dz)
            dz_parts.append((mc, _bf(dz)))
        dz_full = assemble(m, dz_parts)
        dy2 = assemble(d, [(dc, dz_full @ W1.T[:, dc]) for _, dc, _ in own])
        dh2 = G + _ln_bwd64(dy2, xh2, rs2, g2)   # every block, full rows
        dh2b = _bf(dh2)
        dq_parts = []
        for (hs, dc, _), (q, k, v, p) in zip(own, held):
            sums('dg2', dc, dy2[:, dc] * xh2[:, dc])
            sums('db2', dc, dy2[:, dc])
            sums('dbproj', dc, dh2[:, dc])
            to_ws('dh2', dc, dh2b[:, dc])
            da = (dh2b @ Wp.T[:, dc])[:tr].reshape(tr, len(hs), dh)
            own_dqkv = np.zeros((rows, 3 * len(dc)))
            for i, part in enumerate(_attn_bwd64(q, k, v, p, da, t, scale)):
                own_dqkv[:tr, i * len(dc):(i + 1) * len(dc)] = part.reshape(tr, -1)
            qkv_cols = [i * d + j for i in range(3) for j in dc]
            sums('dbqkv', qkv_cols, own_dqkv)
            to_ws('dqkv', qkv_cols, _bf(own_dqkv))
            dq_parts.append((qkv_cols, _bf(own_dqkv)))
        dqkv_full = assemble(3 * d, dq_parts)
        dy1 = assemble(d, [(dc, dqkv_full @ Wq.T[:, dc]) for _, dc, _ in own])
        ln1 = _ln_bwd64(dy1, xh1, rs1, g1)
        for _, dc, _ in own:
            sums('dg1', dc, dy1[:, dc] * xh1[:, dc])
            sums('db1', dc, dy1[:, dc])
            assert np.isnan(dx[r0:r0 + valid, dc]).all()
            dx[r0:r0 + valid, dc] = (dh2[:, dc] + ln1[:, dc])[:valid]
    for name, k in count.items():               # each column of each tile once
        assert (k == plan.tiles(b)).all(), name
    for name, a in ws.items():
        assert not np.isnan(a).any(), name
    grads = (vec['dg1'], vec['db1'], ws['y1'].T @ ws['dqkv'], vec['dbqkv'],
             ws['attn'].T @ ws['dh2'], vec['dbproj'], vec['dg2'], vec['db2'],
             ws['y2'].T @ ws['dz1'], vec['dbm1'], ws['u'].T @ ws['g'], vec['dbm2'])
    return dx.reshape(b, t, d), grads


@pytest.mark.parametrize('batch,t,d,heads', [
    (1, 10, 256, 8),          # the served width, one window, one row tile
    (8, 10, 256, 8),
    (64, 10, 256, 8),         # the default batch: 22 tiles of three windows, the last ragged
    (5, 4, 128, 4),           # a cluster of 4, four windows a row tile
])
def test_small_shape_replay_is_exact(bwd_threshold, batch, t, d, heads):
    """The small shape's column ownership and exchanges, replayed in float64,
    give the float64 backward to rounding (1e-9), and both agree with
    encoder_layer_bwd_reference at the bf16 tolerance."""
    bwd_threshold('small')
    m = 4 * d
    plan = fe.plan_encoder_bwd(batch, t, d, m, heads)
    assert plan.shape == 'small'
    params = _params(batch + d, d)
    x, g = _xg(batch + 3, batch, t, d)
    got_dx, got = _replay_small(x, g, params, heads, plan)
    want_dx, want = _bwd64(x, g, params, heads)
    ref = _port(x, g, params, heads, torch.bfloat16)
    for name, a, w, r in zip(NAMES, (got_dx, *got), (want_dx, *want), ref):
        assert a.shape == w.shape == r.shape and np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=0, atol=1e-9 * max(1.0, np.abs(w).max()),
                                   err_msg=f'd{name}')
        np.testing.assert_allclose(a, r, rtol=0, atol=2e-2 * np.abs(r).max(),
                                   err_msg=f'd{name}')


def _replay_pair(x, g, params, heads, plan, clusters, rounded=False):
    """The pair shape as the kernel runs it, in float64: the blocks of
    ``clusters`` clusters of two walk over pairs of tiles (block ``rank`` of
    a pair the tile 2 p + rank, the last pair's second block maybe none),
    every product accumulated fill by fill in the ring's order
    (:func:`fused_encoder.bwd_pair_stream`) into the 16 column blocks the
    fill names, the attention a (window, head) at a time on a tile of 16
    frames (rows past the buffer read its last row, keys past T masked,
    queries past T a row of zeros) in place over q/k/v, the vector
    gradients summed a tile at a time into the block's slab and the slabs
    added in block order. ``rounded`` also rounds to bf16 what the kernel
    keeps or multiplies as bf16 beyond the plain version: q/k/v, P, dS, the
    mix's gradient and dq/dk/dv."""
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.astype(np.float64) for p in params)
    b, t, d = x.shape
    m = w1.shape[1]
    n, dh, rows = b * t, d // heads, plan.rows
    scale = dh ** -0.5
    rnd = _bf if rounded else (lambda a: a)
    Wq, Wp, W1, W2 = (_bf(w) for w in (wqkv, wproj, w1, w2))
    mats = dict(wqkv=Wq, wproj=Wp, wmlp1=W1, wmlp2_t=W2.T, wmlp1_t=W1.T, wproj_t=Wp.T,
                wqkv_t=Wq.T)
    nan = lambda *s: np.full(s, np.nan)                                # noqa: E731
    ws = dict(y1=nan(n, d), dqkv=nan(n, 3 * d), attn=nan(n, d), dh2=nan(n, d),
              y2=nan(n, d), dz1=nan(n, m), u=nan(n, m), g=nan(n, d))
    dx = nan(n, d)
    n_tiles = plan.tiles(b)
    pairs = -(-n_tiles // 2)
    grid = fe.bwd_blocks(plan, b, 2 * clusters)       # a card of 2 x clusters SMs
    assert grid == 2 * min(pairs, clusters)
    names = ('dg1', 'db1', 'dbqkv', 'dbproj', 'dg2', 'db2', 'dbm1', 'dbm2')
    widths = (d, d, 3 * d, d, d, d, m, d)
    slabs = [{k: np.zeros(w) for k, w in zip(names, widths)} for _ in range(grid)]
    taken = []

    def window(r0):                    # the 16 rows of a window's mma tile
        return np.minimum(r0 + np.arange(16), rows - 1)

    def probs(Q, r0, h):
        idx, hc = window(r0), slice(h * dh, (h + 1) * dh)
        s = Q[idx, hc] @ Q[idx, d:][:, hc].T
        s[:, t:] = -np.inf
        p = np.exp(s - s.max(1, keepdims=True))
        p /= p.sum(1, keepdims=True)
        p[t:] = 0.0
        return idx, hc, p

    for blk in range(grid):
        cluster, rank = divmod(blk, 2)
        vec = slabs[blk]
        for pair in range(cluster, pairs, grid // 2):
            tile = 2 * pair + rank
            fills = iter(fe.bwd_pair_stream(m))

            def product(A, n_fills, want, b0=0):
                out = np.zeros((rows, 256))
                for j in range(n_fills):
                    name, nk, fb0, ks = next(fills)
                    assert (name, fb0) == (want, b0)
                    out += A[:, 64 * j:64 * j + 64] @ mats[name][16 * ks:16 * ks + 64,
                                                                 16 * b0:16 * b0 + 256]
                return out

            win0 = tile * plan.windows
            valid = max(0, min(plan.windows, b - win0)) * t
            r0 = win0 * t
            if valid:
                taken.append(tile)

            def to_ws(name, val, cols=slice(None)):
                assert np.isnan(ws[name][r0:r0 + valid, cols]).all()
                ws[name][r0:r0 + valid, cols] = val[:valid]

            X, G = np.zeros((rows, d)), np.zeros((rows, d))
            X[:valid] = x.reshape(n, d)[r0:r0 + valid]
            G[:valid] = g.reshape(n, d)[r0:r0 + valid]
            y1, xh1, rs1 = _ln64(X, g1, b1)
            y1 = _bf(y1)
            to_ws('y1', y1)
            Q = np.zeros((rows, 3 * d))
            for grp in range(3):
                v = product(y1, 4, 'wqkv', 16 * grp) + bqkv[256 * grp:256 * grp + 256]
                Q[:, 256 * grp:256 * grp + 256] = rnd(v * scale if grp == 0 else v)
            A = y1.copy()
            for h in range(heads):
                for w in range(valid // t):
                    idx, hc, p = probs(Q, w * t, h)
                    A[w * t:w * t + t, hc] = _bf(rnd(p) @ Q[idx, 2 * d:][:, hc])[:t]
            to_ws('attn', A)
            H2 = X + product(A, 4, 'wproj') + bproj
            y2, xh2, rs2 = _ln64(H2, g2, b2)
            y2, Gb = _bf(y2), _bf(G)
            to_ws('y2', y2)
            to_ws('g', Gb)
            vec['dbm2'] += G[:valid].sum(0)
            dy2 = np.zeros((rows, d))
            for c0 in range(0, m, 256):
                z = product(y2, 4, 'wmlp1', c0 // 16) + bm1[c0:c0 + 256]
                dz = product(Gb, 4, 'wmlp2_t', c0 // 16) * _gelu_grad64(z)
                to_ws('u', _bf(_gelu64(z)), slice(c0, c0 + 256))
                to_ws('dz1', _bf(dz), slice(c0, c0 + 256))
                vec['dbm1'][c0:c0 + 256] += dz[:valid].sum(0)
                dy2 += product(_bf(dz), 4, 'wmlp1_t')
            vec['dg2'] += (dy2 * xh2)[:valid].sum(0)
            vec['db2'] += dy2[:valid].sum(0)
            dh2 = G + _ln_bwd64(dy2, xh2, rs2, g2)
            vec['dbproj'] += dh2[:valid].sum(0)
            to_ws('dh2', _bf(dh2))
            dx[r0:r0 + valid] = dh2[:valid]                 # parked
            da = rnd(product(_bf(dh2), 4, 'wproj_t'))
            for h in range(heads):
                for w in range(valid // t):
                    idx, hc, p = probs(Q, w * t, h)
                    q, k, v = (Q[idx, i * d:][:, hc] for i in range(3))
                    dah = da[idx][:, hc]
                    dp = dah @ v.T
                    ds = p * (dp - (p * dp).sum(1, keepdims=True))
                    grads = (rnd(ds) @ k * scale, rnd(ds).T @ q, rnd(p).T @ dah)
                    for i, gr in enumerate(grads):           # dq, dk, dv over q, k, v
                        Q[w * t:w * t + t, i * d:][:, hc] = rnd(gr[:t])
                        vec['dbqkv'][i * d:][hc] += gr[:t].sum(0)
            to_ws('dqkv', _bf(Q))
            dy1 = product(_bf(Q), 12, 'wqkv_t')
            vec['dg1'] += (dy1 * xh1)[:valid].sum(0)
            vec['db1'] += dy1[:valid].sum(0)
            dx[r0:r0 + valid] += _ln_bwd64(dy1, xh1, rs1, g1)[:valid]
            assert next(fills, None) is None                # every fill taken, in order
    assert sorted(taken) == list(range(n_tiles))            # each tile once
    for name, a in ws.items():
        assert not np.isnan(a).any(), name
    v = {k: sum(sl[k] for sl in slabs) for k in names}
    grads = (v['dg1'], v['db1'], ws['y1'].T @ ws['dqkv'], v['dbqkv'],
             ws['attn'].T @ ws['dh2'], v['dbproj'], v['dg2'], v['db2'],
             ws['y2'].T @ ws['dz1'], v['dbm1'], ws['u'].T @ ws['g'], v['dbm2'])
    return dx.reshape(b, t, d), grads


@pytest.mark.parametrize('batch,t,heads,m,clusters', [
    (7, 10, 8, 256, 1),     # three tiles: two pairs walked by one cluster, one block idle
    (7, 10, 8, 512, 2),     # two MLP chunks, a cluster a pair
    (9, 4, 16, 256, 1),     # eight windows a tile, a head width of 16
    (5, 16, 4, 256, 3),     # two windows of 16 frames a tile, more clusters than pairs
    (4, 7, 8, 256, 1),      # T that 32 does not divide: rows past the windows
])
def test_pair_shape_replay_is_exact(bwd_threshold, batch, t, heads, m, clusters):
    """The pair shape's work split, replayed in float64, gives the float64
    backward to rounding (1e-9); with the kernel's extra bf16 roundings it
    agrees with encoder_layer_bwd_reference at the bf16 tolerance."""
    bwd_threshold('pair')
    d = fe.PAIR_D
    plan = fe.plan_encoder_bwd(batch, t, d, m, heads)
    assert plan.shape == 'pair'
    params = _params(batch + t, d, m // d)
    x, g = _xg(batch + 5, batch, t, d)
    want_dx, want = _bwd64(x, g, params, heads)
    ref = _port(x, g, params, heads, torch.bfloat16)
    for rounded in (False, True):
        got_dx, got = _replay_pair(x, g, params, heads, plan, clusters, rounded)
        for name, a, w, r in zip(NAMES, (got_dx, *got), (want_dx, *want), ref):
            assert a.shape == w.shape == r.shape and np.isfinite(a).all(), name
            if not rounded:
                np.testing.assert_allclose(a, w, rtol=0, atol=1e-9 * max(1.0, np.abs(w).max()),
                                           err_msg=f'd{name}')
            np.testing.assert_allclose(a, r, rtol=0, atol=2e-2 * np.abs(r).max(),
                                       err_msg=f'd{name} rounded={rounded}')


def test_tune_parses_the_encoder_bwd_command(monkeypatch):
    from inferbiomechanics_tpu_torch.ops import tune
    args = tune.build_parser().parse_args(['--kernel', 'encoder_bwd', '--quick',
                                           '--baseline', 'build/parent'])
    assert (args.kernel, args.quick, args.baseline) == ('encoder_bwd', True, 'build/parent')
    assert tune._bwd_shapes(True, 64) == {shape: fe.bwd_thresholds(shape)
                                          for shape in ('small', 'pair', 'large')}
    assert tune._bwd_shapes(True, 4096) == {'pair': (0, 0), 'large': (0, 1 << 30)}
    assert tune._bwd_shapes(False, 1) == {'kernel': None}
    assert set(tune.BWD_BATCHES) >= {1, 8, 16, 32, 56, 64, 65, 96, 127, 128, 256, 512, 1024,
                                     4096}
    assert len(fe.BWD_PHASES) == 18 and len(fe.BWD_PAIR_PHASES) == 14
