"""The port's fused encoder layer (inferbiomechanics_tpu_torch/ops/
fused_encoder.py) against the JAX package's (inferbiomechanics_tpu/ops/
pallas_encoder.py), on the same numpy inputs.

The port's CUDA kernel cannot run on the CPU; its plain version
``encoder_layer_reference`` defines what the kernel computes, and is held
here against the JAX reference and against the Pallas kernel in interpret
mode, for both of its kernel versions, at the JAX suite's own shapes and
tolerances (tests/test_pallas_encoder.py: B=16, T=10, d=128, H=4,
tile_rows=8; f32 at rtol 1e-4 / atol 1e-5). The kernel itself is held
against the plain version on the card (tests/test_torch_cuda_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.ops import pallas_encoder as jpe
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe

B, T, D, H = 16, 10, 128, 4
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: the JAX suite allows rtol = atol = 5e-2 between its kernel and its
# reference. Both sides here round the same operands to bf16 and sum in
# f32, so they differ by summation order and the bf16 roundings it flips:
# 2e-2 on outputs of a few units.
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _params(seed, d=D, mlp_ratio=4):
    """Seeded numpy parameters in PARAM_NAMES order; biases and LayerNorm
    rows are random, not the zeros and ones of ``init_encoder_params``, so
    that a missing or misplaced bias shows."""
    rng = np.random.default_rng(seed)
    m = d * mlp_ratio
    shapes = {'ln1_scale': (d,), 'ln1_bias': (d,), 'wqkv': (d, 3 * d),
              'bqkv': (3 * d,), 'wproj': (d, d), 'bproj': (d,),
              'ln2_scale': (d,), 'ln2_bias': (d,), 'wmlp1': (d, m),
              'bmlp1': (m,), 'wmlp2': (m, d), 'bmlp2': (d,)}
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


def _x(seed, b=B, t=T, d=D):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(np.float32)


def _port(x, params, heads, dtype):
    with torch.no_grad():
        return fe.encoder_layer_reference(
            torch.from_numpy(x), [torch.from_numpy(p) for p in params], heads,
            compute_dtype=dtype).numpy()


def test_param_names_match_jax():
    assert fe.PARAM_NAMES == jpe.PARAM_NAMES


@pytest.mark.parametrize('dtype,jdtype,tol', [
    (torch.float32, jnp.float32, F32_TOL),
    (torch.bfloat16, jnp.bfloat16, BF16_TOL),
])
@pytest.mark.parametrize('t', [10, 4])
def test_reference_matches_jax_reference(dtype, jdtype, tol, t):
    x, params = _x(0, t=t), _params(0)
    want = jpe.encoder_layer_reference(jnp.asarray(x), tuple(map(jnp.asarray, params)),
                                       H, compute_dtype=jdtype)
    got = _port(x, params, H, dtype)
    assert got.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.mark.parametrize('kernel_version', [1, 2])
@pytest.mark.parametrize('dtype,jdtype,tol', [
    (torch.float32, jnp.float32, F32_TOL),
    (torch.bfloat16, jnp.bfloat16, BF16_TOL),
])
def test_reference_matches_pallas_kernel_in_interpret_mode(kernel_version, dtype,
                                                           jdtype, tol):
    x, params = _x(1), _params(1)
    want = jpe.encoder_layer_pallas(
        jnp.asarray(x), tuple(map(jnp.asarray, params)), H, tile_rows=8,
        compute_dtype=jdtype, interpret=True, kernel_version=kernel_version)
    np.testing.assert_allclose(_port(x, params, H, dtype), np.asarray(want), **tol)


def test_reference_matches_pallas_kernel_with_four_frames():
    x, params = _x(2, b=8, t=4), _params(2)
    want = jpe.encoder_layer_pallas(
        jnp.asarray(x), tuple(map(jnp.asarray, params)), H, tile_rows=8,
        compute_dtype=jnp.float32, interpret=True, kernel_version=2)
    np.testing.assert_allclose(_port(x, params, H, torch.float32),
                               np.asarray(want), **F32_TOL)


def test_qkv_columns_are_q_k_v_each_head_major():
    """Permuting whole heads of q and k together leaves the layer unchanged;
    that holds only if the 3 d columns are [q | k | v], each [H, dh]."""
    x, params = _x(3), _params(3)
    dh = D // H
    perm = np.concatenate([np.arange(dh) + h * dh for h in (2, 0, 3, 1)])
    cols = np.concatenate([perm, D + perm, 2 * D + perm])
    moved = list(params)
    moved[2], moved[3] = params[2][:, cols], params[3][cols]
    moved[4] = params[4][perm, :]        # proj rows follow the v heads
    np.testing.assert_allclose(_port(x, moved, H, torch.float32),
                               _port(x, params, H, torch.float32), **F32_TOL)


def test_init_encoder_params_shapes_and_seed():
    a = fe.init_encoder_params(torch.Generator().manual_seed(5), D)
    b = fe.init_encoder_params(torch.Generator().manual_seed(5), D)
    import jax
    want = jpe.init_encoder_params(jax.random.PRNGKey(0), D)
    assert [tuple(p.shape) for p in a] == [tuple(p.shape) for p in want]
    for p, q, name in zip(a, b, fe.PARAM_NAMES):
        assert torch.equal(p, q), name
        if p.ndim == 1:     # unit LayerNorm scale, zero biases: as in JAX
            assert torch.equal(p, torch.ones_like(p) if name.endswith('scale')
                               else torch.zeros_like(p))
        else:               # LeCun normal: variance 1 / fan_in
            assert abs(float(p.std()) * p.shape[0] ** 0.5 - 1) < 0.05, name


def test_wrapper_takes_the_plain_version_on_the_cpu_and_no_other_fallback():
    x, params = torch.from_numpy(_x(4)), [torch.from_numpy(p) for p in _params(4)]
    packed = fe.pack_encoder_params(params, 'cpu')
    assert packed.weights.dtype == torch.bfloat16 and packed.rows.dtype == torch.float32
    assert packed.weights.numel() == 12 * D * D and packed.rows.numel() == 13 * D
    before = fe.launches
    out = fe.fused_encoder_layer(x, packed, H)
    assert fe.launches == before        # no kernel ran
    assert torch.equal(out, fe.encoder_layer_reference(x, packed.params, H))
    with pytest.raises(ValueError, match='no kernel for device'):
        fe.fused_encoder_layer(x.to('meta'), packed, H)


def test_pack_refuses_wrong_shapes():
    params = [torch.from_numpy(p) for p in _params(5)]
    with pytest.raises(ValueError, match='expected 12 parameters'):
        fe.pack_encoder_params(params[:-1], 'cpu')
    params[3] = params[3][:-1]
    with pytest.raises(ValueError, match='bqkv'):
        fe.pack_encoder_params(params, 'cpu')


@pytest.mark.parametrize('t,d,m,heads,plan', [
    (10, 256, 1024, 8, (3, 4)),      # the served shape: 4 windows, 48 rows
    (4, 128, 512, 4, (3, 12)),
    (10, 384, 1536, 8, (2, 3)),
    (16, 768, 3072, 8, (1, 1)),
    (48, 256, 1024, 8, (3, 1)),
])
def test_plan_tile(t, d, m, heads, plan):
    assert fe.plan_tile(t, d, m, heads) == plan


@pytest.mark.parametrize('t,d,m,heads', [
    (10, 192, 768, 8),        # d_model not a multiple of 128
    (10, 1024, 4096, 8),      # too wide for a block's shared memory
    (49, 256, 1024, 8),       # window longer than a block's rows
    (10, 256, 1024, 256),     # odd head width
])
def test_fused_encoder_kernel_refuses_shapes_it_cannot_take(t, d, m, heads):
    with pytest.raises(ValueError, match='fused encoder kernel'):
        fe.plan_tile(t, d, m, heads)


# ---------------------------------------------------------------------------
# plan_encoder: which shape of the forward kernel takes a call (CPU: the plan
# is a pure function of the shape; the kernel runs it on the card)
# ---------------------------------------------------------------------------

# every shape plan_tile takes: d and MLP width multiples of 128, even head
# widths, windows that fit
_ENVELOPE = [(t, d, d * r, h) for d in (128, 256, 384, 512, 768) for r in (1, 2, 4)
             for h in (1, 2, 4, 8, 16, 64) for t in (1, 4, 7, 10, 16, 17, 32, 48)
             if d % h == 0 and (d // h) % 2 == 0]


def _accepted(t, d, m, h):
    try:
        fe.plan_tile(t, d, m, h)
        return True
    except ValueError:
        return False


@pytest.mark.parametrize('batch,t,d,m,heads,want', [
    (1, 10, 256, 1024, 8, ('small', 8, 1, 1)),      # one window: one row tile
    (14, 10, 256, 1024, 8, ('small', 8, 1, 1)),     # 14 clusters run at once
    (15, 10, 256, 1024, 8, ('small', 8, 2, 3)),
    (42, 10, 256, 1024, 8, ('small', 8, 2, 3)),
    (43, 10, 256, 1024, 8, ('small', 8, 3, 4)),
    (fe.SMALL_BATCH_MAX, 10, 256, 1024, 8, ('small', 8, 3, 4)),
    (fe.SMALL_BATCH_MAX + 1, 10, 256, 1024, 8, ('large', 1, 3, 4)),
    (4096, 10, 256, 1024, 8, ('large', 1, 3, 4)),   # plan_tile's tile
    (37, 4, 128, 512, 4, ('small', 4, 1, 4)),       # 32-wide heads: 4 blocks
    (3, 16, 768, 3072, 8, ('small', 8, 1, 1)),
    (1, 10, 128, 512, 1, ('large', 1, 3, 4)),       # one head cannot be split
    (1, 10, 128, 512, 64, ('small', 8, 1, 1)),      # 2-wide heads, 8 a block
])
def test_plan_encoder_picks_shape_cluster_and_tile(batch, t, d, m, heads, want):
    plan = fe.plan_encoder(batch, t, d, m, heads)
    assert (plan.shape, plan.cluster, plan.row_tiles, plan.windows) == want
    assert plan == fe.plan_encoder(batch, t, d, m, heads)       # pure
    if plan.shape == 'large':
        assert (plan.row_tiles, plan.windows) == fe.plan_tile(t, d, m, heads)


def test_plan_encoder_takes_every_shape_plan_tile_takes():
    batches = (1, 2, 5, 37, fe.SMALL_BATCH_MAX, fe.SMALL_BATCH_MAX + 1, 4096)
    taken = 0
    for t, d, m, h in _ENVELOPE:
        if not _accepted(t, d, m, h):
            with pytest.raises(ValueError, match='fused encoder kernel'):
                fe.plan_encoder(1, t, d, m, h)
            continue
        for b in batches:
            p = fe.plan_encoder(b, t, d, m, h)
            rows = 16 * p.row_tiles
            assert p.windows == rows // t >= 1 and p.smem_bytes <= fe.MAX_SMEM
            assert (p.shape == 'small') == (b <= fe.SMALL_BATCH_MAX and p.cluster > 1)
            if p.shape == 'small':
                # the fewest row tiles with which all clusters run at once,
                # else the most that fit
                def blocks(plan):
                    return -(-b // plan.windows) * plan.cluster
                fewer = fe._layout('small', t, d, m, h, p.row_tiles - 1, p.cluster)
                more = fe._layout('small', t, d, m, h, p.row_tiles + 1, p.cluster)
                assert blocks(p) <= fe._SMALL_BLOCKS_AT_ONCE or p.row_tiles == 3 or not more
                assert fewer is None or blocks(fewer) > fe._SMALL_BLOCKS_AT_ONCE
            taken += 1
    assert taken > 500


def _regions(p, t, d, m, heads):
    """[(name, start, end, first phase, last phase)] of the plan's buffers,
    phases in the kernel's order: 0 x and LN1, 1 q/k/v, 2 attention, 3
    projection, 4 LN2, 5 W1, 6 W2."""
    rows = 16 * p.row_tiles
    row = rows * (d + 8)
    regions = [('resid', 0, 4 * row, 0, 6), ('y1', p.off_y, p.off_y + 2 * row, 0, 1),
               ('y2', p.off_y, p.off_y + 2 * row, 4, 5),
               ('a', p.off_a, p.off_a + 2 * row, 2, 3),
               ('qkv', p.off_q, p.off_q + 4 * rows * p.ld_q, 1, 2),
               ('u', p.off_u, p.off_u + 2 * rows * p.ld_u, 5, 6),
               ('scratch', p.off_s, p.off_s + 4 * p.scratch_floats, 0, 6),
               ('rows', p.off_v, p.off_v + 4 * (9 * d + m if p.staged == 2 else 4 * d * p.staged),
                0, 6)]
    if p.shape == 'small':
        regions.append(('barriers', p.off_b, p.off_b + 24, 0, 6))
    if p.shape == 'small':
        # the others' copies reach a and u from the phase before their own (a
        # block may run ahead to its attention while this one is in q/k/v,
        # and to its W1 while this one is in LN2)
        regions = [(n, s, e, f - (n in ('a', 'u')), l) for n, s, e, f, l in regions]
    return regions


@pytest.mark.parametrize('batch', [1, 4, 4096])
@pytest.mark.parametrize('t,d,m,heads', [(10, 256, 1024, 8), (4, 128, 512, 4),
                                         (16, 768, 3072, 8), (48, 256, 1024, 8),
                                         (10, 384, 1536, 8), (10, 128, 512, 64)])
def test_plan_encoder_buffers_overlap_only_when_not_live_together(batch, t, d, m, heads):
    p = fe.plan_encoder(batch, t, d, m, heads)
    regions = _regions(p, t, d, m, heads)
    for i, (n1, s1, e1, f1, l1) in enumerate(regions):
        assert s1 % 16 == 0 and e1 <= p.smem_bytes, n1
        for n2, s2, e2, f2, l2 in regions[i + 1:]:
            if n1[0] == n2[0] == 'y':
                continue
            if s1 < e2 and s2 < e1:                  # the bytes overlap
                assert l1 < f2 or l2 < f1, (n1, n2)


@pytest.mark.parametrize('d,heads', [(256, 8), (128, 4), (384, 8), (128, 64), (768, 12)])
def test_a_blocks_qkv_columns_are_its_heads_and_contiguous_in_fragment_order(d, heads):
    """The small shape's block of rank r computes the q/k/v column blocks
    base + (j / hb) * (d / 16) + j % hb, base = r * hb, hb = its heads' 16-column
    blocks of q: those must be exactly its heads' q, k and v columns, and each
    run of them one contiguous slice of the fragment-ordered Wqkv."""
    from inferbiomechanics_tpu_torch.ops._layout import fragment_order
    c = fe.small_cluster(d, heads)
    assert c > 1
    dh, mine = d // heads, heads // c
    hb = mine * dh // 16
    w = torch.randn(d, 3 * d, generator=torch.Generator().manual_seed(d + heads))
    packed = fragment_order(w.to(torch.bfloat16))
    per_block = d * 16                                 # elements of one column block
    for rank in range(c):
        blocks = [rank * hb + (j // hb) * (d // 16) + j % hb for j in range(3 * hb)]
        cols = [16 * nb + i for nb in blocks for i in range(16)]
        heads_cols = [part * d + h * dh + i for part in range(3)
                      for h in range(rank * mine, (rank + 1) * mine) for i in range(dh)]
        assert cols == heads_cols
        got = torch.cat([packed[nb * per_block:(nb + 1) * per_block] for nb in blocks])
        assert torch.equal(got, fragment_order(w[:, cols].to(torch.bfloat16)))
