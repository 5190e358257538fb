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
    (fe.SMALL_BATCH_MAX + 1, 10, 256, 1024, 8, ('pair', 2, 2, 3)),
    (4096, 10, 256, 1024, 8, ('pair', 2, 2, 3)),    # a 32-row tile a block of a pair
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
    batches = (1, 2, 5, 37, fe.SMALL_BATCH_MAX, fe.SMALL_BATCH_MAX + 1,
               fe.PAIR_BATCH_MIN - 1, fe.PAIR_BATCH_MIN, 4096)
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
            small = b <= fe.SMALL_BATCH_MAX and fe.small_cluster(d, h) > 1
            assert (p.shape == 'small') == small
            assert (p.shape == 'pair') == (not small and b >= fe.PAIR_BATCH_MIN
                                           and fe.fwd_pair_takes(t, d, m, h))
            if p.shape == 'pair':
                assert (p.cluster, p.row_tiles, p.windows) == (2, 2, 32 // t)
                assert p.smem_bytes == 214568 and len(p.as_ints()) == 7
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
    if p.shape == 'pair':
        # the ring and its barriers live through every phase (the producer
        # fills ahead across them); a tile's phases repeat tile after tile,
        # each tile's x landing after the last one's W2
        y = rows * (d + 8) * 2
        return [('resid', 0, rows * (d + 4) * 4, 0, 6), ('y1', p.off_y, p.off_y + y, 0, 1),
                ('y2', p.off_y, p.off_y + y, 4, 5), ('a', p.off_a, p.off_a + y, 2, 3),
                ('qkv', p.off_q, p.off_q + 4 * rows * p.ld_q, 1, 2),
                ('u', p.off_u, p.off_u + 2 * rows * p.ld_u, 5, 6),
                ('ring', p.off_ring, p.off_ring + p.slots * p.slot_bytes, 0, 6),
                ('barriers', p.off_b, p.off_b + 16 * p.slots + 8, 0, 6)] + [
                    # the next tile's x lands past the hidden once the
                    # attention is done, and is staged at that tile's start
                    (name, p.off_u + 2 * rows * p.ld_u, p.off_u + 2 * rows * p.ld_u + 4 * rows * d,
                     first, last) for name, first, last in (('x next', 3, 6), ('x', 0, 0))]
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
                                         (10, 384, 1536, 8), (10, 128, 512, 64),
                                         (16, 256, 1024, 4), (4, 256, 512, 16)])
def test_plan_encoder_buffers_overlap_only_when_not_live_together(batch, t, d, m, heads):
    p = fe.plan_encoder(batch, t, d, m, heads)
    assert (p.shape == 'pair') == (batch == 4096 and d == 256 and t <= 16)
    regions = _regions(p, t, d, m, heads)
    for i, (n1, s1, e1, f1, l1) in enumerate(regions):
        assert s1 % (128 if n1 == 'ring' else 16) == 0 and e1 <= p.smem_bytes, n1
        for n2, s2, e2, f2, l2 in regions[i + 1:]:
            if n1[0] == n2[0] and n1[0] in 'yx':
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


# ---------------------------------------------------------------------------
# The pair shape (csrc/fused_encoder.cu::fused_encoder_kernel_pair): its
# plan, its weight stream, and its work split replayed in float64
# ---------------------------------------------------------------------------

SERVED = (10, 256, 1024, 8)


def test_plan_encoder_switches_to_the_pair_shape_at_both_thresholds(monkeypatch):
    monkeypatch.setattr(fe, 'SMALL_BATCH_MAX', 40)
    monkeypatch.setattr(fe, 'PAIR_BATCH_MIN', 100)
    shapes = {b: fe.plan_encoder(b, *SERVED).shape for b in (1, 40, 41, 99, 100, 4096)}
    assert shapes == {1: 'small', 40: 'small', 41: 'large', 99: 'large', 100: 'pair',
                      4096: 'pair'}
    a = fe.plan_encoder(100, *SERVED)
    assert a is fe.plan_encoder(100, *SERVED) and a == fe.plan_encoder(4096, *SERVED)
    assert (a.cluster, a.row_tiles, a.windows, a.smem_bytes) == (2, 2, 3, 214568)
    assert a.as_ints() == (3, 33280, 50176, 148992, 214528, 32768, 2)
    assert a.tiles(4096) == 1366 and a.phases == fe.PAIR_PHASES and len(fe.PAIR_PHASES) == 8
    assert fe.encoder_blocks(a, 4096, 132) == 132                  # one block a multiprocessor
    assert fe.encoder_blocks(a, 7, 132) == 4                       # 3 tiles: 2 pairs
    assert fe.encoder_blocks(a, 100, 132) == 34                    # 34 tiles: 17 pairs
    # a pair threshold below the small one: the small shape keeps its batches
    monkeypatch.setattr(fe, 'PAIR_BATCH_MIN', 0)
    assert [fe.plan_encoder(b, *SERVED).shape for b in (40, 41)] == ['small', 'pair']
    # where the pairs of tiles need a second wave and the large tiles one (at
    # T = 10: 397-528 windows), the large shape, unless PAIR_BATCH_MIN is 0
    assert {b: fe.plan_encoder(b, *SERVED).shape for b in (396, 397, 528, 529)} == dict.fromkeys(
        (396, 397, 528, 529), 'pair')
    monkeypatch.setattr(fe, 'PAIR_BATCH_MIN', 100)
    assert {b: fe.plan_encoder(b, *SERVED).shape for b in (396, 397, 512, 528, 529, 4096)} == {
        396: 'pair', 397: 'large', 512: 'large', 528: 'large', 529: 'pair', 4096: 'pair'}
    assert [fe.plan_encoder(b, 4, 256, 1024, 16).shape for b in (1056, 1057, 1584, 1585)] == [
        'pair', 'large', 'large', 'pair']       # 8 windows a pair tile, 12 a large one
    # each shape takes every batch with its thresholds
    for shape in ('small', 'pair', 'large'):
        monkeypatch.setattr(fe, 'SMALL_BATCH_MAX', fe.thresholds(shape)[0])
        monkeypatch.setattr(fe, 'PAIR_BATCH_MIN', fe.thresholds(shape)[1])
        assert {fe.plan_encoder(b, *SERVED).shape for b in (1, 57, 4099)} == {shape}
    # shapes the pair does not take stay with the large tile at every batch
    for t, d, m, heads in ((10, 128, 512, 4), (10, 384, 1536, 8), (10, 768, 3072, 8),
                           (17, 256, 1024, 8), (10, 256, 1024, 1), (10, 256, 1024, 2),
                           (10, 256, 640, 8), (10, 256, 256, 8), (10, 256, 768, 8),
                           (10, 256, 1536, 8), (10, 256, 2048, 8)):
        assert not fe.fwd_pair_takes(t, d, m, heads)
        assert fe.plan_encoder(4096, t, d, m, heads).shape == 'large'
    for t, m, heads in ((1, 512, 16), (4, 512, 8), (16, 1024, 4), (10, 1024, 8)):
        assert fe.fwd_pair_takes(t, 256, m, heads)


@pytest.mark.parametrize('m', [512, 1024])
def test_fwd_pair_stream_brings_each_weight_fragment_once_a_tile(m):
    """The forward ring's fills for a tile: every (k-step, 16-column block)
    of the four weights exactly once, 32 KB a fill, in the order the two
    groups of consumer warps take them (alternate fills): q and k
    interleaved, v, the projection, W1 two 256-column groups at a time
    interleaved, W2; an even count, so every tile starts with group 0."""
    d = fe.PAIR_D
    fills = fe.pair_stream(m)
    kn = {'wqkv': (d, 3 * d), 'wproj': (d, d), 'wmlp1': (d, m), 'wmlp2': (m, d)}
    seen = {name: np.zeros((k // 16, n // 16), int) for name, (k, n) in kn.items()}
    for name, nk, b0, ks in fills:
        k, n = kn[name]
        assert nk == k // 16 and ks % 4 == 0 and b0 % 16 == 0
        seen[name][ks:ks + 4, b0:b0 + 16] += 1
    for name, a in seen.items():
        assert (a == 1).all(), name
    assert len(fills) * 16 * 4 * 512 == 2 * (4 * d * d + 2 * d * m)   # the bf16 weights' bytes
    assert [(f[0], f[2]) for f in fills[:8:2]] == [('wqkv', 0)] * 4       # q to group 0
    assert [(f[0], f[2]) for f in fills[1:8:2]] == [('wqkv', 16)] * 4     # k to group 1
    for i, (name, nk, b0, ks) in enumerate(fills):
        if name == 'wmlp1':                   # W1: the even column group to group 0
            assert (b0 // 16) % 2 == i % 2
    order = [(f[0], f[2]) for f in fills if f[3] == 0]
    assert order == ([('wqkv', 0), ('wqkv', 16), ('wqkv', 32), ('wproj', 0)]
                     + [('wmlp1', c) for c in range(0, m // 16, 16)] + [('wmlp2', 0)])
    assert len(fills) % 2 == 0


def test_fwd_pair_stream_offsets_pick_the_packed_fragments():
    """Where the kernel's producer copies a fill's 16 blocks from (2 KB each
    at ((b0 + i) nk + ks) x 512 bytes into the weight, the four weights end
    to end as packed) holds those blocks' 4 k-steps in fragment order."""
    from inferbiomechanics_tpu_torch.ops._layout import fragment_order
    d, m = fe.PAIR_D, 512
    params = [torch.from_numpy(p) for p in _params(6, d, m // d)]
    packed = fe.pack_encoder_params(params, 'cpu')
    w = {name: params[i].to(torch.bfloat16) for name, i in
         (('wqkv', 2), ('wproj', 4), ('wmlp1', 8), ('wmlp2', 10))}
    base = dict(wqkv=0, wproj=3 * d * d, wmlp1=4 * d * d, wmlp2=4 * d * d + d * m)
    for name, nk, b0, ks in fe.pair_stream(m):
        for i in range(16):
            off = base[name] + ((b0 + i) * nk + ks) * 256
            want = fragment_order(w[name][16 * ks:16 * ks + 64, 16 * (b0 + i):16 * (b0 + i) + 16])
            assert torch.equal(packed.weights[off:off + 1024], want.reshape(-1)), (name, b0, ks, i)


def _bf(a):
    """Round float64 values to bf16 (and back)."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).double().numpy()


def _ln64(x, scale, bias):
    mu = x.mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(((x - mu) ** 2).mean(-1, keepdims=True) + fe.LN_EPS) * scale + bias


def _gelu64(z):
    return 0.5 * z * (1 + np.tanh(0.7978845608028654 * (z + 0.044715 * z ** 3)))


def _attention64(q, k, v):
    """One (window, head): q (scaled), k, v [t, dh] -> the softmax mix."""
    s = q @ k.T
    p = np.exp(s - s.max(1, keepdims=True))
    return (p / p.sum(1, keepdims=True)) @ v


def _layer64(x, params, heads):
    """The layer in float64, nothing rounded."""
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.astype(np.float64) for p in params)
    b, t, d = x.shape
    dh = d // heads
    h = x.reshape(b * t, d).astype(np.float64)
    qkv = _ln64(h, g1, b1) @ wqkv + bqkv
    a = np.zeros_like(h)
    for w in range(b):
        r = slice(w * t, w * t + t)
        for hh in range(heads):
            c = slice(hh * dh, hh * dh + dh)
            a[r, c] = _attention64(qkv[r, c] * dh ** -0.5, qkv[r, d:][:, c], qkv[r, 2 * d:][:, c])
    h = h + (a @ wproj + bproj)
    return (h + _gelu64(_ln64(h, g2, b2) @ w1 + bm1) @ w2 + bm2).reshape(b, t, d)


def _replay_pair(x, params, heads, plan, clusters, rounded):
    """The forward's pair shape as the kernel runs it, in float64: the blocks
    of ``clusters`` clusters of two walk over pairs of tiles (block ``rank``
    of a pair the tile 2 p + rank, the last pair's second block maybe none);
    two groups of consumer warps, group g taking the fills at positions g,
    g + 2, ... of each tile's stream (:func:`fused_encoder.pair_stream`),
    each product of a group accumulated fill by fill into the 16 column
    blocks the fill names, against the k-steps of A the group counts from
    its own fills (its j-th fill of a product the groups split: product fill
    2 j + g); the attention of every window of the tile (padding windows
    too) a (window, head) at a time; the split products' sums meeting and
    the epilogues in the kernel's order of adds. ``rounded`` rounds the
    weights and what the kernel keeps as bf16 (LN outputs, the attention
    output, the MLP hidden) to bf16."""
    g1, b1, wqkv, bqkv, wproj, bproj, g2, b2, w1, bm1, w2, bm2 = (
        p.astype(np.float64) for p in params)
    b, t, d = x.shape
    m = w1.shape[1]
    n, dh, rows = b * t, d // heads, 16 * plan.row_tiles
    scale = dh ** -0.5
    rnd = _bf if rounded else (lambda a: a)
    mats = dict(wqkv=rnd(wqkv), wproj=rnd(wproj), wmlp1=rnd(w1), wmlp2=rnd(w2))
    out = np.full((n, d), np.nan)
    n_tiles = plan.tiles(b)
    pairs = -(-n_tiles // 2)
    grid = fe.encoder_blocks(plan, b, 2 * clusters)     # a card of 2 x clusters SMs
    assert grid == 2 * min(pairs, clusters)
    taken = []
    for blk in range(grid):
        cluster, rank = divmod(blk, 2)
        for pair in range(cluster, pairs, grid // 2):
            tile = 2 * pair + rank
            stream = fe.pair_stream(m)
            queues = [iter(stream[0::2]), iter(stream[1::2])]

            def product(g, A, n_fills, want, b0, split):
                acc = np.zeros((rows, 256))
                for j in range(n_fills):
                    name, nk, fb0, ks = next(queues[g])
                    assert (name, fb0) == (want, b0) and mats[name].shape[0] == 16 * nk
                    k = 64 * (2 * j + g if split else j)
                    acc += A[:, k:k + 64] @ mats[name][16 * ks:16 * ks + 64,
                                                       16 * b0:16 * b0 + 256]
                return acc

            win0 = tile * plan.windows
            valid = max(0, min(plan.windows, b - win0)) * t
            r0 = win0 * t
            if valid:
                taken.append(tile)
            X = np.zeros((rows, d))
            X[:valid] = x.reshape(n, d)[r0:r0 + valid]
            y1 = rnd(_ln64(X, g1, b1))
            Q = np.zeros((rows, 3 * d))
            Q[:, :256] = (product(0, y1, 4, 'wqkv', 0, False) + bqkv[:256]) * scale
            Q[:, 256:512] = product(1, y1, 4, 'wqkv', 16, False) + bqkv[256:512]
            v0, v1 = (product(g, y1, 2, 'wqkv', 32, True) for g in (0, 1))
            Q[:, 512:] = (v1 + v0) + bqkv[512:]
            A = y1.copy()                  # rows past the windows keep y1
            for w in range(plan.windows):
                r = slice(w * t, w * t + t)
                for h in range(heads):
                    c = slice(h * dh, h * dh + dh)
                    A[r, c] = rnd(_attention64(Q[r, c], Q[r, d:][:, c], Q[r, 2 * d:][:, c]))
            p0, p1 = (product(g, A, 2, 'wproj', 0, True) for g in (0, 1))
            H = (X + p1) + (p0 + bproj)
            y2 = rnd(_ln64(H, g2, b2))
            U = np.zeros((rows, m))
            for c0 in range(0, m, 512):
                for g in (0, 1):
                    c = c0 + 256 * g
                    U[:, c:c + 256] = rnd(_gelu64(product(g, y2, 4, 'wmlp1', c // 16, False)
                                                  + bm1[c:c + 256]))
            p0, p1 = (product(g, U, m // 128, 'wmlp2', 0, True) for g in (0, 1))
            O = ((H + p1) + p0) + bm2
            assert np.isnan(out[r0:r0 + valid]).all()      # each row stored once
            out[r0:r0 + valid] = O[:valid]
            assert all(next(q, None) is None for q in queues)   # every fill taken
    assert sorted(taken) == list(range(n_tiles))           # each tile once
    assert not np.isnan(out).any()
    return out.reshape(b, t, d)


@pytest.mark.parametrize('batch,t,heads,m,clusters', [
    (16, 10, 8, 512, 1),    # six tiles: one cluster walks three pairs
    (7, 10, 8, 1024, 2),    # three tiles: the last pair's second block idle
    (9, 4, 16, 512, 1),     # eight windows a tile, a head width of 16
    (11, 16, 4, 512, 1),    # two windows of 16 frames a tile
    (4, 7, 8, 512, 1),      # T that 32 does not divide: rows past the windows
    (13, 10, 8, 1024, 2),   # five tiles, two clusters
])
def test_pair_shape_replay_is_exact(monkeypatch, batch, t, heads, m, clusters):
    """The pair shape's work split, replayed in float64, gives the float64
    layer to rounding (1e-9); with the kernel's bf16 roundings it agrees with
    the JAX package's encoder_layer_reference in bf16 at the JAX suite's
    bf16 tolerance (tests/test_pallas_encoder.py: rtol = atol = 5e-2), and
    with the port's plain version at the port's (BF16_TOL)."""
    monkeypatch.setattr(fe, 'SMALL_BATCH_MAX', fe.thresholds('pair')[0])
    monkeypatch.setattr(fe, 'PAIR_BATCH_MIN', fe.thresholds('pair')[1])
    d = fe.PAIR_D
    plan = fe.plan_encoder(batch, t, d, m, heads)
    assert plan.shape == 'pair'
    params = _params(batch + t, d, m // d)
    x = _x(batch + 5, batch, t, d)
    want = _layer64(x, params, heads)
    got = _replay_pair(x, params, heads, plan, clusters, rounded=False)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * max(1.0, np.abs(want).max()))
    got = _replay_pair(x, params, heads, plan, clusters, rounded=True)
    jax_ref = np.asarray(jpe.encoder_layer_reference(
        jnp.asarray(x), tuple(map(jnp.asarray, params)), heads, compute_dtype=jnp.bfloat16))
    np.testing.assert_allclose(got, jax_ref, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got, _port(x, params, heads, torch.bfloat16), **BF16_TOL)


def test_tune_times_and_checks_all_three_shapes():
    from inferbiomechanics_tpu_torch.ops import tune
    args = tune.build_parser().parse_args(['--kernel', 'encoder', '--baseline', 'build/parent'])
    assert (args.kernel, args.baseline) == ('encoder', 'build/parent')
    assert tune._encoder_shapes(True) == {s: fe.thresholds(s) for s in ('small', 'pair', 'large')}
    assert tune._encoder_shapes(False) == {'kernel': None}
    assert {fe.SMALL_BATCH_MAX, fe.SMALL_BATCH_MAX + 1, fe.PAIR_BATCH_MIN - 1,
            fe.PAIR_BATCH_MIN, 65, 128, 512, 4096} <= set(tune.ENC_BATCHES)
    pair_cases = [c for c in tune.ENC_SHAPES if fe.fwd_pair_takes(*c[1:3], c[2] * c[4], c[3])]
    assert {c[1] for c in pair_cases} >= {4, 10, 16} and any(c[0] > 4096 for c in pair_cases)

