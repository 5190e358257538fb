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


@pytest.mark.parametrize('b,t,heads', [(3, 10, 4), (19, 10, 4), (5, 4, 4), (2, 10, 8)])
def test_plain_backward_matches_jax_vjp_f32(b, t, heads):
    params = _params(b)
    x, g = _xg(b + 1, b, t)
    got = _port(x, g, params, heads, torch.float32)
    want = _want(x, g, params, heads, 'f32')
    for name, a, w in zip(NAMES, got, want):
        assert a.shape == w.shape and a.dtype == np.float32, name
        np.testing.assert_allclose(a, w, err_msg=f'd{name}', **F32_TOL)


@pytest.mark.parametrize('b,t', [(19, 10), (5, 4)])
def test_plain_backward_matches_jax_vjp_bf16(b, t):
    params = _params(b + 10)
    x, g = _xg(b + 11, b, t)
    got = _port(x, g, params, H, torch.bfloat16)
    want = _want(x, g, params, H, 'bf16')
    for name, a, w in zip(NAMES, got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, w, rtol=0, atol=BF16_REL * np.abs(w).max(),
                                   err_msg=f'd{name}')


@pytest.mark.parametrize('dtype_name,torch_dtype', [('f32', torch.float32),
                                                    ('bf16', torch.bfloat16)])
def test_plain_backward_matches_the_pallas_kernel_in_interpret_mode(dtype_name, torch_dtype):
    """b=19 with 8-row tiles: two full tiles and a padded one, gradients
    summed across tiles."""
    params = _params(4)
    x, g = _xg(5, 19)
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
    fwd, bwd = fe.launches, fe.bwd_launches
    out = fe.FusedEncoderLayerFn.apply(xt, packed, H, *params)
    got = torch.autograd.grad(out, [xt] + params, torch.from_numpy(g))
    assert (fe.launches, fe.bwd_launches) == (fwd, bwd)     # no kernel on the CPU
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
    assert [fe.bwd_splits(n) for n in (10, 190, 511, 512, 1024, 40960, 10 ** 6)] == [
        1, 1, 1, 1, 2, 8, 8]
