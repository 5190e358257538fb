"""The port's fused GroundLink forward
(inferbiomechanics_tpu_torch/ops/fused_groundlink.py) against the JAX
package's (inferbiomechanics_tpu/ops/pallas_groundlink.py) and the flax model.

Inputs come from numpy with a seed; weights from a flax ``Groundlink.init``
with random biases added, handed to both sides. On the CPU the port's
wrapper takes its plain version, so these tests hold that plain version
against ``Groundlink.apply``, against the JAX fused function's plain math and
against its Pallas kernel in interpret mode. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py); its packing and its row arithmetic are replayed here in
numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.models.common import slice_output_heads as jax_slice
from inferbiomechanics_tpu.models.groundlink import Groundlink as JaxGroundlink
from inferbiomechanics_tpu.ops import pallas_groundlink as jax_gl
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg

FEATURES = (16, 16, 24, 24)      # widths that are no multiple of 16
B, T, C_IN = 8, 4, 177           # window 20 / stride 5
FORMATS = ['all_frames', 'last_frame']


def _inputs(seed=0, b=B, t=T):
    return np.random.default_rng(seed).normal(size=(b, t, C_IN)).astype(np.float32)


def _jax_model(fmt, dtype, **kw):
    return JaxGroundlink(num_dofs=23, num_contact_bodies=2, root_history_len=10,
                         output_data_format=fmt, cnn_features=FEATURES,
                         compute_dtype=dtype, **kw)


def _jax_params(model, x, seed=0):
    """flax init, with the (zero) biases moved off zero so that a wrong bias
    add shows."""
    params = jax.device_get(model.init({'params': jax.random.PRNGKey(seed)},
                                       jnp.asarray(x), train=False)['params'])
    rng = np.random.default_rng(seed + 1)
    return jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.2 * rng.normal(size=p.shape)).astype(np.float32)
        if p.ndim == 1 else np.asarray(p), params)


def _torch_tree(params):
    return {name: {k: torch.from_numpy(np.asarray(v)) for k, v in node.items()}
            for name, node in params.items()}


@pytest.mark.parametrize('fmt', FORMATS)
def test_reference_f32_matches_flax_model(fmt):
    x = _inputs(1)
    model = _jax_model(fmt, jnp.float32)
    params = _jax_params(model, x)
    want = model.apply({'params': params}, jnp.asarray(x), train=False)
    out = fg.groundlink_reference(torch.from_numpy(x), _torch_tree(params), fmt,
                                  fc_depth=3, compute_dtype=torch.float32)
    assert out.shape == (B, T if fmt == 'all_frames' else 1, 30)
    got = jax_slice(jnp.asarray(out.numpy()), 2, out.shape[1])
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


@pytest.mark.parametrize('interpret', [False, True], ids=['plain', 'interpret'])
@pytest.mark.parametrize('fmt', FORMATS)
def test_reference_f32_matches_jax_fused_forward(fmt, interpret):
    """Against the JAX fused function: its plain math, and the real
    ``pallas_call`` in interpret mode with 4-row tiles."""
    x = _inputs(2)
    params = _jax_params(_jax_model(fmt, jnp.float32), x, seed=1)
    kw = dict(tile_rows=4, interpret=True) if interpret else {}
    want = np.asarray(jax_gl.fused_groundlink_forward(
        jnp.asarray(x), params, output_data_format=fmt,
        compute_dtype=jnp.float32, **kw))
    got = fg.groundlink_reference(torch.from_numpy(x), _torch_tree(params), fmt,
                                  fc_depth=3, compute_dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('fc_depth', [1, 2])
def test_reference_f32_other_depths(fc_depth):
    x = _inputs(3)
    params = _jax_params(_jax_model('all_frames', jnp.float32, fc_depth=fc_depth), x)
    assert f'Dense_{fc_depth}' not in params
    want = np.asarray(jax_gl.fused_groundlink_forward(
        jnp.asarray(x), params, fc_depth=fc_depth, compute_dtype=jnp.float32))
    got = fg.groundlink_reference(torch.from_numpy(x), _torch_tree(params),
                                  'all_frames', fc_depth, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('fmt', FORMATS)
def test_fused_forward_bf16_matches_bf16_flax_model(fmt):
    """The default bf16 compute through the wrapper (on the CPU: the plain
    version on packed weights), at the JAX suite's tolerance for its fused
    forward against the bf16 model (tests/test_pallas_groundlink.py)."""
    x = _inputs(4)
    model = _jax_model(fmt, jnp.bfloat16)
    params = _jax_params(model, x)
    want = model.apply({'params': params}, jnp.asarray(x), train=False)
    packed = fg.pack_groundlink_params(_torch_tree(params), 'cpu')
    out = fg.fused_groundlink_forward(torch.from_numpy(x), packed, fmt)
    got = jax_slice(jnp.asarray(out.numpy()), 2, out.shape[1])
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k], np.float32)
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-9) < 5e-2, k


def test_fused_forward_bf16_matches_jax_fused_forward_bf16():
    """Same arithmetic on both sides (bf16 operands, f32 sums, f32 bias and
    ELU): they differ by the order of the f32 sums and the bf16 roundings
    that flips, 1e-2 on outputs of a few units."""
    x = _inputs(5)
    params = _jax_params(_jax_model('all_frames', jnp.bfloat16), x)
    want = np.asarray(jax_gl.fused_groundlink_forward(jnp.asarray(x), params))
    packed = fg.pack_groundlink_params(_torch_tree(params), 'cpu')
    got = fg.fused_groundlink_forward(torch.from_numpy(x), packed).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def test_fused_forward_on_cpu_takes_plain_version():
    x = torch.from_numpy(_inputs(6))
    tree = _torch_tree(_jax_params(_jax_model('last_frame', jnp.float32), x.numpy()))
    packed = fg.pack_groundlink_params(tree, 'cpu')
    before = fg.launches
    out = fg.fused_groundlink_forward(x, packed, 'last_frame')
    assert fg.launches == before          # no kernel on the CPU
    assert torch.equal(out, fg.groundlink_reference(x, tree, 'last_frame', 3))


def test_fused_forward_rejects_other_devices():
    tree = _torch_tree(_jax_params(_jax_model('all_frames', jnp.float32), _inputs()))
    packed = fg.pack_groundlink_params(tree, 'cpu')
    with pytest.raises(ValueError, match='no kernel for device meta'):
        fg.fused_groundlink_forward(torch.empty(2, T, C_IN, device='meta'), packed)


def test_kernel_shape_limits_raise():
    full = (192, 128, 128, 256, 256, 256, 256, 32)
    fg.check_kernel_shape(10, full, 4, 3, 7)           # the default model
    fg.check_kernel_shape(4, (192, 64, 64, 64, 64, 64, 64, 32), 4, 3, 7)
    for args, match in (((65, full, 4, 3, 7), 'frames'),
                        ((10, full, 4, 3, 4), 'odd kernel'),
                        ((10, (192,) + (64,) * 12 + (32,), 10, 3, 7), 'layers'),
                        ((10, (192, 576, 32), 1, 1, 7), 'widths up to')):
        with pytest.raises(ValueError, match=match):
            fg.check_kernel_shape(*args)


def test_malformed_trees_raise():
    tree = _torch_tree(_jax_params(_jax_model('all_frames', jnp.float32), _inputs()))
    with pytest.raises(ValueError, match='GroundLink tree'):
        fg.pack_groundlink_params({'W0': tree['Conv_0']}, 'cpu')
    with pytest.raises(ValueError, match='has a bias'):
        fg.pack_groundlink_params(
            dict(tree, Dense_2=dict(tree['Dense_2'], bias=torch.zeros(30))), 'cpu')
    with pytest.raises(ValueError, match='after width'):
        fg.pack_groundlink_params(dict(tree, Conv_1=tree['Conv_0']), 'cpu')
    with pytest.raises(ValueError, match='fc_depth 2'):
        fg.groundlink_reference(torch.zeros(1, T, C_IN), tree, fc_depth=2)


def _unpack_layers(packed):
    """Padded ``[taps * K, N]`` weights and padded biases back out of the
    packed buffers (the inverse of ``_layout.fragment_order``, which
    tests/test_torch_fused_mlp.py holds to the PTX definition)."""
    flat = packed.weights.float().numpy()
    n_layers = packed.n_conv + packed.fc_depth
    out, off_w, off_b = [], 0, 0
    for l in range(n_layers):
        taps = packed.taps if l < packed.n_conv else 1
        pk, pn = taps * packed.pwidths[l], packed.pwidths[l + 1]
        frag = flat[off_w:off_w + pk * pn].reshape(pn // 16, pk // 16, 8, 4, 2, 2, 2)
        w = frag.transpose(1, 5, 3, 6, 0, 4, 2).reshape(pk, pn)   # ks h c e nb j g
        off_w += pk * pn
        bias = None
        if l < n_layers - 1:
            bias = packed.biases[off_b:off_b + pn].numpy()
            off_b += pn
        out.append((w, bias))
    assert off_w == packed.weights.numel() and off_b == packed.biases.numel()
    return out


def test_pack_groundlink_params_layout():
    tree = _torch_tree(_jax_params(_jax_model('all_frames', jnp.float32), _inputs()))
    packed = fg.pack_groundlink_params(tree, 'cpu')
    assert packed.widths == (177, 16, 16, 24, 24, 24, 24, 30)
    assert packed.pwidths == (192, 64, 64, 64, 64, 64, 64, 32)
    assert (packed.n_conv, packed.fc_depth, packed.taps) == (4, 3, 7)
    assert packed.weights.dtype == torch.bfloat16 and packed.biases.dtype == torch.float32
    names = [f'Conv_{i}' for i in range(4)] + [f'Dense_{j}' for j in range(3)]
    for l, (name, (w, bias)) in enumerate(zip(names, _unpack_layers(packed))):
        kernel = tree[name]['kernel'].bfloat16()
        assert torch.equal(packed.params[name]['kernel'], kernel)
        taps = 7 if l < 4 else 1
        k, n, pk = packed.widths[l], packed.widths[l + 1], packed.pwidths[l]
        w = w.reshape(taps, pk, -1)             # a conv's rows are tap-major
        np.testing.assert_array_equal(w[:, :k, :n],
                                      kernel.float().numpy().reshape(taps, k, n))
        assert not w[:, k:].any() and not w[:, :, n:].any()    # zero padding
        if bias is None:
            assert name == 'Dense_2' and 'bias' not in packed.params[name]
        else:
            np.testing.assert_array_equal(bias[:n], tree[name]['bias'].numpy())
            assert not bias[n:].any()


def _replay_kernel(x, packed, fmt, row_tiles):
    """The kernel's data movement in numpy float64 on bf16-rounded operands:
    the tile plan, the zero-filled load, each conv as one product over
    ``taps * C_in_padded`` with the clamped source rows (padding rows read
    row 0), the last-frame gather and the masked store. Follows
    csrc/fused_groundlink.cu step by step."""
    bf16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()  # noqa: E731
    elu = lambda z: np.where(z > 0, z, np.exp(np.minimum(z, 0)) - 1)   # noqa: E731
    layers = _unpack_layers(packed)
    batch, t, c_in = x.shape
    last_frame = fmt != 'all_frames'
    rows, windows = 16 * row_tiles, 16 * row_tiles // t
    out = np.full((batch, 1 if last_frame else t, packed.widths[-1]), np.nan)
    for win0 in range(0, batch, windows):
        n_win = min(windows, batch - win0)
        h = np.zeros((rows, packed.pwidths[0]))
        h[:n_win * t, :c_in] = bf16(x[win0:win0 + n_win].reshape(n_win * t, c_in))
        cur_rows = rows
        for l, (w, bias) in enumerate(layers):
            conv = l < packed.n_conv
            taps = packed.taps if conv else 1
            r = np.arange(cur_rows)
            if conv:
                r = np.where(r >= windows * t, 0, r)
                src = [(r // t) * t + np.clip(r % t + j - taps // 2, 0, t - 1)
                       for j in range(taps)]
            elif l == packed.n_conv and last_frame:
                cur_rows = 16 * ((windows + 15) // 16)
                r = np.arange(cur_rows)
                src = [np.where(r < windows, r, 0) * t + t - 1]
            else:
                src = [r]
            a = np.concatenate([h[s] for s in src], axis=1)     # [rows, taps * K]
            z = a @ w.astype(np.float64)
            h = z if bias is None else bf16(elu(z + bias))
        valid = n_win if last_frame else n_win * t
        out[win0:win0 + n_win] = h[:valid, :packed.widths[-1]].reshape(
            n_win, -1, packed.widths[-1])
    return out


@pytest.mark.parametrize('fmt', FORMATS)
@pytest.mark.parametrize('batch,t,row_tiles', [(8, 4, 2), (37, 4, 4), (7, 10, 4), (1, 10, 1)])
def test_zero_padding_and_row_gather_are_exact(fmt, batch, t, row_tiles):
    """The padded, tiled chain the kernel runs gives the unpadded chain's
    outputs: padded channels meet zero weight rows and stay elu(0) = 0,
    padding rows and windows past the batch never reach the output, and the
    clamped rows are the replicate padding. Float64 keeps every sum exact
    enough (1e-9) on bf16-rounded operands."""
    x = _inputs(7, batch, t)
    tree = _torch_tree(_jax_params(_jax_model(fmt, jnp.float32), x[:2]))
    packed = fg.pack_groundlink_params(tree, 'cpu')
    got = _replay_kernel(x, packed, fmt, row_tiles)

    def chain(h):        # the plain version in float64
        frames = np.arange(t)
        rnd = lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()  # noqa: E731
        elu = lambda z: np.where(z > 0, z, np.exp(np.minimum(z, 0)) - 1)   # noqa: E731
        h = rnd(h)
        for i in range(4):
            k = packed.params[f'Conv_{i}']['kernel'].double().numpy()
            acc = sum(h[:, np.clip(frames + j - 3, 0, t - 1)] @ k[j] for j in range(7))
            h = rnd(elu(acc + packed.params[f'Conv_{i}']['bias'].double().numpy()))
        if fmt != 'all_frames':
            h = h[:, -1:]
        for j in range(2):
            p = packed.params[f'Dense_{j}']
            h = rnd(elu(h @ p['kernel'].double().numpy() + p['bias'].double().numpy()))
        return h @ packed.params['Dense_2']['kernel'].double().numpy()

    want = chain(x)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
