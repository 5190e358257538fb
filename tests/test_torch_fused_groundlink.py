"""The port's fused GroundLink forward
(inferbiomechanics_tpu_torch/ops/fused_groundlink.py) against the JAX
package's (inferbiomechanics_tpu/ops/pallas_groundlink.py) and the flax model.

Inputs come from numpy with a seed; weights from a flax ``Groundlink.init``
with random biases added, handed to both sides. On the CPU the port's
wrapper takes its plain version, so these tests hold that plain version
against ``Groundlink.apply``, against the JAX fused function's plain math and
against its Pallas kernel in interpret mode. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_cuda_kernels.py,
chip_smoke.py); its packing, its plan (``plan_groundlink``: shapes, frames,
column ownership, shared memory) and its data movement are replayed here in
numpy.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.models.common import slice_output_heads as jax_slice
from inferbiomechanics_tpu.models.groundlink import Groundlink as JaxGroundlink
from inferbiomechanics_tpu.ops import pallas_groundlink as jax_gl
from inferbiomechanics_tpu_torch.ops import fused_groundlink as fg
from inferbiomechanics_tpu_torch.ops import tune

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
    before, shapes = fg.launches, dict(fg.shape_launches)
    out = fg.fused_groundlink_forward(x, packed, 'last_frame')
    assert fg.launches == before          # no kernel on the CPU
    assert fg.shape_launches == shapes
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


def _bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16().double().numpy()


def _elu64(z):
    return np.where(z > 0, z, np.exp(np.minimum(z, 0)) - 1)


def _replay_kernel(x, packed, fmt, plan):
    """The kernel's data movement in numpy float64 on bf16-rounded operands,
    following csrc/fused_groundlink.cu step by step for ``plan``: tiles of
    ``plan.windows`` windows; x staged as the last ``keep_in`` frames of each
    window, zero-filled past the batch; each layer's rows (window, its last
    ``keep`` frames), padded to 16, each conv one product over ``taps *
    C_in_padded`` with the clamped source rows (padding rows read row 0), which
    must lie within the frames the layer before kept; each block of the
    cluster computing only the columns it owns, its k-steps split into parts
    summed in order, and handing them to the others (every column written
    exactly once); the masked store of the head."""
    layers = _unpack_layers(packed)
    batch, t, c_in = x.shape
    n_conv, n_layers = packed.n_conv, len(layers)
    c_out = packed.widths[-1]
    out = np.full((batch, plan.keep[-1], c_out), np.nan)
    for win0 in range(0, batch, plan.windows):
        n_win = min(plan.windows, batch - win0)
        h = np.zeros((plan.rows_x, packed.pwidths[0]))
        for w in range(n_win):
            h[w * plan.keep_in:(w + 1) * plan.keep_in, :c_in] = \
                _bf16(x[win0 + w, t - plan.keep_in:])
        keep_in = plan.keep_in
        for l, (wl, bias) in enumerate(layers):
            conv = l < n_conv
            taps = packed.taps if conv else 1
            keep, rows = plan.keep[l], plan.rows[l]
            r = np.arange(rows)
            if conv:
                r = np.where(r >= plan.windows * keep, 0, r)
                frame = t - keep + r % keep
                src = [(r // keep) * keep_in + np.clip(frame + j - taps // 2, 0, t - 1)
                       - (t - keep_in) for j in range(taps)]
                for s_ in src:     # the same window, a frame the layer before kept
                    w = r // keep
                    assert ((s_ >= w * keep_in) & (s_ < (w + 1) * keep_in)).all()
            else:
                assert keep == keep_in
                src = [r]
            a = np.concatenate([h[s_] for s_ in src], axis=1)     # [rows, taps * K]
            ncb, nk = packed.pwidths[l + 1] // 16, a.shape[1] // 16
            new = np.full((rows, packed.pwidths[l + 1]), np.nan)
            for rank in range(plan.cluster):
                cb0, n_own = fg.owned_blocks(ncb, plan.cluster, rank)
                cols = slice(16 * cb0, 16 * (cb0 + n_own))
                split = fg.layer_split(n_own, nk) if plan.shape == 'small' else 1
                z = np.zeros((rows, 16 * n_own))
                for part in range(split):     # whole chunks of 4 k-steps
                    k0, k1 = (64 * (part * (nk // 4) // split),
                              64 * ((part + 1) * (nk // 4) // split))
                    z = z + a[:, k0:k1] @ wl[k0:k1, cols].astype(np.float64)
                assert np.isnan(new[:, cols]).all()          # no column twice
                new[:, cols] = z if bias is None else _bf16(_elu64(z + bias[cols]))
            assert not np.isnan(new).any()                   # every column once
            h, keep_in = new, keep
        valid = n_win * plan.keep[-1]
        out[win0:win0 + n_win] = h[:valid, :c_out].reshape(n_win, -1, c_out)
    return out


def _chain64(x, packed, fmt):
    """The plain version in float64 on bf16-rounded operands."""
    t = x.shape[1]
    frames = np.arange(t)
    h = _bf16(x)
    for i in range(packed.n_conv):
        k = packed.params[f'Conv_{i}']['kernel'].double().numpy()
        half = k.shape[0] // 2
        acc = sum(h[:, np.clip(frames + j - half, 0, t - 1)] @ k[j] for j in range(k.shape[0]))
        h = _bf16(_elu64(acc + packed.params[f'Conv_{i}']['bias'].double().numpy()))
    if fmt != 'all_frames':
        h = h[:, -1:]
    for j in range(packed.fc_depth - 1):
        p = packed.params[f'Dense_{j}']
        h = _bf16(_elu64(h @ p['kernel'].double().numpy() + p['bias'].double().numpy()))
    return h @ packed.params[f'Dense_{packed.fc_depth - 1}']['kernel'].double().numpy()


def _random_tree(seed, c_in, features, fc_depth, taps=7):
    gen = torch.Generator().manual_seed(seed)
    return tune.random_groundlink_params(gen, c_in, features, fc_depth, taps)


@pytest.fixture
def threshold(monkeypatch):
    """Move the plan's thresholds: ``threshold(shape, large_windows)`` makes
    ``shape`` take every batch."""
    def move(shape, large_windows=None):
        monkeypatch.setattr(fg, 'SMALL_BATCH_MAX', 1 << 30 if shape == 'small' else 0)
        if large_windows is not None:
            monkeypatch.setattr(fg, 'LARGE_WINDOWS', large_windows)
            monkeypatch.setattr(fg, 'LARGE_WINDOWS_ALL_FRAMES', large_windows)
            monkeypatch.setattr(fg, 'LARGE_BLOCKS', 1)
    return move


@pytest.mark.parametrize('fmt', FORMATS)
@pytest.mark.parametrize('shape', ['small', 'large'])
@pytest.mark.parametrize('batch,t', [(8, 4), (37, 4), (7, 10), (1, 10), (30, 10)])
def test_zero_padding_and_row_gather_are_exact(threshold, fmt, shape, batch, t):
    """The padded, tiled, trimmed and column-split chain the kernel runs gives
    the unpadded chain's outputs: padded channels meet zero weight rows and
    stay elu(0) = 0, padding rows and windows past the batch never reach the
    output, the clamped rows are the replicate padding, the frames a trimmed
    conv leaves out never reach the head, and the cluster's blocks together
    write every column once. Float64 keeps every sum exact enough (1e-9) on
    bf16-rounded operands."""
    threshold(shape, large_windows=3)
    x = _inputs(7, batch, t)
    tree = _torch_tree(_jax_params(_jax_model(fmt, jnp.float32), x[:2]))
    packed = fg.pack_groundlink_params(tree, 'cpu')
    plan = fg.plan_groundlink(batch, t, packed.pwidths, packed.n_conv, packed.fc_depth,
                              packed.taps, fmt != 'all_frames')
    assert plan.shape == shape
    got = _replay_kernel(x, packed, fmt, plan)
    want = _chain64(x, packed, fmt)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize('fmt', FORMATS)
@pytest.mark.parametrize('shape,batch,t,features,fc_depth,taps', [
    ('small', 1, 10, (128, 128, 256, 256), 3, 7),     # the served model, one window
    ('small', 20, 10, (128, 128, 256, 256), 3, 7),    # two windows a cluster tile
    ('large', 21, 10, (128, 128, 256, 256), 3, 7),    # 16 windows a tile and a ragged one
    ('small', 3, 17, (64, 192), 2, 3),                # cluster of 4, three column blocks
    ('large', 5, 64, (64,), 1, 7),                    # the longest window, one conv
])
def test_full_width_replay_is_exact(threshold, fmt, shape, batch, t, features, fc_depth,
                                    taps):
    """The same replay at the served widths (a cluster of 8, the 32-wide head
    on two blocks, split k-steps) and at other odd shapes."""
    threshold(shape)
    x = _inputs(8, batch, t)
    packed = fg.pack_groundlink_params(_random_tree(batch, C_IN, features, fc_depth, taps),
                                       'cpu')
    plan = fg.plan_groundlink(batch, t, packed.pwidths, packed.n_conv, fc_depth, taps,
                              fmt != 'all_frames')
    assert plan.shape == shape
    got = _replay_kernel(x, packed, fmt, plan)
    want = _chain64(x, packed, fmt)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * max(1.0, np.abs(want).max()))


FULL_PW = (192, 128, 128, 256, 256, 256, 256, 32)


def test_layer_frames_formula():
    assert fg.layer_frames(10, 4, 7, True) == (10, (10, 7, 4, 1))
    assert fg.layer_frames(10, 4, 7, False) == (10, (10,) * 4)
    assert fg.layer_frames(64, 4, 7, True) == (13, (10, 7, 4, 1))
    assert fg.layer_frames(5, 2, 1, True) == (1, (1, 1))
    assert fg.layer_frames(1, 3, 7, True) == (1, (1, 1, 1))


@pytest.mark.parametrize('t,n_conv,taps', [(10, 4, 7), (64, 4, 7), (7, 2, 3), (33, 9, 5),
                                           (4, 1, 7), (1, 3, 1)])
def test_layer_frames_are_what_the_last_frame_reads(t, n_conv, taps):
    """Walk the convs back from frame T-1: the frames each layer's output must
    hold are exactly the last ``keep`` of the window."""
    keep_in, keep = fg.layer_frames(t, n_conv, taps, True)
    need, half = {t - 1}, taps // 2
    for l in range(n_conv - 1, -1, -1):
        assert need == set(range(t - keep[l], t)), l
        need = {min(max(f + j - half, 0), t - 1) for f in need for j in range(taps)}
    assert need == set(range(t - keep_in, t))


def test_plan_groundlink_served_model(monkeypatch):
    monkeypatch.setattr(fg, 'SMALL_BATCH_MAX', 56)
    monkeypatch.setattr(fg, 'LARGE_WINDOWS', 16)
    monkeypatch.setattr(fg, 'LARGE_BLOCKS', 132)
    one = fg.plan_groundlink(1, 10, FULL_PW, 4, 3, 7, True)
    assert (one.shape, one.cluster, one.windows, one.row_tiles) == ('small', 8, 1, 1)
    assert one.keep == (10, 7, 4, 1, 1, 1, 1) and one.keep_in == 10
    assert one.rows == (16,) * 7 and one.blocks(1) == 8
    edge = fg.plan_groundlink(56, 10, FULL_PW, 4, 3, 7, True)
    assert (edge.shape, edge.windows, edge.row_tiles, edge.blocks(56)) == ('small', 4, 4, 112)
    past = fg.plan_groundlink(57, 10, FULL_PW, 4, 3, 7, True)
    assert past.shape == 'large' and past.windows == 1
    big = fg.plan_groundlink(4096, 10, FULL_PW, 4, 3, 7, True)
    assert (big.shape, big.windows, big.blocks(4096)) == ('large', 16, 256)
    assert big.rows == (160, 112, 64, 16, 16, 16, 16) and big.rows_x == 160
    assert fg.plan_groundlink(4096, 10, FULL_PW, 4, 3, 7, False).keep == (10,) * 7
    assert fg.plan_groundlink(512, 10, FULL_PW, 4, 3, 7, True).windows == 4
    ints = one.as_ints()
    assert len(ints) == fg._PLAN_INTS and ints[:6] == (1, 8, 1, 1, 16, 10)
    assert ints[11:] == (10, 7, 4, 1, 1, 1, 1, 0, 0, 0, 0, 0)
    assert (past.depth, big.depth, big.row_tiles) == (16, 8, 4)   # one block an SM, two
    monkeypatch.setattr(fg, 'LARGE_WINDOWS_ALL_FRAMES', 6)
    wide = fg.plan_groundlink(4096, 10, FULL_PW, 4, 3, 7, False)
    assert (wide.windows, wide.depth, wide.rows) == (6, 8, (64,) * 7)
    monkeypatch.setattr(fg, 'LARGE_WINDOWS_ALL_FRAMES', 16)
    wide = fg.plan_groundlink(4096, 10, FULL_PW, 4, 3, 7, False)    # no room for two
    assert (wide.windows, wide.depth, wide.smem_bytes > fg._TWO_BLOCKS_SMEM) == (16, 16, True)
    assert len(fg.phase_names(4, 3)) == 15 and fg.phase_names(4, 3)[-2] == 'head product'


def _check_plan(plan, batch, t, pwidths, n_conv, taps, last_frame):
    n_layers = len(pwidths) - 1
    keep_in, keep = fg.layer_frames(t, n_conv, taps, last_frame)
    assert plan.keep_in == keep_in
    assert plan.keep == keep + (keep[-1],) * (n_layers - n_conv)
    assert plan.rows_x == -(-plan.windows * keep_in // 16) * 16
    assert plan.rows == tuple(-(-plan.windows * k // 16) * 16 for k in plan.keep)
    assert plan.smem_bytes <= fg.MAX_SMEM and plan.windows >= 1
    # buffers: x and odd layers in P, even layers in Q, then the scratch
    assert plan.rows_x * pwidths[0] * 2 <= plan.off_q
    for l in range(n_layers - 1):
        size = plan.rows[l] * pwidths[l + 1] * 2
        assert (plan.off_q + size <= plan.off_v) if l % 2 == 0 else size <= plan.off_q
    assert plan.off_v + 4 * sum(pwidths[1:-1]) <= plan.off_s    # the biases but the head's
    assert plan.off_q % 16 == 0 and plan.off_v % 16 == 0 and plan.off_s % 16 == 0
    if plan.shape == 'large':
        assert plan.cluster == 1 and plan.smem_bytes == plan.off_s
        one = plan.blocks(batch) <= fg._SMS or plan.smem_bytes > fg._TWO_BLOCKS_SMEM
        assert plan.depth == (16 if one else 8)
        assert plan.row_tiles == 4
        return
    assert plan.cluster == fg.small_cluster(pwidths) and plan.row_tiles in (1, 4)
    assert plan.depth == 16
    assert max(plan.rows) <= 16 * plan.row_tiles
    assert plan.off_b == plan.off_s + 4 * plan.scratch_floats
    assert plan.smem_bytes == plan.off_b + 8 * (n_layers - 1)
    # all clusters at once, unless the tile already holds all the windows 64 rows can
    assert (plan.blocks(batch) <= fg._SMALL_BLOCKS_AT_ONCE
            or plan.windows == max(1, 64 // t))
    for l in range(n_layers):
        ncb = pwidths[l + 1] // 16
        nk = (taps if l < n_conv else 1) * pwidths[l] // 16
        owners = np.zeros(ncb, int)
        sent = []
        for rank in range(plan.cluster):
            cb0, n_own = fg.owned_blocks(ncb, plan.cluster, rank)
            owners[cb0:cb0 + n_own] += 1
            # a block's columns are one run of [column block][row][16]
            sent.append((cb0 * plan.rows[l] * 32, n_own * plan.rows[l] * 32))
            split = fg.layer_split(n_own, nk)
            assert split * n_own <= fg._WARPS or n_own > fg._WARPS
            if split > 1:
                assert split * n_own * plan.rows[l] * 16 <= plan.scratch_floats
        assert (owners == 1).all(), (l, owners)      # every column, the head's too, once
        assert sum(n for _, n in sent) == ncb * plan.rows[l] * 32
        assert all(a + n == b for (a, n), (b, _) in zip(sent, sent[1:]))


@pytest.mark.parametrize('fmt', FORMATS)
@pytest.mark.parametrize('taps', [1, 3, 7])
def test_plan_groundlink_covers_every_accepted_shape(taps, fmt):
    """Every shape check_kernel_shape accepts gets a plan at batches 1, the
    threshold, one past it and 4096, that fits shared memory, keeps the
    frames of layer_frames, and splits every layer's columns once."""
    last_frame = fmt != 'all_frames'
    n = 0
    for t in (1, 2, 4, 7, 10, 16, 33, 64):
        for n_conv, fc_depth in ((1, 1), (2, 2), (4, 3), (9, 3), (1, 11)):
            for widths in ((64,), (128, 256), (512,), (64, 512, 128)):
                hidden = [widths[i % len(widths)] for i in range(n_conv)]
                pwidths = (192, *hidden, *(hidden[-1],) * (fc_depth - 1), 32)
                fg.check_kernel_shape(t, pwidths, n_conv, fc_depth, taps)
                for batch in (1, fg.SMALL_BATCH_MAX, fg.SMALL_BATCH_MAX + 1, 4096):
                    plan = fg.plan_groundlink(batch, t, pwidths, n_conv, fc_depth, taps,
                                              last_frame)
                    assert plan.shape == ('small' if batch <= fg.SMALL_BATCH_MAX else 'large')
                    _check_plan(plan, batch, t, pwidths, n_conv, taps, last_frame)
                    n += 1
    assert n == 8 * 5 * 4 * 4


def test_swizzle_spreads_ldmatrix_rows_over_the_banks():
    """[column block][row][16] bf16 with the halves of a 32-byte row swapped
    on every other group of four rows: each 8-row phase of ldmatrix (8 rows,
    one 16-byte half each) reads 32 distinct banks, and a row's two halves
    are its own."""
    def swz(row, half):         # element offset, as csrc/fused_groundlink.cu
        return row * 16 + ((half ^ ((row >> 2) & 1)) << 3)
    for r0 in range(0, 64, 8):
        for half in (0, 1):
            banks = {(2 * swz(r, half) // 4 + i) % 32 for r in range(r0, r0 + 8)
                     for i in range(4)}
            assert len(banks) == 32
    assert sorted(swz(r, h) for r in range(16) for h in (0, 1)) == list(range(0, 256, 8))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_k4_bound_counts_the_frames_last_frame_needs():
    """chip_smoke.py's bound for last_frame counts each conv on the frames
    layer_frames keeps (the least work that computes it), all_frames on every
    frame."""
    cs = _chip_smoke()
    full = cs.GL_FULL
    last_ms, by = cs.k4_bound(4096, 'last_frame', **full)
    all_ms, _ = cs.k4_bound(4096, 'all_frames', **full)
    keep_in, keep = fg.layer_frames(full['t'], 4, full['taps'], True)
    widths = [full['c_in'], *full['features']]
    conv = sum(k * full['taps'] * a * b for k, a, b in zip(keep, widths[:-1], widths[1:]))
    head = (full['fc_depth'] - 1) * 256 * 256 + 256 * full['c_out']
    assert by == 'operations'
    assert last_ms == pytest.approx(2.0 * 4096 * (conv + head) / cs.PEAK_BF16_FLOPS * 1e3)
    assert 32.0e-3 < last_ms < 32.6e-3 and 91.0e-3 < all_ms < 91.3e-3


def test_tune_parses_the_groundlink_command():
    args = tune.build_parser().parse_args(['--kernel', 'groundlink', '--baseline', 'b', '--quick'])
    assert (args.kernel, args.baseline, args.quick) == ('groundlink', 'b', True)
    assert tune.build_parser().parse_args([]).kernel == 'mlp'
    with pytest.raises(SystemExit):
        tune.build_parser().parse_args(['--kernel', 'nope'])
    if not torch.cuda.is_available():
        assert tune.main(['--kernel', 'groundlink', '--quick']) == 1
