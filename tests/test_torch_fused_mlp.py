"""The port's fused MLP (inferbiomechanics_tpu_torch/ops/fused_mlp.py)
against the JAX package's (inferbiomechanics_tpu/ops/pallas_mlp.py).

Inputs and weights come from numpy with a seed and go to both sides. On the
CPU the port's wrapper takes its plain version, so these tests hold that
plain version against the JAX reference and against the Pallas kernel run
in interpret mode. The CUDA kernel itself is held against the plain version
on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.ops import pallas_mlp as jax_mlp
from inferbiomechanics_tpu_torch.ops import _build
from inferbiomechanics_tpu_torch.ops import _layout as layout
from inferbiomechanics_tpu_torch.ops import fused_mlp as fm

ACTS = ['relu', 'tanh', 'sigmoid', 'gelu', 'elu']
# one bf16 ulp at the outputs' magnitude (< 2): the two sides sum the f32
# products in another order, which can flip the last bf16 rounding
ATOL_REF = 1e-2
# the Pallas kernel's own test tolerance (tests/test_pallas_mlp.py:78)
ATOL_PALLAS = 2e-2
RAGGED_DIMS = [177 * 4, 64, 48, 30]   # c_in 708: not a multiple of 16 or 128


def _numpy_params(dims, seed):
    rng = np.random.default_rng(seed)
    return [((rng.uniform(-1, 1, (d0, d1)) / np.sqrt(d0)).astype(np.float32),
             (rng.uniform(-1, 1, (d1,)) / np.sqrt(d0)).astype(np.float32))
            for d0, d1 in zip(dims[:-1], dims[1:])]


def _inputs(b, c, seed):
    return np.random.default_rng(seed).normal(size=(b, c)).astype(np.float32)


def _torch_params(params):
    return [(torch.from_numpy(W), torch.from_numpy(b)) for W, b in params]


def _pallas_interpret(x, params, activation):
    """JAX ``_fused_kernel`` through ``pl.pallas_call(interpret=True)``,
    padded as ``pallas_mlp.fused_mlp_forward`` pads (pallas_mlp.py:88-128)."""
    import jax.experimental.pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    r = lambda d: (d + 127) // 128 * 128   # noqa: E731
    n = len(params)
    b = x.shape[0]
    dims = [x.shape[1]] + [W.shape[1] for W, _ in params]
    pd = [r(d) for d in dims]
    bp = r(b)
    xp = jnp.zeros((bp, pd[0]), jnp.bfloat16).at[:b, :dims[0]].set(
        jnp.asarray(x).astype(jnp.bfloat16))
    Ws = [jnp.zeros((pd[i], pd[i + 1]), jnp.bfloat16).at[:W.shape[0], :W.shape[1]]
          .set(jnp.asarray(W).astype(jnp.bfloat16)) for i, (W, _) in enumerate(params)]
    bs = [jnp.zeros((1, pd[i + 1]), jnp.float32).at[0, :bias.shape[0]]
          .set(jnp.asarray(bias)) for i, (_, bias) in enumerate(params)]
    spec = lambda shape: pl.BlockSpec(shape, lambda i: (0, 0),   # noqa: E731
                                      memory_space=pltpu.VMEM)
    out = pl.pallas_call(
        functools.partial(jax_mlp._fused_kernel, activation, n),
        grid=(1,),
        in_specs=[spec((bp, pd[0]))]
        + [spec((pd[i], pd[i + 1])) for i in range(n)]
        + [spec((1, pd[i + 1])) for i in range(n)],
        out_specs=spec((bp, pd[-1])),
        out_shape=jax.ShapeDtypeStruct((bp, pd[-1]), jnp.float32),
        interpret=True,
    )(xp, *Ws, *bs)
    return np.asarray(out)[:b, :dims[-1]]


@pytest.mark.parametrize('activation', ACTS)
def test_mlp_reference_matches_jax_reference(activation):
    params = _numpy_params(RAGGED_DIMS, seed=0)
    x = _inputs(16, RAGGED_DIMS[0], seed=1)
    want = np.asarray(jax_mlp.mlp_reference(
        jnp.asarray(x), [(jnp.asarray(W), jnp.asarray(b)) for W, b in params],
        activation))
    got = fm.mlp_reference(torch.from_numpy(x), _torch_params(params),
                           activation).numpy()
    assert got.shape == want.shape == (16, RAGGED_DIMS[-1])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_REF)


@pytest.mark.parametrize('activation', ACTS)
def test_fused_mlp_forward_matches_pallas_kernel_interpret(activation):
    params = _numpy_params(RAGGED_DIMS, seed=2)
    x = _inputs(24, RAGGED_DIMS[0], seed=3)
    want = _pallas_interpret(x, params, activation)
    packed = fm.pack_mlp_params(_torch_params(params), 'cpu')
    got = fm.fused_mlp_forward(torch.from_numpy(x), packed, activation).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_PALLAS)


def test_fused_mlp_forward_on_cpu_takes_plain_version():
    params = _torch_params(_numpy_params([64, 32, 30], seed=4))
    packed = fm.pack_mlp_params(params, 'cpu')
    x = torch.from_numpy(_inputs(8, 64, seed=5))
    before = fm.launches
    out = fm.fused_mlp_forward(x, packed, 'sigmoid')
    assert fm.launches == before          # no kernel on the CPU
    assert torch.equal(out, fm.mlp_reference(x, params, 'sigmoid'))


def test_fused_mlp_forward_rejects_other_devices():
    packed = fm.pack_mlp_params(_torch_params(_numpy_params([32, 16], 6)), 'cpu')
    with pytest.raises(ValueError, match='no kernel for device meta'):
        fm.fused_mlp_forward(torch.empty(4, 32, device='meta'), packed)


def test_kernel_shape_limits_raise():
    fm.check_kernel_shape([1792, 512, 512, 64])        # the default model
    for pdims, match in (([2112, 512, 64], 'inputs up to'),
                         ([1792, 1088, 64], 'widths up to'),
                         ([64] * 10, 'layers')):
        with pytest.raises(ValueError, match=match):
            fm.check_kernel_shape(pdims)


def _unpack_layers(packed):
    """Padded [K, N] weights and biases back out of the packed buffers by a
    replay of the kernel's tile walk: the block that owns the 64 output
    columns ``nb`` pulls, for K chunk ``kc``, the contiguous 64 x 64 tile
    ``nb * (K / 64) + kc``, which wgmma reads as 64 rows (output columns) of
    128 bytes, the 16-byte chunk ``c`` of row ``m`` stored at chunk
    ``c ^ (m % 8)`` (the 128-byte swizzle), one element at a time."""
    flat = packed.weights.float().numpy()
    out, off_w, off_b = [], 0, 0
    for pk, pn in zip(packed.pdims[:-1], packed.pdims[1:]):
        w = np.full((pk, pn), np.nan, np.float32)
        tiles = flat[off_w:off_w + pk * pn].reshape(pn // 64, pk // 64, 64, 8, 8)
        for nb in range(pn // 64):
            for kc in range(pk // 64):
                for m in range(64):             # row of the tile: an output column
                    for chunk in range(8):      # 16 bytes: 8 consecutive k
                        w[64 * kc + 8 * chunk:64 * kc + 8 * chunk + 8, 64 * nb + m] = \
                            tiles[nb, kc, m, chunk ^ (m % 8)]
        out.append((w, packed.biases[off_b:off_b + pn].numpy()))
        off_w += pk * pn
        off_b += pn
    assert off_w == packed.weights.numel() and off_b == packed.biases.numel()
    return out


def test_pack_mlp_params_layout():
    params = _numpy_params(RAGGED_DIMS, seed=7)
    packed = fm.pack_mlp_params(_torch_params(params), 'cpu')
    assert packed.dims == tuple(RAGGED_DIMS)
    assert packed.pdims == (768, 64, 64, 64)
    assert packed.weights.dtype == torch.bfloat16
    assert packed.biases.dtype == torch.float32
    for (W, b), (Wv, bv), (wp, bp), k, n in zip(
            params, packed.layers, _unpack_layers(packed),
            packed.dims[:-1], packed.dims[1:]):
        W16 = torch.from_numpy(W).bfloat16()
        assert torch.equal(Wv, W16) and torch.equal(bv, torch.from_numpy(b))
        np.testing.assert_array_equal(wp[:k, :n], W16.float().numpy())
        assert not wp[k:].any() and not wp[:, n:].any()   # zero padding, no NaN hole
        np.testing.assert_array_equal(bp[:n], b)
        assert not bp[n:].any()


@pytest.mark.parametrize('activation', ACTS)
def test_zero_padding_is_exact(activation):
    """The padded chain the kernel runs gives the unpadded chain's outputs:
    padded columns of x and of every hidden layer meet zero weight rows.
    Float64 with bf16-rounded operands keeps every sum exact."""
    act = fm.ACTIVATIONS[activation]
    params = _numpy_params(RAGGED_DIMS, seed=8)
    packed = fm.pack_mlp_params(_torch_params(params), 'cpu')
    x = torch.from_numpy(_inputs(8, RAGGED_DIMS[0], seed=9)).bfloat16().double()

    def chain(h, layers):
        for i, (W, b) in enumerate(layers):
            h = h @ torch.as_tensor(W).double() + torch.as_tensor(b).double()
            if i < len(layers) - 1:
                h = act(h).bfloat16().double()
        return h

    xp = torch.zeros(8, packed.pdims[0], dtype=torch.float64)
    xp[:, :RAGGED_DIMS[0]] = x
    want = chain(x, packed.layers)
    got = chain(xp, _unpack_layers(packed))[:, :RAGGED_DIMS[-1]]
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_swizzled_offset_is_the_descriptor_s_layout():
    """``swizzled_tiles`` places ``(row, k)`` of a tile where
    ``swizzled_offset`` says, and that is a permutation of the tile."""
    w = torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64)   # [K, N]
    tile = layout.swizzled_tiles(w.bfloat16().float()).numpy()
    seen = set()
    for m in range(64):
        for k in range(64):
            off = layout.swizzled_offset(m, k)
            assert tile[off] == w.bfloat16().float()[k, m]
            seen.add(off)
    assert seen == set(range(64 * 64))


FULL_PDIMS = (1792, 512, 512, 64)
PLAN_PDIMS = [FULL_PDIMS, (2048, 1024, 1024), (2048, 1024, 1024, 1024, 64), (64, 64),
              (128,) + (128,) * 7 + (64,), (768, 64, 64, 64), (192, 256, 256, 256, 64)]


@pytest.mark.parametrize('pdims', PLAN_PDIMS)
@pytest.mark.parametrize('batch', [1, 2, 17, 63, 64, 65, fm.SMALL_BATCH_MAX - 1,
                                   fm.SMALL_BATCH_MAX, fm.SMALL_BATCH_MAX + 1, 4096, 4099])
def test_plan_mlp_picks_the_kernel_from_the_batch_and_fits_shared_memory(batch, pdims):
    plan = fm.plan_mlp(batch, pdims)
    assert plan == fm.plan_mlp(batch, list(pdims))            # a pure function
    small = batch <= fm.SMALL_BATCH_MAX
    assert plan.kernel == ('small' if small else 'large')
    if small:
        assert (plan.rows, plan.cluster) == (8, 8)
        # all of x stays: the split of K over the warpgroups needs it
        assert plan.units * plan.stage_cols >= pdims[0] and plan.stages == plan.units
    else:
        assert plan.rows == (64 if max(pdims[1:]) <= 512 else 32) and plan.cluster == 2
        assert plan.stage_cols == 64
    # a warpgroup's share of a layer's column blocks fits its accumulators
    mine = max(-(-(n // 64) // plan.cluster) for n in pdims[1:])
    assert (mine if small else -(-mine // 2)) <= {8: 2, 32: 4, 64: 2}[plan.rows]
    # the buffers: 1024-aligned, in order, inside what a block may use
    assert plan.smem_bytes <= fm.MAX_SMEM
    assert fm._MIN_DEPTH <= plan.depth <= fm._MAX_DEPTH
    hidden = list(pdims[1:-1])
    sizes = {
        'off_h0': plan.rows * 2 * max(hidden[0::2], default=0),
        'off_h1': plan.rows * 2 * max(hidden[1::2], default=0),
        'off_stage': plan.stages * plan.stage_bytes,
        'off_panel': plan.units * plan.rows * plan.stage_cols * 2,
        'off_ring': plan.depth * 8192,
    }
    # a staged chunk: 4 floats more a row than the chunk, and four 128-byte pads
    assert plan.stage_bytes >= plan.rows * (plan.stage_cols + 4) * 4 + 512
    spans = []
    for name, size in sizes.items():
        off = getattr(plan, name)
        assert off % 1024 == 0 and off >= fm._BAR_BYTES
        assert off + size + 1024 <= plan.smem_bytes             # 1024 to align the start
        spans.append((off, off + size, name))
    assert plan.off_red % 1024 == 0 and plan.off_panel < plan.off_red <= plan.off_ring
    spans.sort()
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        # only the staging of x may lie in the odd layers' buffer, which the
        # first layer does not write
        assert end <= start or {a, b} == {'off_h1', 'off_stage'}, (a, b)


def test_plan_mlp_raises_for_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match='inputs up to'):
        fm.plan_mlp(1, (2112, 512, 64))
    with pytest.raises(ValueError, match='layers'):
        fm.plan_mlp(4096, (64,) * 10)


@pytest.mark.parametrize('cluster', [2, 8])
@pytest.mark.parametrize('pdims', [FULL_PDIMS, (2048, 1024, 1024), (64, 64)])
def test_cluster_ranks_pull_every_weight_tile_once(pdims, cluster):
    """The producer's walk (layer, K chunk, owned column block) of every
    rank of a cluster, replayed: together the ranks pull each 64 x 64 tile
    of every layer exactly once, and a rank's sequence numbers, by which its
    consumers find a tile in the ring, are consecutive."""
    for k, n in zip(pdims[:-1], pdims[1:]):
        nk, nb = k // 64, n // 64
        pulled = []
        for rank in range(cluster):
            mine = (nb - rank + cluster - 1) // cluster if rank < nb else 0
            seq = []
            for kc in range(nk):
                for b in range(mine):
                    pulled.append((rank + b * cluster) * nk + kc)     # tile index
                    seq.append(kc * mine + b)
            assert seq == list(range(nk * mine))
        assert sorted(pulled) == list(range(nk * nb))


def test_kernel_library_is_rebuilt_when_its_inputs_change(tmp_path, monkeypatch):
    """The stamp beside the library holds a hash of the sources and the
    nvcc flags; a library with a missing or different stamp is rebuilt."""
    monkeypatch.setattr(_build, 'LIBRARY', tmp_path / 'lib.so')
    monkeypatch.setattr(_build, 'STAMP', tmp_path / 'lib.so.stamp')
    assert _build._stale()                        # nothing built
    _build.LIBRARY.write_bytes(b'')
    assert _build._stale()                        # no stamp
    _build.STAMP.write_text(_build._fingerprint() + '\n')
    assert not _build._stale()
    monkeypatch.setattr(_build, 'NVCC_FLAGS', _build.NVCC_FLAGS + ['-lineinfo'])
    assert _build._stale()                        # other flags
