"""Conditional diffusion denoiser over motion windows, and its DDIM sampler.

PyTorch counterpart of ``inferbiomechanics_tpu/models/diffusion.py``: the
cosine DDPM schedule, the timestep embedding, the denoiser (a pre-LN
transformer over the window's frames that predicts the noise in the
window's ground-contact targets, conditioned on its kinematic inputs and a
timestep), the diffusion target space, the partial-denoising proposal and
the DDIM sampler with classifier-free guidance.

The denoiser holds the JAX model's ``vpu`` parameter tree (``weights.py``
maps the names), or with any other ``attn_impl`` its flax-attention tree
(the JAX ``EncoderBlock`` takes ``MultiHeadDotProductAttention`` for every
``attn_impl`` but ``'vpu'``), whose one forward is the plain bf16 one. Over
the ``vpu`` tree it has two forwards, as the transformer has:

- ``DiffusionDenoiser.forward``: the ``vpu`` math in plain PyTorch, bf16
  compute with a bf16 residual stream, as ``model.apply`` runs it;
- :func:`fused_denoiser_eps`: inference through the fused encoder layer
  kernel (``ops/fused_encoder.py``), one launch per layer, with an f32
  residual stream inside the encoder.

The sampler runs the chain eagerly, one denoiser call a step (JAX runs it as
one ``lax.scan`` program). Its random draws come from a ``torch.Generator``,
or from a :data:`NoiseSource` handed to it: the seam through which a test
feeds the JAX sampler's own ``jax.random`` draws. Serving and ``analyze``
ask :func:`chain_noise` for theirs, which gives none (the generator draws);
an exported chain draws from :func:`seeded_noise`, plain tensor ops of a
seed given at call time.

Training: :func:`make_diffusion_train_step` is the eps-prediction step, with
classifier-free guidance's :func:`drop_conditioning`. A step's random draws
(the timesteps, the noise and the conditioning's keep mask) come through one
seam, :class:`TrainDraws`: by default from the train state's per-step
generator (:func:`generator_draws`), and in tests from the JAX step's own
``jax.random`` draws. ``--augment-*`` mirrors and noises the conditioning
and mirrors the labels before that (``train/augment.py``), from the state's
augmentation generator, so it moves none of those draws. The loop is
``train/diffusion_loop.py``.
"""

from __future__ import annotations

import json
import logging
import math
import os
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.dataset import input_layout
from inferbiomechanics_tpu_torch.models.common import (
    MaskSource, ModelInput, generator_masks, global_rows, init_linear, pack_inputs,
    slice_output_heads,
)
from inferbiomechanics_tpu_torch.models.transformer import (
    ATTN_IMPLS, EncoderBlock, FlaxAttention, _dense, _layernorm,
)
from inferbiomechanics_tpu_torch.ops import fused_encoder as fe
from inferbiomechanics_tpu_torch.ops.fused_encoder import (
    LN_EPS, PackedEncoderLayer, pack_encoder_params,
)
from inferbiomechanics_tpu_torch.train.augment import AugmentDraws, Augmenter, maybe_augment
from inferbiomechanics_tpu_torch.train.step import as_train_step, aug_draws_of

logger = logging.getLogger(__name__)

_DT = torch.bfloat16
_O = K.OutputDataKeys
# the four ground-contact heads in the order of the diffusion target layout
_TARGET_KEYS = (_O.GROUND_CONTACT_COPS_IN_ROOT_FRAME,
                _O.GROUND_CONTACT_FORCES_IN_ROOT_FRAME,
                _O.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME,
                _O.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME)

# noise(draw, shape, device) -> float32 tensor of ``shape``: draw 0 is the
# chain's initial noise, draw i >= 1 the z of the chain's step i
NoiseSource = Callable[[int, Tuple[int, ...], torch.device], torch.Tensor]


# ---------------------------------------------------------------------------
# Noise schedule
# ---------------------------------------------------------------------------

class DDPMSchedule:
    """Precomputed DDPM constants (cosine schedule, Nichol & Dhariwal):
    computed in float64 numpy, kept as float32 tensors on ``device``."""

    def __init__(self, timesteps: int = 1000, s: float = 0.008, device=None):
        self.timesteps = timesteps
        t = np.linspace(0, timesteps, timesteps + 1)
        f = np.cos((t / timesteps + s) / (1 + s) * np.pi / 2) ** 2
        alpha_bar = f / f[0]
        betas = np.clip(1 - alpha_bar[1:] / alpha_bar[:-1], 0, 0.999)
        device = torch.device('cpu' if device is None else device)
        self.betas = torch.tensor(betas, dtype=torch.float32, device=device)
        self.alphas = 1.0 - self.betas
        self.alpha_bars = torch.tensor(alpha_bar[1:], dtype=torch.float32,
                                       device=device)

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """Forward process: x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps; t [B] ints."""
        ab = self.alpha_bars.to(x0.device)[t][:, None, None]
        return torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * noise


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal embedding of integer timesteps [B] -> [B, dim], float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


# ---------------------------------------------------------------------------
# Denoiser network
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PackedDenoiser:
    """What :func:`fused_denoiser_eps` reads, made once per load: every
    encoder layer packed for the kernel, and bf16 copies of the weights
    around it (``[in, out]`` kernels, biases, the temporal embedding); the
    final LayerNorm stays f32."""
    layers: Tuple[PackedEncoderLayer, ...]
    dense: Dict[str, Tuple[torch.Tensor, torch.Tensor]]
    temporal_embedding: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.temporal_embedding.device


class DiffusionDenoiser(nn.Module):
    """Predicts the noise eps in ``x_t`` [B, T, target_channels] given the
    timestep ``t`` [B] and the window's conditioning inputs [B, T, C_in]."""

    DENSE = ('target_proj', 'cond_proj', 't_mlp1', 't_mlp2', 'eps_head')

    def __init__(self, num_dofs: int, num_contact_bodies: int,
                 history_len: int, stride: int, root_history_len: int,
                 d_model: int = 256, num_layers: int = 4, num_heads: int = 8,
                 mlp_ratio: int = 4, timesteps: int = 1000,
                 attn_impl: str = 'vpu', *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f'attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}')
        if d_model % num_heads:
            raise ValueError(f'd_model {d_model} does not divide into '
                             f'{num_heads} heads')
        self.num_dofs = num_dofs
        self.num_contact_bodies = num_contact_bodies
        self.num_frames = history_len // stride
        self.d_model, self.num_layers, self.num_heads = d_model, num_layers, num_heads
        self.timesteps = timesteps
        self.attn_impl = attn_impl
        device = 'cpu' if device is None else device
        channels = sum(w for _, w in input_layout(num_dofs, root_history_len))

        def linear(d_in: int, d_out: int) -> nn.Linear:
            return nn.utils.skip_init(nn.Linear, d_in, d_out, device=device)

        self.target_proj = linear(self.target_channels, d_model)
        self.cond_proj = linear(channels, d_model)
        self.t_mlp1 = linear(d_model, d_model)
        self.t_mlp2 = linear(d_model, d_model)
        self.temporal_embedding = nn.Parameter(
            torch.empty(self.num_frames, d_model, device=device))
        # the JAX EncoderBlock has no 'pallas' branch: it takes the flax
        # attention for every attn_impl but 'vpu'
        self.blocks = nn.ModuleList(
            EncoderBlock(d_model, num_heads, mlp_ratio,
                         attn_impl='vpu' if attn_impl == 'vpu' else 'flax', device=device)
            for _ in range(num_layers))
        self.final_ln = nn.LayerNorm(d_model, eps=LN_EPS, device=device)
        self.eps_head = linear(d_model, self.target_channels)
        # flax's defaults, drawn on the CPU so that a seed gives the same
        # weights on every device: lecun-normal kernels, zero biases,
        # N(0, 0.02) temporal embedding (LayerNorm is ones / zeros already)
        for module in self.modules():
            if isinstance(module, nn.Linear):
                init_linear(module, 'lecun', generator)
            elif isinstance(module, FlaxAttention):
                module.init_params(generator)
        with torch.no_grad():
            self.temporal_embedding.copy_(
                torch.randn(self.num_frames, d_model, generator=generator) * 0.02)
        self._packed: Optional[PackedDenoiser] = None
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._drop_packed())

    @property
    def target_channels(self) -> int:
        # per frame [CoPs 3nb | forces 3nb | torques 3nb | wrenches 6nb]
        return self.num_contact_bodies * (3 * 3 + 6)

    def _drop_packed(self) -> None:
        self._packed = None

    def train(self, mode: bool = True):
        if mode:    # training changes the weights; eval() keeps what is packed
            self._drop_packed()
        return super().train(mode)

    def packed(self) -> PackedDenoiser:
        """The fused forward's weights, made once after each train() or load."""
        device = self.temporal_embedding.device
        if self._packed is None or self._packed.device != device:
            with torch.no_grad():
                self._packed = PackedDenoiser(
                    tuple(pack_encoder_params(blk.layer_params(), device)
                          for blk in self.blocks),
                    {name: (getattr(self, name).weight.detach().t().to(_DT).contiguous(),
                            getattr(self, name).bias.detach().to(_DT))
                     for name in self.DENSE},
                    self.temporal_embedding.detach().to(_DT))
        return self._packed

    def check_shapes(self, x: torch.Tensor, cond: torch.Tensor) -> None:
        want = (self.num_frames, self.target_channels)
        if x.ndim != 3 or tuple(x.shape[1:]) != want:
            raise ValueError(f'noisy targets must be (B, {want[0]}, {want[1]}), '
                             f'got {tuple(x.shape)}')
        if cond.ndim != 3 or cond.shape[:2] != x.shape[:2]:
            raise ValueError(f'conditioning must be (B, {want[0]}, C_in) beside '
                             f'targets {tuple(x.shape)}, got {tuple(cond.shape)}')

    def forward(self, noisy_targets: torch.Tensor, t: torch.Tensor,
                cond_inputs: ModelInput) -> torch.Tensor:
        """The noise eps [B, T, target_channels], float32."""
        cond = pack_inputs(cond_inputs)
        self.check_shapes(noisy_targets, cond)
        x = _dense(noisy_targets, self.target_proj)
        c = _dense(cond, self.cond_proj)
        te = _dense(timestep_embedding(t, self.d_model), self.t_mlp1)
        te = _dense(F.gelu(te, approximate='tanh'), self.t_mlp2)
        h = x + c + te[:, None, :] + self.temporal_embedding.to(_DT)
        for blk in self.blocks:
            h = blk(h)
        return _dense(_layernorm(h, self.final_ln), self.eps_head).float()


def _packed_dense(packed: PackedDenoiser, name: str, h: torch.Tensor) -> torch.Tensor:
    w, b = packed.dense[name]
    return h.to(_DT) @ w + b


def _time_embedding(model: DiffusionDenoiser, packed: PackedDenoiser,
                    t: torch.Tensor) -> torch.Tensor:
    te = _packed_dense(packed, 't_mlp1', timestep_embedding(t, model.d_model))
    return _packed_dense(packed, 't_mlp2', F.gelu(te, approximate='tanh'))


def _fused_eps(model: DiffusionDenoiser, packed: PackedDenoiser, noisy: torch.Tensor,
               c: torch.Tensor, te: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """The fused forward from the conditioning's projection ``c`` [B, T, d]
    and the timesteps' embedding ``te`` [B or 1, d], both bf16: the sum in
    the JAX order, one bf16 rounding an add, then the encoder on an f32
    residual stream, the final LayerNorm in f32 rounded to bf16, the head."""
    h = _packed_dense(packed, 'target_proj', noisy) + c
    h = (h + te[:, None, :]) + packed.temporal_embedding
    h = h.float().contiguous()
    for layer in packed.layers:
        if use_kernel:
            h = fe.fused_encoder_layer(h, layer, model.num_heads)
        else:
            h = fe.encoder_layer_reference(h, layer.params, model.num_heads)
    return _packed_dense(packed, 'eps_head', _layernorm(h, model.final_ln)).float()


def fused_denoiser_eps(model: DiffusionDenoiser, noisy_targets: torch.Tensor,
                       t: torch.Tensor, cond_inputs: ModelInput, *,
                       use_kernel: bool = True) -> torch.Tensor:
    """eps-prediction forward through the fused encoder layer on ``vpu``
    weights: each encoder layer one call of ``fused_encoder_layer`` (the
    kernel for a CUDA tensor, its plain version for a CPU tensor) on an f32
    residual stream; the projections, the timestep MLP and the head in bf16.
    ``use_kernel=False`` takes the layer's plain version on any device."""
    packed = model.packed()
    cond = pack_inputs(cond_inputs)
    model.check_shapes(noisy_targets, cond)
    c = _packed_dense(packed, 'cond_proj', cond)
    return _fused_eps(model, packed, noisy_targets, c,
                      _time_embedding(model, packed, t), use_kernel)


# ---------------------------------------------------------------------------
# The diffusion target space
# ---------------------------------------------------------------------------

def target_scales(num_contact_bodies: int, device=None) -> torch.Tensor:
    """Per-channel normalizers of the diffusion target space (fixed physical
    scales, in :func:`diffusion_targets_from_labels`'s order): CoPs 0.5 m,
    forces 10 N/kg, torques 5 Nm/kg, wrenches [5 x 3 | 10 x 3] a body."""
    nb = num_contact_bodies
    one_body = [torch.full((3 * nb,), v) for v in (0.5, 10.0, 5.0)]
    wrench = torch.tensor([5.0] * 3 + [10.0] * 3).repeat(nb)
    return torch.cat(one_body + [wrench]).to(device=device, dtype=torch.float32)


def diffusion_targets_from_labels(packed_labels: torch.Tensor,
                                  lab_offsets: Dict[str, Tuple[int, int]],
                                  num_contact_bodies: int,
                                  scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[B, T, C_lab] -> [B, T, target_channels] in head-slice order,
    normalized into the diffusion space (the sampler denormalizes at its
    exit). ``scales`` is :func:`target_scales` made once on the labels'
    device (a train step captured as a CUDA graph cannot copy from the
    host); made here when None."""
    parts = [packed_labels[..., o:o + w]
             for o, w in (lab_offsets[key] for key in _TARGET_KEYS)]
    x = torch.cat(parts, dim=-1)
    if scales is None:
        scales = target_scales(num_contact_bodies, x.device)
    return x / scales.to(x.dtype)


def diffusion_targets_from_outputs(outputs: Dict[str, torch.Tensor],
                                   target_space: str = 'normalized') -> torch.Tensor:
    """Model-output dict -> [B, T, target_channels] in head-slice order,
    normalized into the diffusion space (``'raw'`` skips the normalization,
    for denoisers trained before it): the proposal packing for partial
    denoising."""
    x = torch.cat([outputs[key] for key in _TARGET_KEYS], dim=-1)
    if target_space == 'raw':
        return x
    nb = outputs[_TARGET_KEYS[0]].shape[-1] // 3
    return x / target_scales(nb, x.device).to(x.dtype)


def checkpoint_target_space(checkpoint_dir: str) -> str:
    """Which space a diffusion checkpoint denoises in: its
    ``run_config.json`` sidecar's ``diffusion_target_space``, or ``'raw'``
    (with the JAX package's warning) for a checkpoint trained before the
    target normalization, whose sidecar lacks the key or which has none."""
    from inferbiomechanics_tpu_torch.train.run_config import RUN_CONFIG_NAME
    path = os.path.join(checkpoint_dir, RUN_CONFIG_NAME)
    try:
        with open(path) as f:
            space = json.load(f).get('diffusion_target_space')
    except (OSError, ValueError):
        space = None
    if space is None:
        logger.warning(
            '%s predates the normalized diffusion target space '
            '(no diffusion_target_space in run_config.json); sampling '
            'in the legacy raw space', checkpoint_dir)
        return 'raw'
    return space


def make_partial_proposal_fn(config, dataset, init_checkpoint,
                             target_space: str = 'normalized', *, device='cpu'):
    """Load the all-frames proposal model for partial denoising from
    ``init_checkpoint`` (the newest of the port's checkpoints in a
    directory, or a checkpoint file, the port's or the JAX package's) and
    return ``propose(x) ->
    [B, T, target_channels]`` in the diffusion target layout.

    With a ``run_config.json`` sidecar there, the proposal's architecture
    comes from it (any all-frames regression family); without one it is a
    feedforward model built from ``config``'s flags. The proposal runs its
    eval forward: K1 for the feedforward model, K4 for GroundLink, K2 for a
    ``pallas`` transformer on a CUDA tensor. Raises ``ValueError`` as the
    JAX package does, in its words."""
    from inferbiomechanics_tpu_torch.train.checkpoint import load_model
    from inferbiomechanics_tpu_torch.train.run_config import (
        apply_architecture, load_run_config,
    )

    if not init_checkpoint:
        raise ValueError('--diffusion-partial needs --init-checkpoint '
                         '(an all-frames feedforward proposal model)')
    prop_config = replace(config, model_type='feedforward',
                          output_data_format='all_frames')
    sidecar = load_run_config(init_checkpoint)
    if sidecar is not None:
        prop_config = apply_architecture(prop_config, sidecar)
        if prop_config.output_data_format != 'all_frames':
            raise ValueError(
                f'--init-checkpoint {init_checkpoint} was trained as '
                f'output_data_format='
                f'{prop_config.output_data_format!r} (run_config.json); '
                'partial denoising needs an all_frames proposal')
        if prop_config.model_type == 'diffusion':
            raise ValueError(
                f'--init-checkpoint {init_checkpoint} holds a diffusion '
                'model (run_config.json); the proposal must be a '
                'regression model (feedforward/groundlink/transformer)')
        if (prop_config.window_size != config.window_size
                or prop_config.stride != config.stride):
            raise ValueError(
                f'--init-checkpoint {init_checkpoint} was trained on '
                f'window/stride {prop_config.window_size}/'
                f'{prop_config.stride} (run_config.json) but this run '
                f'uses {config.window_size}/{config.stride} — the '
                'proposal must see the same windows as the denoiser')
    named = os.path.isfile(init_checkpoint)     # a file (either format), else a dir
    prop_model, epoch, _batch = load_model(
        prop_config, dataset, None if named else init_checkpoint,
        checkpoint_file=init_checkpoint if named else None, device=device)
    if epoch < 0:
        raise ValueError(f'--init-checkpoint: no checkpoint '
                         f'in {init_checkpoint}')

    def propose(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return diffusion_targets_from_outputs(prop_model(x),
                                                  target_space=target_space)

    return propose


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainDraws:
    """Where a train step's random draws come from: ``timesteps(batch, T,
    device)`` int64 [batch] uniform on 0..T-1, ``noise(shape, device)``
    float32 N(0, 1), and ``masks`` (a :data:`MaskSource`) the keep mask of
    the conditioning, asked for last and only when ``cond_dropout`` > 0, so
    that the timesteps and the noise do not depend on it."""
    timesteps: Callable[[int, int, torch.device], torch.Tensor]
    noise: Callable[[Tuple[int, ...], torch.device], torch.Tensor]
    masks: MaskSource


def generator_draws(generator: Optional[torch.Generator],
                    shard: Optional[Tuple[int, int]] = None) -> TrainDraws:
    """A step's draws from ``generator`` (torch's default one when None), on
    the device of the step's tensors; under data parallelism (``shard`` =
    (rank, world size)) this rank's rows of the global batch's draws
    (``models/common.py::global_rows``)."""
    return TrainDraws(
        timesteps=lambda b, steps, device: global_rows(
            lambda s: torch.randint(0, steps, s, generator=generator, device=device),
            (b,), shard),
        noise=lambda shape, device: global_rows(
            lambda s: torch.randn(s, generator=generator, device=device), shape, shard),
        masks=generator_masks(generator, shard))


def drop_conditioning(cond: torch.Tensor, cond_dropout: float,
                      masks: MaskSource) -> torch.Tensor:
    """Zero each sample's conditioning [B, T, C_in] with probability
    ``cond_dropout`` (classifier-free guidance training; the cond_proj bias
    becomes the learned null embedding), the keep mask [B] from ``masks``.
    ``cond_dropout`` 0 returns ``cond`` itself and draws nothing."""
    if cond_dropout <= 0.0:
        return cond
    keep = masks((cond.shape[0],), cond_dropout, cond.device)
    return cond * keep[:, None, None].to(cond.dtype)


def diffusion_loss(model: DiffusionDenoiser, schedule: DDPMSchedule, cond_inputs: ModelInput,
                   labels: torch.Tensor, lab_offsets: Dict[str, Tuple[int, int]],
                   draws: TrainDraws, cond_dropout: float = 0.0,
                   scales: Optional[torch.Tensor] = None,
                   augment: Optional[Augmenter] = None,
                   aug_draws: Optional[AugmentDraws] = None):
    """The eps-prediction MSE of one all-frames batch, in float32: the
    conditioning and the labels augmented (``augment``, from ``aug_draws``;
    the JAX step augments before dropping the conditioning), the targets
    from the labels, t ~ U{0..T-1}, noise ~ N(0, 1), x_t by ``q_sample``,
    the conditioning dropped (:func:`drop_conditioning`), then mean((eps -
    noise)^2). Returns (loss, {'loss': loss, detached})."""
    cond, labels = maybe_augment(augment, pack_inputs(cond_inputs), labels, aug_draws)
    x0 = diffusion_targets_from_labels(labels, lab_offsets, model.num_contact_bodies, scales)
    t = draws.timesteps(x0.shape[0], schedule.timesteps, x0.device)
    noise = draws.noise(tuple(x0.shape), x0.device)
    cond = drop_conditioning(cond, cond_dropout, draws.masks)
    eps = model(schedule.q_sample(x0, t, noise), t, cond)
    loss = torch.mean((eps - noise) ** 2)
    return loss, {'loss': loss.detach()}


def diffusion_grads(model: DiffusionDenoiser, schedule: DDPMSchedule,
                    lab_offsets: Dict[str, Tuple[int, int]], cond_dropout: float = 0.0,
                    draws: Optional[TrainDraws] = None,
                    augment: Optional[Augmenter] = None,
                    aug_draws: Optional[AugmentDraws] = None) -> Callable:
    """``grads(state, inputs, labels) -> {'loss'}``: forward, loss and
    backward of :func:`diffusion_loss`, the gradients left on the
    parameters. ``draws`` None takes the state's per-step generator
    (``TrainState.dropout_gen``, reseeded from the seed and the step count
    before every step, and registered with a captured step's graph), and
    ``aug_draws`` None its augmentation generator (``TrainState.aug_gen``),
    so that augmenting moves none of the step's own draws. The
    schedule must be on the training device: a captured step cannot copy its
    constants from the host."""
    scales = target_scales(model.num_contact_bodies, schedule.alpha_bars.device)

    def grads(state, cond_inputs: ModelInput, labels: torch.Tensor):
        model.train()
        source = draws if draws is not None else generator_draws(
            state.dropout_gen, getattr(state, 'draw_shard', None))
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = diffusion_loss(model, schedule, cond_inputs, labels, lab_offsets,
                                       source, cond_dropout, scales, augment,
                                       aug_draws_of(state, aug_draws))
        loss.backward()
        return metrics

    return grads


def make_diffusion_train_step(model: DiffusionDenoiser,
                              lab_offsets: Dict[str, Tuple[int, int]],
                              schedule: DDPMSchedule, cond_dropout: float = 0.0,
                              draws: Optional[TrainDraws] = None,
                              augment: Optional[Augmenter] = None,
                              aug_draws: Optional[AugmentDraws] = None) -> Callable:
    """``step(state, inputs, labels) -> {'loss'}`` (the state updated in
    place), the JAX package's eps-prediction train step: the draws
    (:func:`diffusion_grads`), forward, loss, backward, the optimizer's
    update (and the state's EMA, when it keeps one). As in the JAX package,
    ``--grad-accum-steps`` does not apply."""
    return as_train_step(diffusion_grads(model, schedule, lab_offsets, cond_dropout, draws,
                                         augment, aug_draws))


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def chain_noise(seed: int, samples: int) -> Optional[NoiseSource]:
    """The noise source of the chains that ``serve`` (seed 0, ``samples``
    chains stacked) and ``analyze`` (seed 7) run: none, so that their seeded
    generator draws. Tests replace this function to feed the JAX package's
    draws."""
    del seed, samples
    return None


_M32 = 0xFFFFFFFF


def _mix32(v: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 values below 2^32 (two rounds of
    xor-shift-multiply), elementwise; the result is below 2^32 too."""
    v = ((v ^ (v >> 16)) * 0x45D9F3B) & _M32
    v = ((v ^ (v >> 16)) * 0x45D9F3B) & _M32
    return v ^ (v >> 16)


def seeded_noise(seed: torch.Tensor) -> NoiseSource:
    """A :data:`NoiseSource` written in plain tensor ops from ``seed`` (an
    integer tensor of one element), which a ``torch.export`` program can
    carry with the seed as an argument at call time (``export``'s diffusion
    chain; serve and analyze draw from generators). Element j of draw i is
    ``sqrt(-2 ln u1) cos(2 pi u2)`` (Box-Muller) with u1, u2 in (0, 1) from
    24 bits of hashes of (seed, i, 2 j) and (seed, i, 2 j + 1): the same seed
    gives the same draws bit for bit on one device, another seed others.
    It is not the JAX package's threefry stream."""

    def noise(i: int, shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
        key = _mix32(seed.reshape(()).to(device=device, dtype=torch.int64) & _M32)
        key = _mix32(key ^ ((i * 0x9E3779B9) & _M32))
        j = 2 * torch.arange(math.prod(shape), device=device, dtype=torch.int64)

        def uniform(k):
            h = _mix32((_mix32(k) + key) & _M32)
            return ((h >> 8).float() + 0.5) * 2.0 ** -24

        u1, u2 = uniform(j), uniform(j + 1)
        return (torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)).reshape(shape)

    return noise


def _step_coefficients(alpha_bars: np.ndarray, ts: np.ndarray, ts_prev: np.ndarray,
                       eta: float):
    """Each DDIM step's scalars in float32, in the JAX sampler's order of
    operations: sqrt(1 - ab_t), sqrt(ab_t), sqrt(ab_prev), the eps
    coefficient sqrt(max(1 - ab_prev - sigma^2, 0)) and the noise's
    coefficient (sigma, or 0 on the last step)."""
    f32 = np.float32
    out = []
    for t, t_prev in zip(ts, ts_prev):
        ab_t = alpha_bars[t]
        ab_prev = alpha_bars[max(t_prev, 0)] if t_prev >= 0 else f32(1.0)
        sigma = (f32(eta) * np.sqrt((f32(1) - ab_prev) / (f32(1) - ab_t))
                 * np.sqrt(f32(1) - ab_t / ab_prev))
        dir_coef = np.sqrt(np.maximum(f32(1) - ab_prev - sigma ** 2, f32(0)))
        z_coef = sigma if t_prev >= 0 else f32(0)
        out.append(tuple(float(f32(v)) for v in (
            np.sqrt(f32(1) - ab_t), np.sqrt(ab_t), np.sqrt(ab_prev), dir_coef, z_coef)))
    return out


def make_sampler(model: DiffusionDenoiser,
                 schedule: Optional[DDPMSchedule] = None,
                 num_steps: Optional[int] = None,
                 eta: float = 0.0,
                 fused_inference: bool = False,
                 guidance_scale: float = 1.0,
                 partial_frac: Optional[float] = None,
                 target_space: str = 'normalized'):
    """Build ``sample(model, cond_inputs, generator=None, init=None,
    noise=None) -> outputs dict``, the JAX sampler's DDIM chain.

    ``model`` fixes the shapes and the schedule's length; ``sample`` runs the
    weights of the model it is given (a reload swaps it). The chain steps
    over ``np.linspace(t_top, 0, n).round()`` (``num_steps``, default the
    whole schedule); ``eta`` scales the noise each step adds back; x0 is
    clipped to +-8 in the normalized space, +-50 in the raw one.
    ``fused_inference`` runs each denoiser call through the fused encoder
    layer (:func:`fused_denoiser_eps`); it needs a ``d_model`` that the
    kernel takes (a multiple of 128), and raises otherwise, also on the CPU.
    ``guidance_scale != 1`` evaluates the conditional and the
    null-conditioned rows in one forward on a ``[2B]`` concat and takes
    ``eps_u + scale * (eps_c - eps_u)``; scale 1 is the plain chain.
    ``partial_frac`` starts the chain at ``round(partial_frac * (T - 1))``
    from ``q_sample(init, t_top)``, with the steps thinned in proportion;
    ``sample`` then needs ``init`` [B, T, target_channels].

    ``sample`` draws the initial noise and each step's z from ``generator``
    (the default generator if None) on ``cond_inputs``' device, or asks
    ``noise`` for them (:data:`NoiseSource`); a step whose noise coefficient
    is 0 (every step at ``eta`` 0, and the last) draws none. A ``trace``
    list gets each step's ``(t, x_t)`` as the denoiser sees it.
    """
    if fused_inference and model.attn_impl != 'vpu':
        raise ValueError('fused_inference consumes the vpu parameter tree; '
                         f'this denoiser was built with '
                         f'attn_impl={model.attn_impl!r}')
    if fused_inference and model.d_model % 128:
        raise ValueError(f'fused_inference: the fused encoder layer kernel takes '
                         f'a d_model that is a multiple of 128, and this denoiser '
                         f'has d_model {model.d_model}; serve it without '
                         f'--fused-inference')
    if target_space not in ('normalized', 'raw'):
        raise ValueError(f'target_space must be normalized|raw, '
                         f'got {target_space!r}')
    normalized = target_space == 'normalized'
    x0_clip = 8.0 if normalized else 50.0
    sched = schedule or DDPMSchedule(model.timesteps)
    n = num_steps or sched.timesteps
    t_top = sched.timesteps - 1
    if partial_frac is not None:
        if not 0.0 < partial_frac <= 1.0:
            raise ValueError(f'partial_frac must be in (0, 1], got '
                             f'{partial_frac}')
        t_top = max(1, int(round(partial_frac * (sched.timesteps - 1))))
        n = max(1, min(int(round(n * partial_frac)), t_top + 1))
    ts = np.linspace(t_top, 0, n).round().astype(np.int32)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    alpha_bars = sched.alpha_bars.cpu().numpy()
    coefs = _step_coefficients(alpha_bars, ts, ts_prev, eta)
    c_out, n_frames = model.target_channels, model.num_frames
    cfg = guidance_scale != 1.0

    def sample(net: DiffusionDenoiser, cond_inputs: ModelInput,
               generator: Optional[torch.Generator] = None,
               init: Optional[torch.Tensor] = None,
               noise: Optional[NoiseSource] = None,
               trace: Optional[list] = None) -> Dict[str, torch.Tensor]:
        cond = pack_inputs(cond_inputs)
        b, T = cond.shape[0], cond.shape[1]
        shape = (b, T, c_out)
        dev = cond.device

        def draw(i: int) -> torch.Tensor:
            if noise is not None:
                z = noise(i, shape, dev)
                if tuple(z.shape) != shape:
                    raise ValueError(f'noise draw {i}: shape {tuple(z.shape)}, '
                                     f'want {shape}')
                return z.to(device=dev, dtype=torch.float32)
            return torch.randn(shape, generator=generator, device=dev)

        if T != n_frames:
            raise ValueError(f'conditioning must be (B, {n_frames}, C_in), '
                             f'got {tuple(cond.shape)}')
        with torch.no_grad():
            x = draw(0)
            if partial_frac is not None:
                if init is None:
                    raise ValueError('partial_frac sampling needs an init '
                                     'proposal ([B, T, target_channels])')
                if tuple(init.shape) != shape:
                    raise ValueError(f'init proposal must be [B, T, '
                                     f'target_channels] = {shape}, '
                                     f'got {tuple(init.shape)} (all-frames '
                                     f'proposals only)')
                x = sched.q_sample(init.float(),
                                   torch.full((b,), t_top, dtype=torch.long, device=dev), x)
            rows = torch.cat([cond, torch.zeros_like(cond)]) if cfg else cond
            if fused_inference:
                # the conditioning's projection and every step's timestep
                # embedding do not change along the chain: made once
                packed = net.packed()
                c = _packed_dense(packed, 'cond_proj', rows)
                te_all = _time_embedding(net, packed, torch.as_tensor(ts, device=dev))
            for i, (t, (a_eps, a_x0, a_prev, a_dir, a_z)) in enumerate(zip(ts, coefs)):
                if trace is not None:
                    trace.append((int(t), x))
                xb = torch.cat([x, x]) if cfg else x
                if fused_inference:
                    eps = _fused_eps(net, packed, xb, c, te_all[i:i + 1], True)
                else:
                    tb = torch.full((xb.shape[0],), int(t), dtype=torch.int32, device=dev)
                    eps = net(xb, tb, rows)
                if cfg:
                    eps_c, eps_u = eps[:b], eps[b:]
                    eps = eps_u + guidance_scale * (eps_c - eps_u)
                x0 = ((x - a_eps * eps) / a_x0).clamp_(-x0_clip, x0_clip)
                x = a_prev * x0 + a_dir * eps
                if a_z != 0.0:
                    x = x + a_z * draw(i + 1)
            if normalized:
                x = x * target_scales(net.num_contact_bodies, dev)
        return slice_output_heads(x, net.num_contact_bodies, T)

    sample.timesteps = ts
    return sample


def make_chain_forward(config, dataset, denoiser: DiffusionDenoiser, checkpoint_dir: str,
                       *, num_steps: int, seed: int, samples: int = 1,
                       partial: Optional[float] = None,
                       init_checkpoint: Optional[str] = None,
                       fused_inference: bool = False, device='cpu'):
    """The chains that ``serve`` (seed 0) and ``analyze`` (seed 7, 50 steps)
    run: ``forward(net, x) -> outputs`` for windows ``x`` [B, T, C_in] on
    ``device``, a ``num_steps`` DDIM chain of ``net`` (``denoiser`` fixes the
    shapes; a reload swaps ``net``) in the target space of
    ``checkpoint_dir``'s sidecar, drawn from a generator seeded ``seed`` at
    each call (or from :func:`chain_noise`'s source), with ``config``'s
    guidance scale. ``samples`` K > 1 stacks K chains into one batch and
    returns their mean and spread (:func:`stacked_samples`). ``partial``
    starts the chains from the proposal of ``init_checkpoint``'s model,
    loaded once here. Raises ``ValueError`` for a bad option, in the JAX
    package's words."""
    tspace = checkpoint_target_space(checkpoint_dir)
    sampler = make_sampler(denoiser, DDPMSchedule(config.diffusion_timesteps),
                           num_steps=num_steps, fused_inference=fused_inference,
                           guidance_scale=config.guidance_scale, partial_frac=partial,
                           target_space=tspace)
    propose = None
    if partial is not None:
        propose = make_partial_proposal_fn(config, dataset, init_checkpoint,
                                           target_space=tspace, device=device)
    noise = chain_noise(seed, samples)

    def forward(net: DiffusionDenoiser, x: torch.Tensor):
        init = propose(x) if propose is not None else None
        if samples > 1:
            x = x.repeat(samples, 1, 1)
            init = init.repeat(samples, 1, 1) if init is not None else None
        gen = torch.Generator(device=x.device).manual_seed(seed)
        out = sampler(net, x, gen, init=init, noise=noise)
        return stacked_samples(out, samples) if samples > 1 else out

    return forward


def stacked_samples(outputs: Dict[str, torch.Tensor], samples: int):
    """Outputs of ``samples`` chains stacked sample-major into one batch ->
    their mean and population standard deviation (as ``jnp.std``, ddof 0)."""
    mean, spread = {}, {}
    for k, v in outputs.items():
        v = v.reshape(samples, v.shape[0] // samples, *v.shape[1:])
        mean[k] = v.mean(0)
        spread[k] = v.std(0, unbiased=False)
    return mean, spread


__all__ = [
    'DDPMSchedule', 'DiffusionDenoiser', 'NoiseSource', 'PackedDenoiser', 'TrainDraws',
    'chain_noise', 'checkpoint_target_space', 'diffusion_grads', 'diffusion_loss',
    'diffusion_targets_from_labels', 'diffusion_targets_from_outputs', 'drop_conditioning',
    'fused_denoiser_eps', 'generator_draws', 'make_chain_forward',
    'make_diffusion_train_step', 'make_partial_proposal_fn',
    'make_sampler', 'seeded_noise', 'stacked_samples', 'target_scales',
    'timestep_embedding',
]
