"""Sagittal mirroring of the packed windows, and mirror test-time averaging.

PyTorch counterpart of ``inferbiomechanics_tpu/train/augment.py``: the
port's own copy of its numpy half (``MirrorSpec``, ``build_mirror_spec``,
``spec_from_dataset`` and their helpers, the same code, held to the original
by ``tests/test_torch_data.py``) and torch versions of ``mirror_outputs`` and
``tta_average``, and ``make_tta_eval_step`` on them; and the training-time
``Augmenter`` (per-sample mirroring and input noise inside a train step),
``augmenter_from_config`` and ``maybe_augment``. The Augmenter's draws (a
coin a sample, the noise) come through one seam, :class:`AugmentDraws`: by
default from the train state's augmentation generator
(:func:`generator_aug_draws`), and in tests from the JAX package's own draws
(which come from its ``rbg`` generator, so no stream could match).

Reflection math (lateral axis ``z`` by default; configurable): for the
mirror M = diag(1,1,-1) with det -1,
  * polar vectors (positions, linear vel/acc, forces, CoPs): v' = M v,
    negate the lateral component;
  * pseudovectors (angular vel/acc, torques, moments): v' = -M v, negate
    the two non-lateral components;
  * euler-XYZ angle triples (ball/free rotation DOFs, root euler history):
    M Rx(a)Ry(b)Rz(c) M = Rx(-a)Ry(-b)Rz(c), exact, the same signs as the
    pseudovector rule;
  * revolute DOFs about axis a_r: the mirrored rotation is about -M a_r, so
    the mirrored left coordinate is sign = a_l . (-M a_r) times the right
    one (+-1 when the pair's axes mirror onto each other; axes that do not
    fall back to +1 and are reported in ``MirrorSpec.approximate_dofs``).

Left/right pairing is derived from names: the token ``l``/``r`` (split on
``_``) is swapped, so ``hip_r_x`` and ``hip_l_x``, ``calcn_r`` and
``calcn_l``, and OpenSim-style ``hip_flexion_r`` and ``hip_flexion_l`` all
pair. Unpaired names map to themselves. For OpenSim semantic DOF names (no
axis suffix, e.g. ``pelvis_list``), the standard convention table applies:
``list`` / ``rotation`` / ``bending`` / ``adduction`` coordinates flip sign.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.dataset import (
    LABEL_PACK_ORDER, input_layout, label_layout, unpack,
)
from inferbiomechanics_tpu_torch.loss.evaluator import loss_and_metrics

# OpenSim semantic coordinate names that flip under a sagittal mirror
# (rotations about the forward/vertical axes, lateral translation).
_OPENSIM_FLIP_TOKENS = frozenset({'list', 'rotation', 'bending', 'adduction'})


def _swap_lr(name: str) -> str:
    """Swap the left/right token of a ``_``-separated name, if any."""
    toks = name.split('_')
    for i, t in enumerate(toks):
        if t == 'l':
            toks[i] = 'r'
            return '_'.join(toks)
        if t == 'r':
            toks[i] = 'l'
            return '_'.join(toks)
    return name


def _pairing(names: Sequence[str]) -> Tuple[np.ndarray, List[str]]:
    """index -> mirrored index (self when unpaired); plus unpaired names."""
    index = {n: i for i, n in enumerate(names)}
    perm = np.arange(len(names), dtype=np.int32)
    unpaired: List[str] = []
    for i, n in enumerate(names):
        partner = _swap_lr(n)
        if partner == n:
            continue
        j = index.get(partner)
        if j is None:
            unpaired.append(n)
        else:
            perm[i] = j
    return perm, unpaired


def _vector_signs(lateral_axis: int, pseudo: bool) -> np.ndarray:
    """Per-component sign of a 3-vector under the sagittal mirror."""
    s = np.ones(3, np.float32) if not pseudo else -np.ones(3, np.float32)
    s[lateral_axis] = -1.0 if not pseudo else 1.0
    return s


def _dof_signs(dof_names: Sequence[str], lateral_axis: int,
               joints=None) -> Tuple[np.ndarray, List[str]]:
    """Per-DOF sign under the mirror; plus DOFs where the sign is a
    fallback (+1) because the axis pair does not mirror cleanly."""
    axes = 'xyz'
    rot_flip = {a for i, a in enumerate(axes) if i != lateral_axis}
    trans_flip = axes[lateral_axis]
    # revolute-joint axis table (joint name -> unit axis), when available
    axis_of = {}
    # ball/free joints with ORDERED non-canonical rotation axes (e.g.
    # Rajagopal hips rotate z, x, y — data/osim.py round 4): the per-DOF
    # sign comes from the axis PAIR under the mirror, exactly like
    # revolute DOFs, one axis per coordinate. Canonical (rot_axes None)
    # joints keep the euler-XYZ letter rule below (identical result).
    ball_axes_of = {}
    if joints is not None:
        for j in joints:
            if getattr(j, 'type', None) == 'revolute':
                a = np.asarray(j.axis, np.float64)
                n = np.linalg.norm(a)
                if n > 0:
                    axis_of[j.name] = a / n
            elif (getattr(j, 'type', None) in ('ball', 'free')
                    and getattr(j, 'rot_axes', None) is not None):
                aa = np.asarray(j.rot_axes, np.float64)
                norms = np.linalg.norm(aa, axis=1, keepdims=True)
                if (norms > 0).all():
                    ball_axes_of[j.name] = aa / norms

    signs = np.ones(len(dof_names), np.float32)
    approximate: List[str] = []
    m_diag = np.ones(3)
    m_diag[lateral_axis] = -1.0
    for i, name in enumerate(dof_names):
        toks = name.split('_')
        last = toks[-1]
        def _paired_axis_sign(jname: str, k: int) -> bool:
            """Sign from the k-th ordered rotation axis of the joint and
            its left-right partner (itself when unpaired, e.g. the
            root): mirrored rotation about a is rotation about -Ma."""
            a_r = ball_axes_of.get(jname)
            a_l = ball_axes_of.get(_swap_lr(jname))
            if a_r is None and a_l is None:
                return False
            # osim.py drops rot_axes that are exactly canonical x,y,z,
            # so a one-sided entry means the OTHER side rotates about
            # the canonical axes — default the missing side to those,
            # never to a copy of the present side (e.g. a left joint
            # negating its y/z axes against a canonical right joint
            # would get every sign inverted).
            if a_r is None:
                a_r = np.eye(3)[:len(a_l)]
            if a_l is None:
                a_l = np.eye(3)[:len(a_r)]
            dot = float(np.dot(a_l[k], -(m_diag * a_r[k])))
            if abs(abs(dot) - 1.0) < 0.05:
                signs[i] = float(np.sign(dot))
            else:
                approximate.append(name)
            return True

        if len(toks) >= 2 and toks[-2] == 'rot' and last in axes:
            # free-joint rotation component
            if not _paired_axis_sign('_'.join(toks[:-2]), axes.index(last)):
                if last in rot_flip:             # canonical euler-XYZ
                    signs[i] = -1.0
        elif last == f't{trans_flip}':
            signs[i] = -1.0                      # lateral translation
        elif last in ('tx', 'ty', 'tz'):
            pass                                 # non-lateral translation
        elif last in axes and len(toks) >= 2:
            # ball-joint rotation component (e.g. hip_r_x = coordinate 0)
            if not _paired_axis_sign('_'.join(toks[:-1]), axes.index(last)):
                if last in rot_flip:             # canonical euler-XYZ
                    signs[i] = -1.0
        elif name in axis_of or _swap_lr(name) in axis_of:
            # revolute DOF: sign from the axis pair under the mirror
            a_r = axis_of.get(name)
            a_l = axis_of.get(_swap_lr(name), a_r)
            if a_r is None:
                a_r = a_l
            if a_r is None or a_l is None:
                approximate.append(name)
                continue
            dot = float(np.dot(a_l, -(m_diag * a_r)))
            if abs(abs(dot) - 1.0) < 0.05:
                signs[i] = float(np.sign(dot))
            else:
                approximate.append(name)         # mixed axis: keep +1
        elif _OPENSIM_FLIP_TOKENS & set(toks):
            signs[i] = -1.0                      # OpenSim semantic name
        # else: sagittal coordinate (flexion/extension/angle/...) keeps +1
    return signs, approximate


@dataclass
class MirrorSpec:
    """Channel permutation + sign for the packed input/label arrays.

    ``mirror(x) = x[..., perm] * sign`` — an involution
    (``perm[perm] == id`` and ``sign[perm] * sign == 1``).
    """
    in_perm: np.ndarray
    in_sign: np.ndarray
    lab_perm: np.ndarray
    lab_sign: np.ndarray
    # names whose mirror sign could not be derived exactly (kept at +1)
    approximate_dofs: List[str] = field(default_factory=list)
    unpaired_names: List[str] = field(default_factory=list)

    def mirror_inputs(self, x):
        # cast the sign vector to the batch dtype: a float32 numpy operand
        # would silently promote bf16 feature batches to f32, doubling the
        # activation bandwidth the bf16 tiers exist to save
        return x[..., self.in_perm] * self.in_sign.astype(x.dtype)

    def mirror_labels(self, y):
        return y[..., self.lab_perm] * self.lab_sign.astype(y.dtype)


def _block(perm_units: np.ndarray, unit_sign: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Expand a per-unit permutation into per-channel (unit width =
    len(unit_sign)); the same component signs apply to every unit."""
    w = len(unit_sign)
    n = len(perm_units)
    perm = (perm_units[:, None] * w + np.arange(w)[None, :]).reshape(-1)
    sign = np.tile(unit_sign, n)
    return perm.astype(np.int32), sign.astype(np.float32)


def build_mirror_spec(dof_names: Sequence[str],
                      joint_names: Sequence[str],
                      contact_bodies: Sequence[str],
                      root_history_len: int,
                      lateral_axis: int = 2,
                      joints=None) -> MirrorSpec:
    """Derive the packed-channel mirror transform from skeleton metadata.

    ``joints`` (optional ``SkeletonSpec.joints``) refines revolute-DOF
    signs from their rotation axes; without it, name-based rules apply.
    """
    if not 0 <= lateral_axis <= 2:
        raise ValueError(f'lateral_axis must be 0..2, got {lateral_axis}')
    dof_perm, un_d = _pairing(dof_names)
    dof_sign_self, approx = _dof_signs(dof_names, lateral_axis, joints)
    # sign of channel i after permutation: the value arriving at channel i
    # is dof dof_perm[i], mirrored — so it carries THAT dof's sign. Pair
    # signs are symmetric (a_l·(−M a_r) == a_r·(−M a_l) since M is
    # symmetric), which is exactly the condition for mirror∘mirror == id.
    dof_sign = dof_sign_self[dof_perm]

    polar = _vector_signs(lateral_axis, pseudo=False)
    pseudo = _vector_signs(lateral_axis, pseudo=True)

    jnames = list(joint_names)[:K.NUM_JOINT_CENTERS]
    jnames += [f'_pad_{i}' for i in range(K.NUM_JOINT_CENTERS - len(jnames))]
    joint_perm, un_j = _pairing(jnames)
    body_perm, un_b = _pairing(contact_bodies)

    I = K.InputDataKeys
    per_key_in: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
        I.POS: (dof_perm, dof_sign),
        I.VEL: (dof_perm, dof_sign),
        I.ACC: (dof_perm, dof_sign),
        I.JOINT_CENTERS_IN_ROOT_FRAME: _block(joint_perm, polar),
        I.ROOT_LINEAR_VEL_IN_ROOT_FRAME: (np.arange(3, dtype=np.int32), polar),
        I.ROOT_ANGULAR_VEL_IN_ROOT_FRAME: (np.arange(3, dtype=np.int32), pseudo),
        I.ROOT_LINEAR_ACC_IN_ROOT_FRAME: (np.arange(3, dtype=np.int32), polar),
        I.ROOT_ANGULAR_ACC_IN_ROOT_FRAME: (np.arange(3, dtype=np.int32), pseudo),
        I.ROOT_POS_HISTORY_IN_ROOT_FRAME: _block(
            np.arange(root_history_len, dtype=np.int32), polar),
        # root euler history is euler-XYZ: exact under the mirror with
        # the pseudovector signs (module docstring)
        I.ROOT_EULER_HISTORY_IN_ROOT_FRAME: _block(
            np.arange(root_history_len, dtype=np.int32), pseudo),
    }
    O = K.OutputDataKeys
    wrench_sign = np.concatenate([pseudo, polar])  # [torque(3), force(3)]
    per_key_lab: Dict[str, Tuple[np.ndarray, np.ndarray]] = {
        O.TAU: (dof_perm, dof_sign),
        O.RESIDUAL_WRENCH_IN_ROOT_FRAME: (np.arange(6, dtype=np.int32),
                                          wrench_sign),
        O.COM_ACC_IN_ROOT_FRAME: (np.arange(3, dtype=np.int32), polar),
        O.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME: _block(body_perm, wrench_sign),
        O.GROUND_CONTACT_COPS_IN_ROOT_FRAME: _block(body_perm, polar),
        O.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME: _block(body_perm, pseudo),
        O.GROUND_CONTACT_FORCES_IN_ROOT_FRAME: _block(body_perm, polar),
        O.CONTACT: (body_perm, np.ones(len(body_perm), np.float32)),
    }

    in_lay = input_layout(len(dof_names), root_history_len)
    lab_lay = label_layout(len(dof_names), len(contact_bodies))

    def assemble(layout, table):
        perm_parts, sign_parts, off = [], [], 0
        for key, w in layout:
            p, s = table[key]
            if len(p) != w or len(s) != w:
                raise ValueError(f'{key}: mirror block width {len(p)} != '
                                 f'layout width {w}')
            perm_parts.append(np.asarray(p, np.int64) + off)
            sign_parts.append(np.asarray(s, np.float32))
            off += w
        return (np.concatenate(perm_parts).astype(np.int32),
                np.concatenate(sign_parts))

    in_perm, in_sign = assemble(in_lay, per_key_in)
    lab_perm, lab_sign = assemble(lab_lay, per_key_lab)
    assert [k for k, _ in lab_lay] == LABEL_PACK_ORDER
    return MirrorSpec(in_perm, in_sign, lab_perm, lab_sign,
                      approximate_dofs=approx,
                      unpaired_names=un_d + un_j + un_b)


def spec_from_dataset(ds, lateral_axis: int = 2) -> MirrorSpec:
    """Build the mirror spec from a ``WindowDataset``'s first subject."""
    if not ds.subjects:
        raise ValueError('empty dataset: cannot derive a mirror spec')
    subject = ds.subjects[0]
    joints = None
    try:
        joints = subject.readSkel(0).joints
    except (ValueError, KeyError):
        pass                  # header without a skeleton: name-based rules
    return build_mirror_spec(
        subject.getDofNames(),
        subject.header['joint_names'],
        ds.contact_bodies,
        ds.root_history_len,
        lateral_axis=lateral_axis,
        joints=joints)


@dataclass(frozen=True)
class AugmentDraws:
    """Where an augmented step's draws come from: ``coin(batch, p, device)``
    bool [batch], True with probability ``p`` (mirror that sample), drawn
    first and only with a mirror; ``noise(shape, dtype, device)`` N(0, 1) in
    ``dtype``, drawn second and only with noise."""
    coin: Callable[[int, float, torch.device], torch.Tensor]
    noise: Callable[[Tuple[int, ...], torch.dtype, torch.device], torch.Tensor]


def generator_aug_draws(generator: Optional[torch.Generator],
                        shard: Optional[Tuple[int, int]] = None) -> AugmentDraws:
    """An augmented step's draws from ``generator`` (torch's default one when
    None), on the device of the step's tensors; under data parallelism
    (``shard`` = (rank, world size)) this rank's rows of the global batch's
    draws (``models/common.py::global_rows``)."""
    # imported here: models/ imports this module (the denoiser's augmented
    # step), so a module-level import would make importing this one first
    # a circular import
    from inferbiomechanics_tpu_torch.models.common import global_rows
    return AugmentDraws(
        coin=lambda b, p, device: global_rows(
            lambda s: torch.rand(s, generator=generator, device=device), (b,), shard) < p,
        noise=lambda shape, dtype, device: global_rows(
            lambda s: torch.randn(s, generator=generator, device=device, dtype=dtype),
            shape, shard))


def local_std(x: torch.Tensor, dims) -> torch.Tensor:
    """Population standard deviation of ``x`` over ``dims`` (kept)."""
    return torch.std(x, dim=dims, keepdim=True, correction=0)


class Augmenter:
    """Per-sample mirroring and/or input noise inside a train step.

    The JAX package's ``Augmenter``: with a mirror spec each sample is
    mirrored with probability ``mirror_prob``, its inputs and its packed
    labels together; with ``noise_std`` > 0 each input channel gets Gaussian
    noise of standard deviation ``noise_std`` x that channel's population
    standard deviation over (batch, time), in the inputs' dtype. Labels are
    never noised. The mirror's tables live on ``device`` (a captured step
    reads them there)."""

    def __init__(self, mirror: Optional[MirrorSpec] = None, noise_std: float = 0.0,
                 mirror_prob: float = 0.5, *, device='cpu'):
        if mirror is None and noise_std <= 0.0:
            raise ValueError('Augmenter with no mirror spec and no noise')
        if not 0.0 <= mirror_prob <= 1.0:
            raise ValueError(f'mirror_prob must be in [0,1]: {mirror_prob}')
        self.mirror = mirror
        self.noise_std = float(noise_std)
        self.mirror_prob = float(mirror_prob)
        # the noise scale's statistic; under data parallelism the global
        # batch's (parallel/dist.py::global_std)
        self.std_fn = local_std
        if mirror is not None:
            as_index = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)  # noqa: E731
            as_sign = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
            self._in = (as_index(mirror.in_perm), as_sign(mirror.in_sign))
            self._lab = (as_index(mirror.lab_perm), as_sign(mirror.lab_sign))

    def __call__(self, inputs: torch.Tensor, labels: Optional[torch.Tensor],
                 draws: AugmentDraws) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``inputs`` [B, T, C_in], ``labels`` [B, T_out, C_lab] (packed; None
        or zero-width passes through) -> the augmented pair."""
        if self.mirror is not None:
            coin = draws.coin(inputs.shape[0], self.mirror_prob, inputs.device)[:, None, None]
            perm, sign = self._in
            inputs = torch.where(coin, inputs[..., perm] * sign.to(inputs.dtype), inputs)
            if labels is not None and labels.shape[-1]:
                perm, sign = self._lab
                labels = torch.where(coin, labels[..., perm] * sign.to(labels.dtype), labels)
        if self.noise_std > 0.0:
            std = self.std_fn(inputs, (0, 1))
            inputs = inputs + (self.noise_std * std) * draws.noise(
                tuple(inputs.shape), inputs.dtype, inputs.device)
        return inputs, labels


def augmenter_from_config(config, train_ds, logger=None, device='cpu') -> Optional[Augmenter]:
    """The Augmenter the train loops share, from ``--augment-mirror`` /
    ``--augment-noise-std`` / ``--mirror-lateral-axis``, its tables on
    ``device``; ``None`` when augmentation is off. Warns and logs in the JAX
    package's words."""
    if not (config.augment_mirror or config.augment_noise_std > 0):
        return None
    spec = None
    if config.augment_mirror:
        spec = spec_from_dataset(train_ds, lateral_axis=config.mirror_lateral_axis)
        if logger is not None:
            if spec.unpaired_names:
                logger.warning('augment-mirror: no left/right partner for '
                               '%s — those channels mirror onto themselves',
                               spec.unpaired_names)
            if spec.approximate_dofs:
                logger.warning('augment-mirror: revolute axes of %s do not '
                               'mirror cleanly; their sign stays +1',
                               spec.approximate_dofs)
    if logger is not None:
        logger.info('augmentation: mirror=%s noise_std=%g',
                    config.augment_mirror, config.augment_noise_std)
    return Augmenter(mirror=spec, noise_std=config.augment_noise_std, device=device)


def maybe_augment(augment: Optional[Augmenter], inputs: torch.Tensor,
                  labels: Optional[torch.Tensor], draws: Optional[AugmentDraws]):
    """The train steps' hook: ``(inputs, labels)`` augmented from ``draws``
    (the augmentation generator's, which no other draw shares), or as they
    are when ``augment`` is None."""
    if augment is None:
        return inputs, labels
    return augment(inputs, labels, draws)


def _mirror(x: torch.Tensor, perm: np.ndarray, sign: np.ndarray) -> torch.Tensor:
    idx = torch.as_tensor(np.asarray(perm, np.int64), device=x.device)
    return x[..., idx] * torch.as_tensor(sign, device=x.device).to(x.dtype)


def mirror_outputs(spec: MirrorSpec, lab_offsets, outputs: dict) -> dict:
    """(Un)mirror a model-output dict of tensors through the packed-label
    mirror.

    Each output key's channels map onto the same key's channels under the
    mirror (the left/right contact-body swap stays within each group), so
    packing the dict into the label layout, applying the involution and
    slicing again is exact. Missing keys (models without the extra heads)
    contribute zeros that never leave their own channel groups.
    """
    ref = next(iter(outputs.values()))
    packed = ref.new_zeros((*ref.shape[:-1], len(spec.lab_perm)))
    for k, v in outputs.items():
        o, w = lab_offsets[k]
        packed[..., o:o + w] = v
    m = _mirror(packed, spec.lab_perm, spec.lab_sign)
    return {k: m[..., lab_offsets[k][0]:lab_offsets[k][0] + lab_offsets[k][1]]
            for k in outputs}


def tta_average(spec: MirrorSpec, lab_offsets, forward_fn):
    """Symmetrize a forward on torch tensors whose model input is its last
    positional argument: returns g(*args) = (f(..., x) + unmirror(f(...,
    mirror(x)))) / 2, two forwards for each call."""

    def symmetrized(*args):
        o1 = forward_fn(*args)
        o2 = mirror_outputs(
            spec, lab_offsets,
            forward_fn(*args[:-1], _mirror(args[-1], spec.in_perm, spec.in_sign)))
        return {k: (o1[k] + o2[k]) * 0.5 for k in o1}

    return symmetrized


def make_tta_eval_step(model, lab_offsets, loss_config, spec: MirrorSpec):
    """``eval_step(state, x, y) -> (outputs, metrics)`` with mirror test-time
    averaging: outputs = (f(x) + unmirror(f(mirror(x)))) / 2 through the
    model's eval forward (two forwards, each through its kernel where it has
    one), scored with the standard metrics; a drop-in for
    ``train.step.make_eval_step``."""
    forward = tta_average(spec, lab_offsets, model)

    @torch.no_grad()
    def tta_eval(state, x: torch.Tensor, y: torch.Tensor):
        model.eval()
        outputs = forward(x)
        _, metrics = loss_and_metrics(outputs, unpack(y, lab_offsets), loss_config)
        return outputs, metrics

    return tta_eval
