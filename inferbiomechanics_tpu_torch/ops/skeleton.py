"""Batched rigid-body skeleton functions: FK, COM dynamics, inverse dynamics.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/skeleton.py``'s
:class:`CompiledSkeleton` (the unrolled FK; the vectorized FK is on
ROADMAP.md's not-to-port list): a set of pure functions over a
``SkeletonSpec``'s parameter tensors. Velocity and acceleration quantities
come from nested ``torch.func.jvp`` through forward kinematics, and inverse
dynamics is Lagrangian, every derivative by autodiff:

    tau = d/dt(∂T/∂q̇) − ∂T/∂q + ∂V/∂q − Q_ext

Where the JAX package writes each function for one frame and ``vmap``s it,
these take ``q`` of any leading shape ``[..., D]`` (frames) and compute all
frames at once. The frames are independent, so the gradient of the SUM of a
per-frame energy over the frames is each frame's own gradient, and no
``vmap`` batching rule is needed. The parameter tensors are either one
skeleton's (``[nb]``, ``[nb, 3]``, ...) or, through :func:`with_params`, a
row a frame (``[..., nb]``, ...) gathered from a per-subject stack.

Every constant a function needs is made on the skeleton's device when it is
compiled, so that a call copies nothing from the host and can be captured
in a CUDA graph.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.func import grad, jvp

from inferbiomechanics_tpu_torch.data.b3d import SkeletonSpec
from inferbiomechanics_tpu_torch.ops.spatial import (
    axis_angle_to_matrix, euler_xyz_to_matrix, matvec, rmatvec, unskew,
)
from inferbiomechanics_tpu_torch.ops.spline import NaturalCubicSpline

GRAVITY = (0.0, -9.81, 0.0)

_CANONICAL_AXES = np.eye(3)
_JOINT_DOFS = {'free': 6, 'ball': 3, 'revolute': 1, 'fixed': 0}

PARAM_FIELDS = ('masses', 'coms', 'inertias', 'joint_translations',
                'joint_axes', 'joint_orientations', 'child_translations',
                'child_orientations', 'joint_rot_axes', 'coupling_params')


def _nonzero(vals) -> bool:
    return any(abs(float(v)) > 1e-12 for v in vals)


class CompiledSkeleton:
    """Pure-function rigid-body model compiled from a SkeletonSpec, its
    parameter tensors on ``device`` in ``dtype``.

    The joint loop is unrolled in Python (a dozen joints): straight-line
    tensor code a frame batch. Every public function takes ``q`` / ``dq`` /
    ``ddq`` as ``[..., D]`` tensors of the skeleton's dtype.
    """

    def __init__(self, spec: SkeletonSpec, device='cpu', dtype=torch.float32):
        self.spec = spec
        self.device, self.dtype = torch.device(device), dtype
        self.num_bodies = len(spec.bodies)
        self.num_joints = len(spec.joints)

        def t(v):
            return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=self.device)

        self.masses = t([b.mass for b in spec.bodies])
        self.total_mass = float(np.sum([b.mass for b in spec.bodies]))
        self.coms = t([b.com for b in spec.bodies])
        # inertia [Ixx,Iyy,Izz,Ixy,Ixz,Iyz] -> full 3x3 about COM, body frame
        inertias = []
        for b in spec.bodies:
            ixx, iyy, izz, ixy, ixz, iyz = b.inertia
            inertias.append([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
        self.inertias = t(inertias)
        self.joint_translations = t([j.translation for j in spec.joints])
        self.joint_axes = t([j.axis for j in spec.joints])
        # OpenSim offset frames, ordered rotation axes and coupling
        # parameters: the values live in tensors (per-subject scalable); which
        # transforms exist at all is structural, decided here from `spec`
        self.joint_orientations = t([j.orientation for j in spec.joints])
        self.child_translations = t([j.child_translation for j in spec.joints])
        self.child_orientations = t([j.child_orientation for j in spec.joints])
        self.joint_rot_axes = t([j.rot_axes if j.rot_axes is not None else _CANONICAL_AXES
                                 for j in spec.joints])
        self._has_pre_rot = [_nonzero(j.orientation) for j in spec.joints]
        self._has_child_off = [_nonzero(j.child_translation) or _nonzero(j.child_orientation)
                               for j in spec.joints]
        self._noncanon_rot = [j.rot_axes is not None for j in spec.joints]
        # couplings: structural entries (kind, axis tensor, fn type,
        # (param offset, param count), spline or None) over one flat
        # parameter vector, so that scaled spline knots stack per subject
        self._couplings: List[List[tuple]] = []
        flat_params: List[float] = []
        for j in spec.joints:
            entries = []
            for c in j.couplings:
                fn = c['fn']
                off_p = len(flat_params)
                spline = None
                if fn['type'] == 'spline':
                    spline = NaturalCubicSpline(fn['x'], device=self.device, dtype=dtype)
                    flat_params.extend(float(v) for v in fn['y'])
                elif fn['type'] == 'linear':
                    flat_params.extend(float(v) for v in fn['coeffs'])
                elif fn['type'] == 'constant':
                    flat_params.append(float(fn['value']))
                elif fn['type'] != 'identity':
                    raise ValueError(f"unknown coupling fn type {fn['type']!r} on "
                                     f"joint {j.name}")
                entries.append((c['kind'], t(c['axis']), fn['type'],
                                (off_p, len(flat_params) - off_p), spline))
            self._couplings.append(entries)
        self.coupling_params = t(flat_params)
        self.dof_offsets: List[int] = []
        off = 0
        for j in spec.joints:
            self.dof_offsets.append(off)
            off += _JOINT_DOFS[j.type]
        self.num_dofs = off
        self.body_names = [b.name for b in spec.bodies]
        self.body_index = {b.name: i for i, b in enumerate(spec.bodies)}
        self.gravity = t(GRAVITY)

    # -- joint-local transforms ------------------------------------------

    def _coupling_fn(self, entry, q_scalar: torch.Tensor) -> torch.Tensor:
        """One coupling function at the joint coordinate ``q_scalar`` [...]."""
        _kind, _axis, fn_type, (p_off, p_len), spline = entry
        if fn_type == 'identity':
            return q_scalar
        p = self.coupling_params[..., p_off:p_off + p_len]
        if fn_type == 'linear':
            return p[..., 0] * q_scalar + p[..., 1]
        if fn_type == 'constant':
            return p[..., 0]
        return spline(q_scalar, y=p)  # 'spline'

    def _ordered_rotation(self, ji: int, angles: List[torch.Tensor]) -> torch.Tensor:
        """Rotations about the joint's ordered axes, composed (OpenSim
        CustomJoint); canonical axes are euler-XYZ."""
        if not self._noncanon_rot[ji]:
            return euler_xyz_to_matrix(torch.stack(angles, dim=-1))
        axes = self.joint_rot_axes[..., ji, :, :]
        R = axis_angle_to_matrix(axes[..., 0, :], angles[0])
        for k in (1, 2):
            R = R @ axis_angle_to_matrix(axes[..., k, :], angles[k])
        return R

    def _joint_local(self, ji: int, joint, q: torch.Tensor):
        """(Rj, tj): the joint frame's motion within the parent offset frame
        (translation expressed in the parent offset frame)."""
        off = self.dof_offsets[ji]
        zero3 = q.new_zeros(q.shape[:-1] + (3,))
        if joint.type in ('free', 'ball'):
            R = self._ordered_rotation(ji, [q[..., off], q[..., off + 1], q[..., off + 2]])
            return R, (q[..., off + 3:off + 6] if joint.type == 'free' else zero3)
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        if joint.type == 'revolute':
            entries = self._couplings[ji]
            if not entries:
                return axis_angle_to_matrix(self.joint_axes[..., ji, :], q[..., off]), zero3
            Rj, tj = eye, zero3
            for e in entries:
                val = self._coupling_fn(e, q[..., off])
                axis = e[1]
                if e[0] == 'rotation':
                    Rj = Rj @ axis_angle_to_matrix(axis, val)
                else:
                    tj = tj + axis * val.unsqueeze(-1)
            return Rj, tj
        return eye, zero3  # fixed

    def _joint_transform(self, ji: int, joint, q: torch.Tensor):
        """Parent-body -> child-body transform, X_parent_offset ∘ X_joint ∘
        X_child_offset⁻¹, as (R [..., 3, 3], t [..., 3])."""
        Rj, tj = self._joint_local(ji, joint, q)
        t_total = tj
        if self._has_child_off[ji]:
            R_co = euler_xyz_to_matrix(self.child_orientations[..., ji, :])
            Rj = Rj @ R_co.transpose(-1, -2)
            t_total = tj - matvec(Rj, self.child_translations[..., ji, :])
        R_total = Rj
        if self._has_pre_rot[ji]:
            R_po = euler_xyz_to_matrix(self.joint_orientations[..., ji, :])
            R_total = R_po @ Rj
            t_total = matvec(R_po, t_total)
        batch = q.shape[:-1]
        return (R_total.expand(batch + (3, 3)),
                (self.joint_translations[..., ji, :] + t_total).expand(batch + (3,)))

    # -- kinematics ----------------------------------------------------------

    def fk(self, q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """World transforms of every body: (R [..., nb, 3, 3], p [..., nb, 3])."""
        Rs = [None] * self.num_bodies
        ps = [None] * self.num_bodies
        for ji, joint in enumerate(self.spec.joints):
            Rj, tj = self._joint_transform(ji, joint, q)
            if joint.parent_body < 0:        # the world frame is the identity
                Rs[joint.child_body], ps[joint.child_body] = Rj, tj
            else:
                Rp, pp = Rs[joint.parent_body], ps[joint.parent_body]
                Rs[joint.child_body] = Rp @ Rj
                ps[joint.child_body] = pp + matvec(Rp, tj)
        return torch.stack(Rs, dim=-3), torch.stack(ps, dim=-2)

    def joint_world_positions(self, q: torch.Tensor) -> torch.Tensor:
        """World position of every joint center [..., nj, 3]."""
        Rs, ps = self.fk(q)
        out = []
        for ji, joint in enumerate(self.spec.joints):
            t = self.joint_translations[..., ji, :]
            if joint.parent_body < 0:
                base = t.expand(q.shape[:-1] + (3,))
                if joint.type == 'free':
                    off = self.dof_offsets[ji]
                    tq = q[..., off + 3:off + 6]
                    if self._has_pre_rot[ji]:
                        tq = matvec(euler_xyz_to_matrix(self.joint_orientations[..., ji, :]), tq)
                    base = base + tq
                out.append(base)
            else:
                out.append(ps[..., joint.parent_body, :]
                           + matvec(Rs[..., joint.parent_body, :, :], t))
        return torch.stack(out, dim=-2)

    def coms_of(self, Rs: torch.Tensor, ps: torch.Tensor) -> torch.Tensor:
        """World COM of every body [..., nb, 3] from its FK (Rs, ps)."""
        return ps + matvec(Rs, self.coms)

    def body_coms_world(self, q: torch.Tensor) -> torch.Tensor:
        """World COM of every body [..., nb, 3]."""
        return self.coms_of(*self.fk(q))

    def com(self, q: torch.Tensor) -> torch.Tensor:
        """Whole-body COM in the world frame [..., 3]."""
        total = self.total_mass
        if torch.is_tensor(total):
            total = total.unsqueeze(-1)
        return (self.masses.unsqueeze(-1) * self.body_coms_world(q)).sum(-2) / total

    def com_velocity(self, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
        return jvp(self.com, (q,), (dq,))[1]

    def com_acceleration(self, q: torch.Tensor, dq: torch.Tensor,
                         ddq: torch.Tensor) -> torch.Tensor:
        """COM linear acceleration a = J̇(q,q̇)q̇ + J(q)q̈, by nested jvp."""
        def vel(q_, dq_):
            return jvp(self.com, (q_,), (dq_,))[1]
        return jvp(vel, (q, dq), (dq, ddq))[1]

    def body_velocities(self, q: torch.Tensor, dq: torch.Tensor):
        """Per body: COM linear velocity [..., nb, 3], world angular velocity
        [..., nb, 3], and the rotations [..., nb, 3, 3], from one jvp
        through FK."""
        def pose(q_):
            Rs, ps = self.fk(q_)
            return Rs, self.coms_of(Rs, ps)
        (Rs, _coms), (dRs, dcoms) = jvp(pose, (q,), (dq,))
        omega_world = unskew(dRs @ Rs.transpose(-1, -2))
        return dcoms, omega_world, Rs

    # -- energies ------------------------------------------------------------

    def kinetic_energy(self, q: torch.Tensor, dq: torch.Tensor) -> torch.Tensor:
        """[...]: each frame's kinetic energy."""
        v, w_world, Rs = self.body_velocities(q, dq)
        w_body = rmatvec(Rs, w_world)
        trans = 0.5 * (self.masses * (v * v).sum(-1)).sum(-1)
        rot = 0.5 * (w_body * matvec(self.inertias, w_body)).sum((-1, -2))
        return trans + rot

    def potential_energy(self, q: torch.Tensor) -> torch.Tensor:
        """[...]: each frame's potential energy in gravity."""
        h = self.body_coms_world(q)
        return -(self.masses.unsqueeze(-1) * self.gravity * h).sum((-1, -2))

    # -- inverse dynamics ----------------------------------------------------

    def inverse_dynamics(self, q: torch.Tensor, dq: torch.Tensor, ddq: torch.Tensor,
                         ext_world_wrenches: Optional[Dict[int, torch.Tensor]] = None
                         ) -> torch.Tensor:
        """Generalized forces tau [..., D] under which the motion (q, dq, ddq)
        holds in gravity and the external wrenches.

        ``ext_world_wrenches`` maps a body index to a [..., 6] wrench [n; f]
        expressed in the WORLD frame about the WORLD origin, applied to that
        body."""
        def kinetic(q_, dq_):
            return self.kinetic_energy(q_, dq_).sum()

        dT_ddq = grad(kinetic, argnums=1)
        # d/dt of the generalized momentum along the trajectory
        dmom_dt = jvp(dT_ddq, (q, dq), (dq, ddq))[1]
        dT_dq = grad(kinetic, argnums=0)(q, dq)
        dV_dq = grad(lambda q_: self.potential_energy(q_).sum())(q)
        tau = dmom_dt - dT_dq + dV_dq
        if ext_world_wrenches:
            coms = self.body_coms_world(q)

            def power(dq_):
                v, w_world, _Rs = self.body_velocities(q, dq_)
                total = 0.0
                for bi, wrench in ext_world_wrenches.items():
                    n, f = wrench[..., :3], wrench[..., 3:]
                    w = w_world[..., bi, :]
                    # velocity of the body-fixed point at the world origin
                    v_origin = v[..., bi, :] + torch.linalg.cross(w, -coms[..., bi, :])
                    total = total + (n * w).sum(-1) + (f * v_origin).sum(-1)
                return total.sum()
            tau = tau - grad(power)(dq)
        return tau

    def inverse_dynamics_from_predictions(self, q: torch.Tensor, dq: torch.Tensor,
                                          ddq: torch.Tensor,
                                          contact_body_indices: List[int],
                                          root_wrenches: torch.Tensor) -> torch.Tensor:
        """``getInverseDynamicsFromPredictions``: the contact wrenches
        [..., 6 * contacts] arrive in the ROOT frame about the root origin, as
        the models predict them; they are moved to the world and ID runs."""
        Rs, ps = self.fk(q)
        R_wr, p_wr = Rs[..., 0, :, :], ps[..., 0, :]   # body 0 is the root (pelvis)
        ext = {}
        for i, bi in enumerate(contact_body_indices):
            w = root_wrenches[..., 6 * i:6 * i + 6]
            # inverse of dAdInvT: n_w = R n_r + p × (R f_r), f_w = R f_r
            f_w = matvec(R_wr, w[..., 3:])
            n_w = matvec(R_wr, w[..., :3]) + torch.linalg.cross(p_wr, f_w)
            ext[bi] = torch.cat([n_w, f_w], dim=-1)
        return self.inverse_dynamics(q, dq, ddq, ext)


def compile_skeleton(spec: SkeletonSpec, device='cpu', dtype=torch.float32) -> CompiledSkeleton:
    return CompiledSkeleton(spec, device, dtype)


# ---------------------------------------------------------------------------
# Per-subject skeleton parameters
# ---------------------------------------------------------------------------
# A dataset carries one SCALED model a subject: the same topology and joint
# types, other masses / COMs / inertias / offsets. Those are the parameter
# tensors above, so a batch gathers a row a frame from a per-subject stack
# while the joint structure stays fixed.

def _joint_structure(j) -> tuple:
    """Everything FK branches on (values live in tensors): topology, which
    offset transforms exist, the rotation-axis convention, and the
    coupling-function signatures (the spline abscissae are structural; the
    ordinates are per-subject parameters)."""
    return (j.name, j.type, j.parent_body, j.child_body,
            _nonzero(j.orientation),
            _nonzero(j.child_translation) or _nonzero(j.child_orientation),
            j.rot_axes is not None,
            tuple((c['kind'], c['fn']['type'],
                   tuple(c['fn'].get('x', ())),
                   len(c['fn'].get('y', ())) or len(c['fn'].get('coeffs', ())))
                  for c in j.couplings))


def skeletons_structurally_equal(a: SkeletonSpec, b: SkeletonSpec) -> bool:
    return ([_joint_structure(j) for j in a.joints]
            == [_joint_structure(j) for j in b.joints]
            and [x.name for x in a.bodies] == [x.name for x in b.bodies])


def skeleton_param_stack(specs: List[SkeletonSpec], device='cpu',
                         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The per-subject parameter tensors stacked [S, ...] on ``device``;
    the skeletons must share their structure (ValueError otherwise)."""
    base = specs[0]
    for i, s in enumerate(specs[1:], 1):
        if not skeletons_structurally_equal(base, s):
            raise ValueError(f'skeleton {i} differs structurally from skeleton 0 — '
                             f'per-subject batching needs shared topology')
    compiled = [CompiledSkeleton(s, device, dtype) for s in specs]
    return {f: torch.stack([getattr(c, f) for c in compiled]) for f in PARAM_FIELDS}


def with_params(skel: CompiledSkeleton,
                arrays: Dict[str, torch.Tensor]) -> CompiledSkeleton:
    """A shallow copy of ``skel`` with other parameter tensors: one
    skeleton's, or rows [..., ...] a frame; the structure stays ``skel``'s.
    The total mass becomes a tensor, each row's own."""
    out = copy.copy(skel)
    for f in PARAM_FIELDS:
        setattr(out, f, arrays[f])
    out.total_mass = arrays['masses'].sum(-1)
    return out
