"""Analytical physics baseline: no learned parameters.

PyTorch counterpart of ``inferbiomechanics_tpu/models/analytical.py``
(reference ``AnalyticalBaseline.py``). A frame's COM "acceleration" is
a_com − g from the skeleton state; a contact body is in contact when its
world height is below 0.1 m; the (per-kg) total force is split equally over
the contacting bodies and rotated into the root frame; the CoPs are the
contact bodies' COMs in the root frame; a body's wrench is
dAdInvT(T_wr, [cop_w × F_w; F_w]); the tau, contact, COM-acc and residual
outputs are zeros. When no body is in contact every output is zero.

Where the JAX package ``vmap``s a one-frame function over B·T frames, the
port computes all frames of a ``[B, T, C]`` batch at once through the
skeleton functions of ``ops/skeleton.py``, with each window's subject's
skeleton parameters broadcast over its frames. There is no Python branch on
a tensor and no copy from the host, so the forward can be captured in a CUDA
graph.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.ops.skeleton import (
    CompiledSkeleton, compile_skeleton, skeleton_param_stack,
    skeletons_structurally_equal, with_params,
)
from inferbiomechanics_tpu_torch.ops.spatial import (
    dAdInvT, inverse_transform_point, rmatvec,
)

CONTACT_HEIGHT_THRESHOLD = 0.1  # meters (ref :66)


def analytical_forward(skel: CompiledSkeleton, contact_body_indices: List[int],
                       q: torch.Tensor, dq: torch.Tensor, ddq: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """The analytical prediction of every frame of ``q`` / ``dq`` / ``ddq``
    [..., D]: each output [..., width]."""
    nb = len(contact_body_indices)
    Rs, ps = skel.fk(q)
    com_acc = skel.com_acceleration(q, dq, ddq) - skel.gravity            # ref :59

    # body COMs from the FK above (body_coms_world(q) would run FK again)
    body_coms = skel.coms_of(Rs, ps)
    heights = torch.stack([ps[..., b, 1] for b in contact_body_indices], dim=-1)
    contact = (heights < CONTACT_HEIGHT_THRESHOLD).to(q.dtype)           # ref :62-68
    n_contact = contact.sum(-1, keepdim=True)
    safe_n = torch.clamp_min(n_contact, 1.0)

    world_forces = contact.unsqueeze(-1) * (com_acc / safe_n).unsqueeze(-2)   # [..., nb, 3]
    R_wr, p_wr = Rs[..., 0:1, :, :], ps[..., 0:1, :]
    root_forces = rmatvec(R_wr, world_forces)
    world_cops = torch.stack([body_coms[..., b, :] for b in contact_body_indices], dim=-2)
    root_cops = inverse_transform_point(R_wr, p_wr, world_cops)

    moments = torch.linalg.cross(world_cops, world_forces)
    world_wrenches = torch.cat([moments, world_forces], dim=-1)
    body_wrenches = dAdInvT(R_wr, p_wr, world_wrenches)

    gate = (n_contact > 0).to(q.dtype)
    zeros = q.new_zeros
    lead = q.shape[:-1]
    return {
        K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME: gate * root_forces.flatten(-2),
        K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME: gate * root_cops.flatten(-2),
        K.OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME: zeros(lead + (3 * nb,)),
        K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME: gate * body_wrenches.flatten(-2),
        K.OutputDataKeys.RESIDUAL_WRENCH_IN_ROOT_FRAME: zeros(lead + (6,)),
        K.OutputDataKeys.CONTACT: zeros(lead + (nb,)),
        K.OutputDataKeys.COM_ACC_IN_ROOT_FRAME: zeros(lead + (3,)),
        K.OutputDataKeys.TAU: torch.zeros_like(q),
    }


class SubjectSkeletons:
    """A dataset's skeletons on ``device`` in ``dtype``: subject 0's compiled
    skeleton (the standard skeleton when the dataset carries none), the
    contact bodies' indices, and, when every subject carries a structurally
    equal skeleton (more than one), the per-subject parameter stack."""

    def __init__(self, ds: WindowDataset, device, dtype=torch.float32):
        specs = [sk for sk in getattr(ds, 'skeletons', []) if sk is not None]
        if not specs:
            from inferbiomechanics_tpu_torch.data.synthetic import standard_skeleton
            specs = [standard_skeleton()]
        self.skel = compile_skeleton(specs[0], device, dtype)
        self.param_stack: Optional[Dict[str, torch.Tensor]] = None
        if (len(specs) == len(ds.subject_paths) and len(specs) > 1
                and all(skeletons_structurally_equal(specs[0], s) for s in specs[1:])):
            self.param_stack = skeleton_param_stack(specs, device, dtype)
        self.contact_indices = [self.skel.body_index[b] for b in ds.contact_bodies
                                if b in self.skel.body_index]
        self.device = torch.device(device)

    def for_rows(self, subject_indices: Optional[torch.Tensor], frames: bool
                 ) -> CompiledSkeleton:
        """The skeleton of each window ``subject_indices`` [B] names (its
        parameters a row a window, broadcast over the window's frames when
        ``frames``), or subject 0's without a stack or indices."""
        if self.param_stack is None or subject_indices is None:
            return self.skel
        rows = {k: v[subject_indices] for k, v in self.param_stack.items()}
        if frames:
            rows = {k: v.unsqueeze(1) for k, v in rows.items()}
        return with_params(self.skel, rows)


def kinematics(ds: WindowDataset, x: torch.Tensor):
    """(q, dq, ddq) of the packed inputs ``x`` [..., C]."""
    o_pos, w_pos = ds.in_offsets[K.InputDataKeys.POS]
    o_vel, _ = ds.in_offsets[K.InputDataKeys.VEL]
    o_acc, _ = ds.in_offsets[K.InputDataKeys.ACC]
    return (x[..., o_pos:o_pos + w_pos], x[..., o_vel:o_vel + w_pos],
            x[..., o_acc:o_acc + w_pos])


def make_analytical_fn(ds: WindowDataset, device='cuda', dtype=torch.float32):
    """Build ``predict(packed_inputs [B, T, C], subject_indices=None) ->
    outputs`` (each [B, T, width]) on ``device`` in ``dtype``.

    Every subject shares the standard skeleton's topology, but each
    subject's model is scaled: when every subject carries a skeleton, each
    window takes its subject's parameters from the stack by
    ``subject_indices`` ([B] integers). The force outputs are per kg."""
    skels = SubjectSkeletons(ds, device, dtype)

    def predict(packed_inputs, subject_indices=None) -> Dict[str, torch.Tensor]:
        x = torch.as_tensor(packed_inputs, device=skels.device).to(dtype)
        if subject_indices is not None:
            subject_indices = torch.as_tensor(subject_indices, device=skels.device)
        sk = skels.for_rows(subject_indices, frames=True)
        return analytical_forward(sk, skels.contact_indices, *kinematics(ds, x))

    predict.skeletons = skels
    return predict
