"""Spatial (rigid-body) algebra on ``[..., 3]`` tensors.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/spatial.py``: the cross
product matrix and its inverse, intrinsic euler-XYZ and axis-angle rotation
matrices, DART's ``dAdInvT`` wrench transform, and applying an isometry
(R, p) or its inverse to points. Every function broadcasts over leading
dimensions and is differentiable by ``torch.func`` in both modes.
"""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def unskew(m: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`skew` for (approximately) antisymmetric matrices."""
    return torch.stack([m[..., 2, 1] - m[..., 1, 2],
                        m[..., 0, 2] - m[..., 2, 0],
                        m[..., 1, 0] - m[..., 0, 1]], dim=-1) * 0.5


def euler_xyz_to_matrix(angles: torch.Tensor) -> torch.Tensor:
    """Intrinsic XYZ euler angles [..., 3] -> rotation matrices [..., 3, 3],
    R = Rx(x) Ry(y) Rz(z)."""
    cx, cy, cz = (torch.cos(angles[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(angles[..., i]) for i in range(3))
    r00 = cy * cz
    r01 = -cy * sz
    r02 = sy
    r10 = cx * sz + sx * sy * cz
    r11 = cx * cz - sx * sy * sz
    r12 = -sx * cy
    r20 = sx * sz - cx * sy * cz
    r21 = sx * cz + cx * sy * sz
    r22 = cx * cy
    return torch.stack([
        torch.stack([r00, r01, r02], dim=-1),
        torch.stack([r10, r11, r12], dim=-1),
        torch.stack([r20, r21, r22], dim=-1),
    ], dim=-2)


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues: unit axis [..., 3] and angle [...] -> [..., 3, 3]."""
    K = skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device)
    s = torch.sin(angle)[..., None, None]
    c = torch.cos(angle)[..., None, None]
    return eye + s * K + (1.0 - c) * (K @ K)


def matvec(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R [..., 3, 3] times x [..., 3], broadcast over leading dimensions."""
    return (R @ x.unsqueeze(-1)).squeeze(-1)


def rmatvec(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rᵀ x for R [..., 3, 3] and x [..., 3]."""
    return (R.transpose(-1, -2) @ x.unsqueeze(-1)).squeeze(-1)


def dAdInvT(R: torch.Tensor, p: torch.Tensor, wrench: torch.Tensor) -> torch.Tensor:
    """Transform a spatial wrench [n; f] from the frame T=(R,p) is expressed
    in, into the frame T maps to (DART's ``math::dAdInvT``):
        n' = Rᵀ (n - p × f),  f' = Rᵀ f
    """
    n, f = wrench[..., :3], wrench[..., 3:]
    return torch.cat([rmatvec(R, n - torch.linalg.cross(p, f)), rmatvec(R, f)], dim=-1)


def transform_point(R: torch.Tensor, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply the isometry (R, p) to points [..., 3]."""
    return matvec(R, x) + p


def inverse_transform_point(R: torch.Tensor, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply the inverse of (R, p): Rᵀ (x - p)."""
    return rmatvec(R, x - p)
