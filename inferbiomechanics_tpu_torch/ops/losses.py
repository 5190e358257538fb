"""Core regression-loss and metric helpers.

PyTorch counterpart of ``inferbiomechanics_tpu/ops/losses.py``, with the
same names, shapes and ``ValueError``s:

- :func:`squared_diff_mean_vector`: per-channel MSE over (batch, time);
- :func:`mask_by_threes`: per-3-vector gate, computed without gradient;
- :func:`mean_norm_error`: norm error of the **last frame only**;
- :func:`com_acc_error`: norm error of the summed left + right force.
"""

from __future__ import annotations

import torch


def _check_3d_same_shape(output_tensor: torch.Tensor, label_tensor: torch.Tensor) -> None:
    if output_tensor.shape != label_tensor.shape:
        raise ValueError('Output and label tensors must have the same shape')
    if output_tensor.ndim != 3:
        raise ValueError('Output and label tensors must be 3-dimensional')
    if output_tensor.numel() == 0:
        raise ValueError('Output and label tensors must not be empty')


def squared_diff_mean_vector(output_tensor: torch.Tensor,
                             label_tensor: torch.Tensor) -> torch.Tensor:
    """Per-channel MSE, averaged over (batch, time); returns a (C,) vector."""
    _check_3d_same_shape(output_tensor, label_tensor)
    diff = output_tensor - label_tensor
    return (diff * diff).mean(dim=(0, 1))


@torch.no_grad()
def mask_by_threes(tensor: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Per-3-vector gating mask: 1.0 where the 3-vector's norm > threshold,
    broadcast back to the input shape; carries no gradient."""
    if tensor.ndim != 3:
        raise ValueError('Mask tensor must be 3-dimensional')
    if tensor.numel() == 0:
        raise ValueError('Mask tensor must not be empty')
    if tensor.shape[-1] % 3 != 0:
        raise ValueError('Mask tensor must have a final dimension divisible by 3')
    b, t, c = tensor.shape
    norms = torch.linalg.vector_norm(tensor.reshape(b, t, c // 3, 3), dim=-1)
    mask = (norms > threshold).to(tensor.dtype)
    return mask[..., None].expand(b, t, c // 3, 3).reshape(b, t, c)


def mean_norm_error(output_tensor: torch.Tensor, label_tensor: torch.Tensor,
                    vec_size: int = 3) -> torch.Tensor:
    """Mean (over batch and vector groups) norm of LAST-FRAME error vectors."""
    _check_3d_same_shape(output_tensor, label_tensor)
    if output_tensor.shape[-1] % vec_size != 0:
        raise ValueError('Tensors must have a final dimension divisible by vec_size='
                         + str(vec_size))
    b, t, c = output_tensor.shape
    diffs = (output_tensor - label_tensor).reshape(b, t, c // vec_size, vec_size)
    return torch.linalg.vector_norm(diffs[:, -1:, :, :], dim=3).mean()


def com_acc_error(output_force_tensor: torch.Tensor,
                  label_force_tensor: torch.Tensor) -> torch.Tensor:
    """Norm error of the summed left + right contact-force 3-vectors (final
    dimension exactly 6)."""
    _check_3d_same_shape(output_force_tensor, label_force_tensor)
    if output_force_tensor.shape[-1] != 6:
        raise ValueError('Output and label tensors must have a 6 dimensional final dimension')
    out_sum = output_force_tensor[:, :, :3] + output_force_tensor[:, :, 3:]
    lab_sum = label_force_tensor[:, :, :3] + label_force_tensor[:, :, 3:]
    return mean_norm_error(out_sum, lab_sum, vec_size=3)
