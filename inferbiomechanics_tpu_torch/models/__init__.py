"""Model registry / factory.

PyTorch counterpart of ``inferbiomechanics_tpu/models/__init__.py``: the
feedforward model, GroundLink, the transformer and the diffusion denoiser.
The analytical baseline has no learnable parameters and is not built here,
as in the JAX package: ``models/analytical.py::make_analytical_fn`` builds
it.
"""

from typing import Optional, Sequence

import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models.common import (
    output_head_size, pack_inputs, slice_output_heads,
)
from inferbiomechanics_tpu_torch.models.diffusion import DiffusionDenoiser
from inferbiomechanics_tpu_torch.models.feedforward import FeedForwardBaseline
from inferbiomechanics_tpu_torch.models.groundlink import Groundlink
from inferbiomechanics_tpu_torch.models.transformer import TransformerRegressor

MODEL_TYPES = ('analytical', 'feedforward', 'groundlink', 'transformer', 'diffusion')


def get_model(model_type: str,
              *,
              num_dofs: int,
              num_contact_bodies: int,
              history_len: int,
              stride: int,
              root_history_len: int,
              output_data_format: str = 'last_frame',
              activation: str = 'sigmoid',
              hidden_dims: Sequence[int] = (512, 512),
              batchnorm: bool = False,
              dropout: bool = False,
              dropout_prob: float = 0.0,
              d_model: int = 256,
              num_layers: int = 4,
              num_heads: int = 8,
              attn_impl: str = 'vpu',
              conv_impl: str = 'xla',
              diffusion_timesteps: int = 1000,
              init_style: str = 'torch',
              generator: Optional[torch.Generator] = None,
              device=None):
    """Build a model by name on ``device``, drawing its init from
    ``generator``."""
    if model_type == 'feedforward':
        return FeedForwardBaseline(
            num_dofs=num_dofs, num_contact_bodies=num_contact_bodies,
            history_len=history_len, stride=stride,
            root_history_len=root_history_len,
            output_data_format=output_data_format, activation=activation,
            hidden_dims=tuple(hidden_dims), batchnorm=batchnorm,
            dropout=dropout, dropout_prob=dropout_prob,
            init_style=init_style, generator=generator, device=device)
    if model_type == 'groundlink':
        return Groundlink(
            num_dofs=num_dofs, num_contact_bodies=num_contact_bodies,
            root_history_len=root_history_len,
            output_data_format=output_data_format, conv_impl=conv_impl,
            generator=generator, device=device)
    if model_type == 'transformer':
        return TransformerRegressor(
            num_dofs=num_dofs, num_contact_bodies=num_contact_bodies,
            history_len=history_len, stride=stride,
            root_history_len=root_history_len,
            output_data_format=output_data_format,
            d_model=d_model, num_layers=num_layers, num_heads=num_heads,
            dropout=dropout_prob if dropout else 0.0,
            attn_impl=attn_impl, generator=generator, device=device)
    if model_type == 'diffusion':
        return DiffusionDenoiser(
            num_dofs=num_dofs, num_contact_bodies=num_contact_bodies,
            history_len=history_len, stride=stride,
            root_history_len=root_history_len,
            d_model=d_model, num_layers=num_layers, num_heads=num_heads,
            timesteps=diffusion_timesteps, attn_impl=attn_impl,
            generator=generator, device=device)
    raise ValueError(f'unknown model type {model_type!r}; expected one of {MODEL_TYPES}')


def build_model_for_dataset(config: Config, ds: WindowDataset, *,
                            generator: Optional[torch.Generator] = None,
                            device=None):
    """The model ``config`` names, sized to ``ds``'s layouts, on ``device``."""
    return get_model(
        config.model_type,
        num_dofs=ds.num_dofs,
        num_contact_bodies=ds.num_contact_bodies,
        history_len=config.window_size,
        stride=config.stride,
        root_history_len=ds.root_history_len,
        output_data_format=config.output_data_format,
        activation=config.activation,
        hidden_dims=config.hidden_dims,
        batchnorm=config.batchnorm,
        dropout=config.dropout,
        dropout_prob=config.dropout_prob,
        d_model=config.d_model,
        num_layers=config.num_layers,
        num_heads=config.num_heads,
        attn_impl=config.attn_impl,
        conv_impl=config.conv_impl,
        diffusion_timesteps=config.diffusion_timesteps,
        init_style=config.init_style,
        generator=generator,
        device=device,
    )


__all__ = [
    'build_model_for_dataset', 'get_model', 'MODEL_TYPES', 'DiffusionDenoiser',
    'FeedForwardBaseline', 'Groundlink', 'TransformerRegressor',
    'pack_inputs', 'slice_output_heads', 'output_head_size',
]
