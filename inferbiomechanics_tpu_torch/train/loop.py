"""Model construction for a dataset.

PyTorch counterpart of ``inferbiomechanics_tpu/train/loop.py``. It holds
only ``build_model_for_dataset`` so far; the training loop itself comes
with the feedforward-training slice (ROADMAP.md Queue 1 item 2).
"""

from __future__ import annotations

from typing import Optional

import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models import get_model


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
        init_style=config.init_style,
        generator=generator,
        device=device,
    )
