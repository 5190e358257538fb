"""Batched sliding-window inference over a subject file.

PyTorch counterpart of ``inferbiomechanics_tpu/inference.py``: the predict
step that ``save-prediction-csv`` (and, later, ``visualize-file``,
``review-file`` and ``visualize``) stand on. All windows of a trial are
gathered with the dataset's packed gather and predicted in batches through
the model's eval forward: K1 for the feedforward model, K2 a layer for the
``pallas`` transformer (and for a ``vpu`` one with ``--fused-inference``),
K4 for GroundLink, the plain bf16 forward for the ``vpu`` transformer. Each
window also gets its own loss: the JAX package's loss of that window alone,
for every window of the batch at once (``torch.func.vmap``).

``device`` defaults to ``cuda`` and fails without a GPU; ``cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from inferbiomechanics_tpu_torch.config import Config
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset, unpack
from inferbiomechanics_tpu_torch.data.keys import OutputDataKeys
from inferbiomechanics_tpu_torch.loss.evaluator import loss_and_metrics
from inferbiomechanics_tpu_torch.models.transformer import (
    TransformerRegressor, fused_transformer_forward,
)
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.train.augment import spec_from_dataset, tta_average
from inferbiomechanics_tpu_torch.train.checkpoint import load_model
from inferbiomechanics_tpu_torch.train.loop import loss_config_from
from inferbiomechanics_tpu_torch.train.run_config import warn_on_architecture_mismatch

logger = logging.getLogger(__name__)

Arrays = Dict[str, np.ndarray]


@dataclass
class TrialPredictions:
    """Per-window predictions for one trial, aligned to window start frames."""
    window_starts: np.ndarray               # [N] raw-frame index of window start
    last_frame: np.ndarray                  # [N] raw-frame index of the predicted frame
    outputs: Arrays                         # each [N, out_frames, C]
    labels: Arrays                          # each [N, out_frames, C]
    per_window_loss: np.ndarray             # [N] scalar loss per window


class Predictor:
    """Loads a checkpointed model and predicts whole trials at once."""

    def __init__(self, config: Config, checkpoint_dir: str, dataset: WindowDataset,
                 tta_mirror: bool = False, device='cuda'):
        self.config = config
        self.ds = dataset
        self.device = resolve_device(device)
        warn_on_architecture_mismatch(config, checkpoint_dir, 'predict')
        self.model, self.epoch, self.batch = load_model(config, dataset, checkpoint_dir,
                                                        device=self.device)
        lc = loss_config_from(config)

        use_fused = bool(config.fused_inference)
        if use_fused and not (isinstance(self.model, TransformerRegressor)
                              and self.model.attn_impl == 'vpu'
                              and self.model.d_model % 128 == 0):
            logger.warning('--fused-inference ignored: needs a vpu transformer '
                           'with d_model a multiple of 128')
            use_fused = False
        forward = fused_transformer_forward if use_fused else (lambda model, x: model(x))
        if tta_mirror:
            # the mirror test-time average of serve and analyze --tta-mirror
            forward = tta_average(
                spec_from_dataset(dataset, lateral_axis=config.mirror_lateral_axis),
                dataset.lab_offsets, forward)

        def one_loss(o, lab):
            """The loss of one window (its rows of ``o`` and ``lab``), alone."""
            loss, _ = loss_and_metrics({k: v[None] for k, v in o.items()},
                                       {k: v[None] for k, v in lab.items()}, lc)
            return loss

        per_window = torch.func.vmap(one_loss)

        @torch.no_grad()
        def fwd(x: torch.Tensor, y: torch.Tensor):
            out = forward(self.model, x)
            labels = unpack(y, dataset.lab_offsets)
            return out, labels, per_window(out, labels)

        self._fwd = fwd

    def predict_windows(self, idx: np.ndarray) -> Tuple[Arrays, Arrays, np.ndarray]:
        """Forward pass on specific window indices; returns (outputs, labels,
        per_window_loss) as host arrays."""
        batch = self.ds.gather(np.asarray(idx))
        x, y = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)
                for a in (batch.inputs, batch.labels))
        out, lab, losses = self._fwd(x, y)
        host = lambda d: {k: v.cpu().numpy() for k, v in d.items()}  # noqa: E731
        return host(out), host(lab), losses.cpu().numpy()

    def predict_trial(self, subject_index: int, trial_index: int,
                      batch_size: int = 512) -> Optional[TrialPredictions]:
        """Predict every enumerated window of one trial, ``batch_size`` windows
        a forward."""
        ds = self.ds
        idx = np.nonzero((ds.win_subject == subject_index) & (ds.win_trial == trial_index))[0]
        if idx.size == 0:
            return None
        outs, labs, losses = zip(*(self.predict_windows(idx[i:i + batch_size])
                                   for i in range(0, idx.size, batch_size)))
        starts = ds.win_start[idx]
        return TrialPredictions(
            window_starts=starts,
            last_frame=starts + (ds.num_model_frames - 1) * ds.stride,
            outputs={k: np.concatenate([o[k] for o in outs]) for k in outs[0]},
            labels={k: np.concatenate([lab[k] for lab in labs]) for k in labs[0]},
            per_window_loss=np.concatenate(losses))

    @staticmethod
    def predict_forces_at_frames(pred: TrialPredictions) -> Tuple[np.ndarray, np.ndarray]:
        """(forces [N, 3 nb], cops [N, 3 nb]) at each window's last output
        frame, a body's force zeroed where its share of the summed force
        magnitudes is not above 0.3 (the reference viewer's rule)."""
        f = pred.outputs[OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME][:, -1, :]
        c = pred.outputs[OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME][:, -1, :]
        nb = f.shape[-1] // 3
        fv = f.reshape(-1, nb, 3)
        mags = np.linalg.norm(fv, axis=-1)
        share = mags / (mags.sum(axis=1, keepdims=True) + 1e-9)
        fv = np.where((share > 0.3)[..., None], fv, 0.0)
        return fv.reshape(f.shape), c


__all__ = ['Predictor', 'TrialPredictions']
