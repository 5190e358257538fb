"""Regression loss and metric engine.

PyTorch counterpart of ``inferbiomechanics_tpu/loss/evaluator.py``: the
four loss vectors (force / moment / wrench MSE; CoP MSE masked to feet
carrying more than 10 N), the selectable component sum that is the scalar
training loss, the three auxiliary-head losses, the eleven reported
metrics, and the per-split accumulator with its report.

The math is :func:`loss_and_metrics`, which the train and eval steps call;
its metrics are detached and stay on the device. The report goes to the
log and, through ``wandb_logger``, under the JAX package's wandb keys. With
a ``tau_fn`` (``loss/tau_report.py::make_tau_report_fn``) a batch accounted
with ``compute_report`` also scores the predicted wrenches against inverse
dynamics: the non-root joint-torque report (``tau_avg_err``).
:meth:`RegressionLossEvaluator.plot_errors` draws a batch's GRF errors
(``analyze --plot-errors``).
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from inferbiomechanics_tpu_torch.data.keys import OutputDataKeys
from inferbiomechanics_tpu_torch.ops.losses import (
    com_acc_error, mask_by_threes, mean_norm_error, squared_diff_mean_vector,
)
from inferbiomechanics_tpu_torch.utils import png_plot


# component names of the report's keys
COMPONENTS = ['left-x', 'left-y', 'left-z', 'right-x', 'right-y', 'right-z']
WRENCH_COMPONENTS = [
    'left-moment-x', 'left-moment-y', 'left-moment-z',
    'left-force-x', 'left-force-y', 'left-force-z',
    'right-moment-x', 'right-moment-y', 'right-moment-z',
    'right-force-x', 'right-force-y', 'right-force-z',
]


@dataclass(frozen=True)
class LossConfig:
    """Which components of each loss vector feed the scalar training loss,
    and the weights of the auxiliary heads (applied only when the model's
    outputs hold the key)."""
    predict_grf_components: Tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    predict_cop_components: Tuple[int, ...] = ()
    predict_moment_components: Tuple[int, ...] = ()
    predict_wrench_components: Tuple[int, ...] = ()
    cop_force_threshold_newtons: float = 10.0
    aux_tau_weight: float = 0.0
    aux_com_acc_weight: float = 0.0
    aux_contact_weight: float = 0.0


@functools.lru_cache(maxsize=None)
def _index_on(idx: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """``idx`` as an index tensor on ``device``, made once: indexing with a
    list would copy it from pageable host memory at every call, which a step
    captured as a CUDA graph cannot hold."""
    return torch.tensor(idx, dtype=torch.int64, device=device)


def loss_and_metrics(outputs: Dict[str, torch.Tensor],
                     labels: Dict[str, torch.Tensor],
                     config: LossConfig
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(scalar_loss, metrics)`` for one batch; ``metrics`` holds the four
    loss vectors and the scalar reported metrics, detached."""
    K = OutputDataKeys
    force_out, force_lab = (d[K.GROUND_CONTACT_FORCES_IN_ROOT_FRAME] for d in (outputs, labels))
    moment_out, moment_lab = (d[K.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME] for d in (outputs, labels))
    wrench_out, wrench_lab = (d[K.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME] for d in (outputs, labels))
    cop_out, cop_lab = (d[K.GROUND_CONTACT_COPS_IN_ROOT_FRAME] for d in (outputs, labels))

    force_loss = squared_diff_mean_vector(force_out, force_lab)
    moment_loss = squared_diff_mean_vector(moment_out, moment_lab)
    wrench_loss = squared_diff_mean_vector(wrench_out, wrench_lab)
    # CoP means nothing without contact: mask to feet with enough force
    cop_mask = mask_by_threes(force_lab, threshold=config.cop_force_threshold_newtons)
    cop_loss = squared_diff_mean_vector(cop_out * cop_mask, cop_lab * cop_mask)

    def sel(vec: torch.Tensor, idx: Tuple[int, ...]) -> torch.Tensor:
        if not idx:
            return vec.new_zeros(())
        if tuple(idx) == tuple(range(idx[0], idx[0] + len(idx))):
            return vec[idx[0]:idx[0] + len(idx)].sum()
        return vec[_index_on(tuple(idx), vec.device)].sum()

    loss = (sel(force_loss, config.predict_grf_components) +
            sel(cop_loss, config.predict_cop_components) +
            sel(moment_loss, config.predict_moment_components) +
            sel(wrench_loss, config.predict_wrench_components))

    if config.aux_tau_weight > 0 and K.TAU in outputs:
        loss = loss + config.aux_tau_weight * ((outputs[K.TAU] - labels[K.TAU]) ** 2).mean()
    if config.aux_com_acc_weight > 0 and K.COM_ACC_IN_ROOT_FRAME in outputs:
        loss = loss + config.aux_com_acc_weight * (
            (outputs[K.COM_ACC_IN_ROOT_FRAME] - labels[K.COM_ACC_IN_ROOT_FRAME]) ** 2).mean()
    if config.aux_contact_weight > 0 and K.CONTACT in outputs:
        loss = loss + config.aux_contact_weight * F.binary_cross_entropy_with_logits(
            outputs[K.CONTACT], labels[K.CONTACT])

    with torch.no_grad():
        wrench_halves = (mean_norm_error(wrench_out[:, :, :3], wrench_lab[:, :, :3]) +
                         mean_norm_error(wrench_out[:, :, 6:9], wrench_lab[:, :, 6:9])) / 2.0
        metrics = {
            'force_loss': force_loss,
            'moment_loss': moment_loss,
            'wrench_loss': wrench_loss,
            'cop_loss': cop_loss,
            'loss': loss,
            'force_avg_err': mean_norm_error(force_out, force_lab),
            'moment_avg_err': mean_norm_error(moment_out, moment_lab),
            'cop_avg_err': mean_norm_error(cop_out * cop_mask, cop_lab * cop_mask),
            'wrench_moment_avg_err': wrench_halves,
            'wrench_avg_err': mean_norm_error(wrench_out, wrench_lab, vec_size=6),
            'com_acc_avg_err': com_acc_error(force_out, force_lab),
        }
    return loss, {k: v.detach() for k, v in metrics.items()}


class RegressionLossEvaluator:
    """Per-split accumulator, report printer and logger: ``__call__`` once a
    batch, ``print_report`` at epoch boundaries. Metrics stay where they
    come from (device tensors from a step, host arrays from a drained eval
    chunk) until the report, which copies their means to the host at once.
    ``wandb_logger`` (a ``utils.wandb_compat.MetricLogger``) gets the
    report under the JAX package's key schema when asked to. ``tau_fn``
    computes the joint-torque report of a batch accounted with
    ``compute_report``; its values go to :attr:`tau_reported_metrics`."""

    def __init__(self, split: str, config: LossConfig = LossConfig(), tau_fn=None,
                 wandb_logger=None):
        self.split = split
        self.config = config
        self.tau_fn = tau_fn
        self.wandb_logger = wandb_logger
        self.reset()

    def reset(self) -> None:
        self.metric_history: Dict[str, list] = {}
        self.tau_reported_metrics: List[float] = []

    def compute_metrics(self, outputs, labels) -> Dict[str, torch.Tensor]:
        return loss_and_metrics(outputs, labels, self.config)[1]

    def __call__(self, inputs, outputs, labels, batch_subject_indices=None,
                 compute_report: bool = False, precomputed_metrics: Optional[Dict] = None):
        """Account one batch; pass the step's own metrics (tensors, or the
        host arrays of a drained chunk) as ``precomputed_metrics`` to spare
        a second computation. With ``compute_report`` and a ``tau_fn``, the
        batch's joint-torque report is computed from its inputs, outputs,
        labels and subject indices."""
        metrics = (self.compute_metrics(outputs, labels)
                   if precomputed_metrics is None else precomputed_metrics)
        for k, v in metrics.items():
            self.metric_history.setdefault(k, []).append(v)
        if compute_report and self.tau_fn is not None:
            self.tau_reported_metrics.append(
                float(self.tau_fn(inputs, outputs, labels, batch_subject_indices)))
        return metrics['loss']

    def _means(self) -> Dict[str, np.ndarray]:
        """Each metric's mean over the accounted batches (a vector metric
        stays a vector), in one device-to-host copy."""
        keys = list(self.metric_history)
        if not keys:
            return {}
        first = self.metric_history[keys[0]][0]
        device = first.device if torch.is_tensor(first) else torch.device('cpu')
        means = [torch.stack([torch.as_tensor(h, device=device)
                              for h in self.metric_history[k]]).float().mean(0)
                 for k in keys]
        flat = torch.cat([m.reshape(-1) for m in means]).cpu().numpy()
        out, at = {}, 0
        for k, m in zip(keys, means):
            out[k] = flat[at:at + m.numel()].reshape(m.shape)
            at += m.numel()
        return out

    def _wandb_report(self, m: Dict[str, np.ndarray],
                      tau_metric: Optional[float] = None) -> Dict[str, float]:
        """The JAX package's key schema: each report key is logged iff its
        own metric exists."""
        c, s = self.config, self.split
        report = {
            **{f'{s}/force_rmse/{COMPONENTS[i]}': float(m['force_loss'][i]) ** 0.5
               for i in c.predict_grf_components},
            **{f'{s}/cop_rmse/{COMPONENTS[i]}': float(m['cop_loss'][i]) ** 0.5
               for i in c.predict_cop_components},
            **{f'{s}/moment_rmse/{COMPONENTS[i]}': float(m['moment_loss'][i]) ** 0.5
               for i in c.predict_moment_components},
            **{f'{s}/wrench_loss/{WRENCH_COMPONENTS[i]}': float(m['wrench_loss'][i]) ** 0.5
               for i in c.predict_wrench_components},
            f'{s}/loss': float(m['loss']),
            f'{s}/reports/Force Avg Err (N per kg)': float(m['force_avg_err']),
            f'{s}/reports/CoP Avg Err (m)': float(m['cop_avg_err']),
            f'{s}/reports/Moment Avg Err (Nm per kg)': float(m['moment_avg_err']),
            f'{s}/reports/COM Acc Avg Err (m per s^2)': float(m['com_acc_avg_err']),
            f'{s}/reports/Wrench Avg Err (N+Nm per kg)': float(m['wrench_avg_err']),
        }
        if tau_metric is not None:
            report[f'{s}/reports/Non-root Joint Torques (Inverse Dynamics) '
                   f'Avg Err (Nm per kg)'] = tau_metric
        return report

    def plot_errors(self, outputs: Dict[str, torch.Tensor], labels: Dict[str, torch.Tensor],
                    plot_path_root: str = 'outputs/plots', tag: str = 'batch') -> List[str]:
        """The squared error of the batch's last frame, window by window, as
        one PNG a selected GRF component (``predict_grf_components``):
        ``{plot_path_root}/{tag}_grferror{COMPONENT}.png``, drawn by
        matplotlib on ``Agg``, or, where matplotlib is not installed, by
        ``utils/png_plot.py``. Returns the paths written."""
        try:
            import matplotlib
        except ImportError:
            matplotlib = None
        if matplotlib is not None:
            matplotlib.use('Agg')
            import matplotlib.pyplot as plt

        os.makedirs(plot_path_root, exist_ok=True)
        k = OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME
        diff = (outputs[k] - labels[k]).detach().float().cpu().numpy()
        err = (diff ** 2)[:, -1, :].reshape(-1, diff.shape[-1])
        written = []
        for i in self.config.predict_grf_components:
            path = os.path.join(plot_path_root, f'{tag}_grferror{COMPONENTS[i]}.png')
            ylabel = f'squared error {COMPONENTS[i]}'
            if matplotlib is None:
                png_plot.write_line_png(path, err[:, i], ylabel)
            else:
                plt.clf()
                plt.plot(err[:, i])
                plt.ylabel(ylabel)
                plt.savefig(path)
            written.append(path)
        if matplotlib is not None:
            plt.close('all')
        return written

    def mean_metric(self, key: str) -> Optional[float]:
        hist = self.metric_history.get(key)
        return float(self._means()[key].mean()) if hist else None

    def print_report(self, reset: bool = True, log_to_wandb: bool = False) -> Dict[str, float]:
        means = self._means()
        tau = (float(np.mean(self.tau_reported_metrics))
               if self.tau_reported_metrics else None)
        summary: Dict[str, float] = {}
        if means:
            keys = ('force_avg_err', 'com_acc_avg_err', 'cop_avg_err', 'moment_avg_err',
                    'wrench_avg_err', 'wrench_moment_avg_err', 'loss')
            summary = {k: float(means[k]) for k in keys}
            if tau is not None:
                summary['tau_avg_err'] = tau
            print(f'\tForce Avg Err: {summary["force_avg_err"]} N / kg')
            print(f'\tCOM Acc Avg Err: {summary["com_acc_avg_err"]} m / s^2')
            print(f'\tCoP Avg Err: {summary["cop_avg_err"]} m')
            print(f'\tMoment Avg Err: {summary["moment_avg_err"]} Nm / kg')
            print(f'\tWrench Avg Err: {summary["wrench_avg_err"]} N+Nm / kg')
            print(f'\tWrench Moment Avg Err: {summary["wrench_moment_avg_err"]} Nm / kg')
            if tau is not None:
                print(f'\tNon-root Joint Torques (Inverse Dynamics) Avg Err: {tau} Nm / kg')
            if log_to_wandb and self.wandb_logger is not None:
                self.wandb_logger.log(self._wandb_report(means, tau))
        if reset:
            self.reset()
        return summary
