"""Inverse-dynamics joint-torque report.

PyTorch counterpart of ``inferbiomechanics_tpu/loss/tau_report.py``
(reference ``RegressionLossEvaluator.py:265-286``): for each window, the
skeleton state of its LAST input frame, the predicted (per-kg) contact
wrenches times the subject's mass, ``inverse_dynamics_from_predictions``,
and the mean |tau error| over the non-root DOFs divided by the mass,
averaged over the batch. Each window takes its subject's mass and, when
every subject carries a structurally equal skeleton, its subject's scaled
skeleton (``models/analytical.py::SubjectSkeletons``).

On a CUDA device the report of a batch is one CUDA graph a batch shape
(``train/step.py::GraphedEval``), replayed with the batch's inputs: eagerly
it would be some ten thousand small launches. On the CPU it runs eagerly.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.models.analytical import SubjectSkeletons, kinematics
from inferbiomechanics_tpu_torch.train.step import GraphedEval

_WRENCHES = K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME


def make_tau_report_fn(ds: WindowDataset, device='cuda', dtype=torch.float32) -> Callable:
    """Build ``tau_fn(packed_inputs, outputs, labels, batch_subject_indices=None)
    -> float``, the hook ``RegressionLossEvaluator`` calls, on ``device`` in
    ``dtype``. ``tau_fn.traceable`` is its core, which returns the batch's
    metric as a 0-d tensor and copies nothing from the host, so that it can
    be captured in a CUDA graph."""
    skels = SubjectSkeletons(ds, device, dtype)
    device = skels.device
    # each item's own mass (the reference's skel.getMass())
    subject_masses = (np.asarray([s.getMassKg() for s in ds.subjects], dtype=np.float32)
                      if ds.subjects else np.asarray([70.0], np.float32))
    mean_mass = float(np.mean(subject_masses))
    masses = torch.as_tensor(subject_masses, device=device).to(dtype)

    def traceable(packed_inputs: torch.Tensor, outputs, labels,
                  batch_subject_indices=None) -> torch.Tensor:
        q, dq, ddq = (v[:, -1].to(dtype) for v in kinematics(ds, packed_inputs))
        wrenches = outputs[_WRENCHES][:, -1, :]
        tau_label = labels[K.OutputDataKeys.TAU][:, -1, :].to(dtype)
        if batch_subject_indices is not None:
            # a gather on the device would not check the range: the host
            # wrapper below does
            mass = masses[batch_subject_indices]
        else:
            mass = torch.full((q.shape[0],), mean_mass, dtype=dtype, device=device)
        sk = skels.for_rows(batch_subject_indices, frames=False)
        tau = sk.inverse_dynamics_from_predictions(
            q, dq, ddq, skels.contact_indices, wrenches.to(dtype) * mass.unsqueeze(-1))
        err = tau - tau_label
        return ((err[:, 6:].abs().mean(-1) / mass)).mean()   # non-root DOFs (ref :284)

    graphs = {}     # (shapes, with subject indices) -> GraphedEval

    def report(x, wrenches, tau_label, sidx=None):
        return {'tau': traceable(x, {_WRENCHES: wrenches}, {K.OutputDataKeys.TAU: tau_label},
                                 sidx)}

    def tau_fn(packed_inputs, outputs, labels, batch_subject_indices=None) -> float:
        args = [torch.as_tensor(v, device=device) for v in (
            packed_inputs, outputs[_WRENCHES], labels[K.OutputDataKeys.TAU])]
        # a dataset without subjects (``data/pickled.py``'s) has one mass, 70
        # kg, for every window: the JAX package's gather clamps to it
        if batch_subject_indices is not None and ds.subjects:
            si = np.asarray(batch_subject_indices.cpu() if torch.is_tensor(batch_subject_indices)
                            else batch_subject_indices)
            if si.size and (si.min() < 0 or si.max() >= len(subject_masses)):
                # a gather on the device would take another subject's row
                raise IndexError(f'batch_subject_indices out of range '
                                 f'[0, {len(subject_masses)}): '
                                 f'min {si.min()}, max {si.max()}')
            args.append(torch.as_tensor(si.astype(np.int64), device=device))
        if device.type != 'cuda':
            return float(report(*args)['tau'])
        specs = tuple((tuple(a.shape), a.dtype) for a in args)
        graph = graphs.get(specs)
        if graph is None:
            graph = graphs[specs] = GraphedEval(report, specs, device)
        return float(graph.run(*args)['tau'])

    tau_fn.traceable = traceable
    return tau_fn
