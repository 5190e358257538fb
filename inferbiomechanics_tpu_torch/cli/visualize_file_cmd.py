"""``visualize-file`` subcommand: one ``.b3d`` trial in the web viewer.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/visualize_file_cmd.py``,
with its flags: the reference's single-file viewer (port 8080) with
sliding-window model predictions a frame, label vs predicted forces at their
CoPs, frames with missing GRF flagged red, and a body's predicted force
zeroed where its share of the force is not above 0.3. Every window of the
trial goes through ``inference.py::Predictor`` in batches of 512 (K1, K2 or
K4), the trial's FK poses the Geometry meshes in one batched call
(``ops/skeleton.py``), and the frames go to the self-contained HTML viewer
(``--serve`` serves it), or, with ``--live``, to the live WebSocket viewer, a
B=1 forward a tick. ``--device`` defaults to ``cuda`` and fails without a
GPU; ``--device cpu`` runs the kernels' plain versions.

    python -m inferbiomechanics_tpu_torch visualize-file --file S.b3d \
        --checkpoint-dir C [--trial 0] [--out outputs/visualize_file.html] \
        [--serve | --live] [--no-model] [--tta-mirror] [--geometry-folder G]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.b3d import MissingGRFReason
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.inference import Predictor
from inferbiomechanics_tpu_torch.ops.skeleton import compile_skeleton
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.train.run_config import (
    add_run_config_flag, use_run_config_if_requested,
)
from inferbiomechanics_tpu_torch.utils.geometry import ensure_geometry
from inferbiomechanics_tpu_torch.viz.live_model import (
    mesh_payload, numpy_fk, posed_bodies, serve_live,
)
from inferbiomechanics_tpu_torch.viz.mesh import load_body_meshes
from inferbiomechanics_tpu_torch.viz.viewer import STANDARD_BONES, export_html, serve_file


def add_device_flag(p, what: str) -> None:
    p.add_argument('--device', type=str, default='cuda',
                   help=f'torch device to {what} on: cuda (default; fails without a GPU) '
                        'or cpu')


def make_predictor(config, ds, tta_mirror: bool, device) -> Predictor:
    checkpoint_dir = os.path.join(os.path.abspath(config.checkpoint_dir), config.model_type)
    return Predictor(config, checkpoint_dir, ds, tta_mirror=tta_mirror, device=device)


def build_viz_payload(ds: WindowDataset, subject_index: int, trial: int,
                      predictor=None, geometry_folder: str = '', device=None):
    """Assemble viewer frames for one trial (joints, forces, missing flags,
    and — when the subject carries a skeleton — FK-posed Geometry meshes
    like the live viewer). FK runs on the predictor's device, else on
    ``device`` (default cuda)."""
    dev = predictor.device if predictor is not None else resolve_device(device or 'cuda')
    subject = ds.subjects[subject_index]
    kin = subject.trial_pass_matrix(trial, 0)
    offs = subject.field_offsets

    fk_fn = None
    body_names = []
    meshes = {}
    try:
        skel = compile_skeleton(subject.readSkel(
            subject.getNumProcessingPasses() - 1, geometry_folder), device=dev)
        body_names = skel.body_names
        meshes = load_body_meshes(geometry_folder, body_names)
        if meshes:
            fk_fn = numpy_fk(skel)
    except (ValueError, KeyError):
        pass
    missing = [int(r) != int(MissingGRFReason.notMissingGRF)
               for r in subject.getMissingGRF(trial)]
    o_jc, w_jc = offs['jointCentersInRootFrame']
    o_cop, w_cop = offs['groundContactCenterOfPressureInRootFrame']
    o_f, w_f = offs['groundContactForceInRootFrame']
    o_rv, _ = offs['rootLinearVelInRootFrame']
    o_rh, w_rh = offs['rootPosHistoryInRootFrame']
    mass = subject.getMassKg()
    nb = w_f // 3

    pred_at = {}
    if predictor is not None:
        pred = predictor.predict_trial(subject_index, trial)
        if pred is not None:
            forces, cops = predictor.predict_forces_at_frames(pred)
            for i, fr in enumerate(pred.last_frame):
                pred_at[int(fr)] = (forces[i], cops[i])

    frames = []
    T = kin.shape[0]
    all_bodies = None
    if fk_fn is not None:
        o_p, w_p = offs['pos']
        qs = np.array(kin[:, o_p:o_p + w_p], np.float64)
        qs[:, :6] = 0.0   # root-zeroed like the live viewer
        Rs, ps = fk_fn(qs)     # the whole trial in one batched call
        all_bodies = [posed_bodies(Rs[i], ps[i], body_names, meshes) for i in range(T)]
    for i in range(T):
        joints = kin[i, o_jc:o_jc + w_jc].reshape(12, 3).tolist()
        label_forces = []
        for b in range(nb):
            cop = kin[i, o_cop + 3 * b:o_cop + 3 * b + 3]
            f = kin[i, o_f + 3 * b:o_f + 3 * b + 3] / mass
            label_forces.append([cop.tolist(), f.tolist()])
        fr = {'joints': joints, 'bones': STANDARD_BONES,
              'label_forces': label_forces, 'missing_grf': bool(missing[i]),
              # parity with visualize.py:218-253: root velocity line +
              # root position-history markers, both in the root frame
              'root_vel': kin[i, o_rv:o_rv + 3].tolist(),
              'root_history': kin[i, o_rh:o_rh + w_rh].reshape(-1, 3).tolist()}
        if i in pred_at:
            pf, pc = pred_at[i]
            pf = pf.reshape(nb, 3)
            pc = pc.reshape(nb, 3)
            fr['pred_forces'] = [[pc[b].tolist(), pf[b].tolist()]
                                 for b in range(nb)]
        if all_bodies is not None:
            fr['bodies'] = all_bodies[i]
        frames.append(fr)
    payload = {'dt': subject.getTrialTimestep(trial), 'frames': frames}
    if meshes:
        payload['meshes'] = mesh_payload(meshes)
    return payload


def register_subcommand(sub) -> None:
    p = sub.add_parser('visualize-file', conflict_handler='resolve',
                       help='Visualize a single .b3d subject file')
    p.add_argument('--file', type=str, required=True,
                   help='Path to the .b3d file to visualize')
    p.add_argument('--trial', type=int, default=0)
    p.add_argument('--out', type=str, default='outputs/visualize_file.html')
    p.add_argument('--serve', action='store_true', help='Serve the viewer on port 8080')
    p.add_argument('--live', action='store_true',
                   help='Live model-in-the-loop WebSocket viewer')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--host', type=str, default='127.0.0.1',
                   help='Bind address (default loopback; use 0.0.0.0 to allow remote access)')
    p.add_argument('--no-model', action='store_true',
                   help='Skip model predictions (labels only)')
    p.add_argument('--tta-mirror', action='store_true',
                   help='Mirror test-time augmentation: average each prediction with the '
                        'un-mirrored prediction of the sagittally mirrored window')
    add_config_flags(p)
    add_run_config_flag(p)
    add_device_flag(p, 'predict and pose')


def run(args: argparse.Namespace) -> int:
    config = use_run_config_if_requested(config_from_args(args), args)
    device = resolve_device(args.device)
    ds = WindowDataset(args.file, window_size=config.window_size, stride=config.stride,
                       skip_loading_skeletons=True)
    predictor = None
    if not args.no_model and config.model_type != 'analytical':
        predictor = make_predictor(config, ds, args.tta_mirror, device)
        if predictor.epoch < 0:
            print('WARNING: no checkpoint found; predictions come from '
                  'an untrained model')
    geometry = ensure_geometry(config.geometry_folder)
    if args.live:
        win_idx = np.nonzero((ds.win_subject == 0) & (ds.win_trial == args.trial))[0]
        serve_live(ds, predictor, None, window_indices=win_idx, geometry_folder=geometry,
                   title=os.path.basename(args.file), port=args.port, host=args.host,
                   device=device)
        return 0
    payload = build_viz_payload(ds, 0, args.trial, predictor, geometry_folder=geometry,
                                device=device)
    path = export_html(args.out, payload, title=os.path.basename(args.file))
    print(f'wrote viewer: {path}')
    if args.serve:
        serve_file(path, args.port, host=args.host)
    return 0
