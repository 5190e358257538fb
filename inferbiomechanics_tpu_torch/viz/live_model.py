"""Model-in-the-loop live viewer session over a WindowDataset.

PyTorch counterpart of ``inferbiomechanics_tpu/viz/live_model.py``, the glue
between the data/model layers and viz/live.py that replicates the reference's
per-tick GUI loop (visualize.py:157-263): each tick gathers ONE window, runs
the current checkpoint forward (``inference.py::Predictor.predict_windows`` at
B=1: one K1 or K4 launch, or four K2 launches), accumulates the loss
evaluator, prints the report every 100 frames (and on 'r'), and streams joint
centers, root velocity/history, red label / blue predicted force lines, plus
Geometry meshes posed by the FK of ``ops/skeleton.py`` (float32, on the
Predictor's device).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.ops.skeleton import (
    compile_skeleton, skeleton_param_stack, skeletons_structurally_equal, with_params,
)
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.viz.live import LiveSession, LiveViewerServer
from inferbiomechanics_tpu_torch.viz.mesh import load_body_meshes
from inferbiomechanics_tpu_torch.viz.viewer import STANDARD_BONES

log = logging.getLogger(__name__)


def numpy_fk(skel) -> Callable:
    """``fk(q)`` of ``skel`` on host arrays: ``q`` [..., D] (float64, as the
    data holds it) goes to the skeleton's device in its dtype; (R [..., nb,
    3, 3], p [..., nb, 3]) come back as numpy."""
    def fk(q: np.ndarray):
        with torch.no_grad():
            Rs, ps = skel.fk(torch.as_tensor(np.asarray(q), dtype=skel.dtype,
                                             device=skel.device))
        return Rs.cpu().numpy(), ps.cpu().numpy()
    return fk


def posed_bodies(Rs: np.ndarray, ps: np.ndarray, body_names, meshes) -> dict:
    """One frame's ``bodies`` entry: each meshed body's world transform,
    rounded to 4 decimals as the viewer's JSON carries it."""
    return {name: {'R': Rs[i].reshape(-1).round(4).tolist(), 'p': ps[i].round(4).tolist()}
            for i, name in enumerate(body_names) if name in meshes}


def mesh_payload(meshes) -> dict:
    return {name: {'v': v.round(4).tolist(), 'e': e.tolist()} for name, (v, e) in meshes.items()}


def build_live_session(ds, predictor=None, evaluator=None,
                       window_indices: Optional[np.ndarray] = None,
                       geometry_folder: str = '',
                       report_every: int = 100, device=None):
    """Returns (LiveSession, init_payload) for a dataset / one trial.

    `window_indices` restricts playback (visualize-file plays one trial's
    windows); default plays the whole dataset like visualize.py:131. FK runs
    on the predictor's device, else on ``device`` (default cuda).
    """
    idx = (np.asarray(window_indices)
           if window_indices is not None else np.arange(len(ds)))
    if idx.size == 0:
        raise ValueError(
            'no playable windows: the requested trial has no enumerated '
            'windows (missing, too short for the window size, or all '
            'frames flagged missing-GRF)')
    dev = predictor.device if predictor is not None else resolve_device(device or 'cuda')
    in_offs = ds.in_offsets
    lab_offs = ds.lab_offsets
    nb = ds.num_contact_bodies

    # FK body transforms for mesh posing (root zeroed like
    # visualize.py:215-216: pos_in_root_frame[0:6] = 0). Multi-subject
    # dev sets carry one SCALED skeleton per subject: per-subject
    # parameter rows are selected per window (ops/skeleton.py).
    fk_fn = None
    body_names = []
    meshes = {}
    specs = []
    for s in ds.subjects:
        try:
            specs.append(s.readSkel(s.getNumProcessingPasses() - 1,
                                    geometry_folder))
        except (ValueError, KeyError):
            specs.append(None)   # one bad subject must not disable FK
    good = [sp for sp in specs if sp is not None]
    if good:
        skel = compile_skeleton(good[0], device=dev)
        body_names = skel.body_names
        if (len(good) == len(specs) and len(good) > 1
                and all(skeletons_structurally_equal(good[0], sp)
                        for sp in good[1:])):
            param_stack = skeleton_param_stack(good, device=dev)
            per_subject = [numpy_fk(with_params(skel, {k: v[si] for k, v in param_stack.items()}))
                           for si in range(len(good))]
            fk_fn = lambda q, si=0: per_subject[si](q)   # noqa: E731
        else:
            if len(specs) > 1:
                log.warning(
                    'per-subject skeleton posing unavailable (missing or '
                    'structurally different skeletons); all windows pose '
                    "with subject 0's skeleton")
            base_fk = numpy_fk(skel)
            fk_fn = lambda q, si=0: base_fk(q)   # noqa: E731
        meshes = load_body_meshes(geometry_folder, body_names)

    tick_count = [0]
    running = [0.0]

    # body index PER ds.contact_bodies ROW ORDER (CoP rows follow it);
    # name-order enumeration would pair CoPs with the wrong foot
    name_to_idx = {n: i for i, n in enumerate(body_names)}
    contact_body_idx = [name_to_idx[b] for b in ds.contact_bodies
                        if b in name_to_idx]

    def packet_for_frame(frame: int) -> dict:
        wi = idx[frame % len(idx)]
        si = int(ds.win_subject[wi])
        batch = ds.gather(np.asarray([wi]))
        x = batch.inputs[0]                       # [T, C_in]
        o_pos, w_pos = in_offs[K.InputDataKeys.POS]
        o_jc, w_jc = in_offs[K.InputDataKeys.JOINT_CENTERS_IN_ROOT_FRAME]
        o_rv, _ = in_offs[K.InputDataKeys.ROOT_LINEAR_VEL_IN_ROOT_FRAME]
        o_rh, w_rh = in_offs[K.InputDataKeys.ROOT_POS_HISTORY_IN_ROOT_FRAME]
        packet: dict = {
            'joints': x[-1, o_jc:o_jc + w_jc].reshape(-1, 3).tolist(),
            'root_vel': x[0, o_rv:o_rv + 3].tolist(),
            'root_history': x[0, o_rh:o_rh + w_rh].reshape(-1, 3).tolist(),
            'subject': si,
        }
        lab = batch.labels[0, -1]
        o_f, _ = lab_offs[K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME]
        o_c, _ = lab_offs[K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME]
        packet['label_forces'] = [
            [lab[o_c + 3 * b:o_c + 3 * b + 3].tolist(),
             lab[o_f + 3 * b:o_f + 3 * b + 3].tolist()] for b in range(nb)]

        # one FK of the root-zeroed pose serves the feet (the predicted
        # CoP's average) and the meshes
        posed = None
        if fk_fn is not None:
            q = np.array(x[-1, o_pos:o_pos + w_pos], np.float64)
            q[:6] = 0.0
            posed = fk_fn(q, si)

        if predictor is not None:
            outputs, labels, _ = predictor.predict_windows(np.asarray([wi]))
            if evaluator is not None:
                # the evaluator takes tensors; the Predictor hands host arrays
                loss_val = float(evaluator(
                    None, {k: torch.from_numpy(v) for k, v in outputs.items()},
                    {k: torch.from_numpy(v) for k, v in labels.items()}))
                # O(1) running mean; the evaluator's own history is reset
                # at every report so a viewer left open for hours neither
                # grows memory nor pays O(history) per tick
                tick_count[0] += 1
                running[0] += loss_val
                if report_every and tick_count[0] % report_every == 0:
                    print(f'Results on Frame {tick_count[0]}')
                    evaluator.print_report(reset=True)
            pf = np.asarray(
                outputs[K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME])[0, -1]
            pc = np.asarray(
                outputs[K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME])[0, -1]
            pc = pc.reshape(nb, 3).copy()
            # parity visualize_file.py:271-273: average the predicted CoP
            # with the foot body position (root-zeroed frame here)
            if posed is not None and len(contact_body_idx) == nb:
                feet = posed[1][contact_body_idx]
                pc = (pc + feet) / 2.0
            packet['pred_forces'] = [
                [pc[b].tolist(), pf[3 * b:3 * b + 3].tolist()]
                for b in range(nb)]
            if evaluator is not None and tick_count[0] > 0:
                packet['hud'] = \
                    f'running loss: {running[0] / tick_count[0]:.4f}'

        if posed is not None:
            packet['bodies'] = posed_bodies(*posed, body_names, meshes)
        return packet

    # subject starts for 's' (next subject) cycling in multi-subject sets
    subj_of_frame = np.asarray(ds.win_subject)[idx]
    jump_points = [0] + (1 + np.nonzero(np.diff(subj_of_frame))[0]).tolist()
    session = LiveSession(len(idx), packet_for_frame,
                          on_report=(lambda: evaluator.print_report(reset=False))
                          if evaluator else None,
                          jump_points=jump_points if len(jump_points) > 1
                          else None)
    init = {
        'bones': STANDARD_BONES,
        'meshes': mesh_payload(meshes),
    }
    return session, init


def serve_live(ds, predictor=None, evaluator=None, window_indices=None,
               geometry_folder: str = '', title: str = 'inferbiomechanics',
               port: int = 8888, block: bool = True,
               tick_interval: float = 0.04,
               host: str = '127.0.0.1', device=None) -> LiveViewerServer:
    session, init = build_live_session(ds, predictor, evaluator,
                                       window_indices, geometry_folder, device=device)
    server = LiveViewerServer(session, init, title=title, port=port,
                              tick_interval=tick_interval, host=host)
    bound = server.start()
    print(f'live viewer serving on http://{host}:{bound} '
          f'(space: play/pause, e/a: step, r: report)')
    if block:
        server.block()
    return server
