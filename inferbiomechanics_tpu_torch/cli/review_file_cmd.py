"""``review-file`` subcommand: data QA of one ``.b3d`` file.

PyTorch counterpart of ``inferbiomechanics_tpu/cli/review_file_cmd.py``,
with its flags: the reference's review tool (``src/cli/review_file.py``).
Every trial's windows go through ``inference.py::Predictor`` (K1, K2 or K4,
batches of 512), each window gets its own loss, frames whose loss is above
``--threshold-ratio`` (3) x the trial's mean are suspicious (ref :117-134),
runs of them become segments (ref :136-148), and a CSV keeps each segment's
review state GOOD / BAD / WIP, earlier states read back (ref :15-18, 50-70).
With ``--live``, the segment loop (ref :289-366) plays at 10 FPS inside the
current segment ('n' goes to the next), the skeleton posed in the WORLD frame
from the last processing pass by the FK of ``ops/skeleton.py``, and the raw
force-plate forces drawn red at their CoPs, scaled by 1 / mass.
``--device`` defaults to ``cuda`` and fails without a GPU; ``--device cpu``
runs the kernels' plain versions.

    python -m inferbiomechanics_tpu_torch review-file --file S.b3d \
        --checkpoint-dir C [--out-csv F] [--threshold-ratio 3] [--live]
"""

from __future__ import annotations

import argparse
import csv
import os
import threading
from typing import List, Tuple

import numpy as np

from inferbiomechanics_tpu_torch.cli.visualize_file_cmd import add_device_flag, make_predictor
from inferbiomechanics_tpu_torch.config import add_config_flags, config_from_args
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.ops.skeleton import compile_skeleton
from inferbiomechanics_tpu_torch.serve import resolve_device
from inferbiomechanics_tpu_torch.train.run_config import (
    add_run_config_flag, use_run_config_if_requested,
)
from inferbiomechanics_tpu_torch.viz.live import LiveViewerServer
from inferbiomechanics_tpu_torch.viz.live_model import mesh_payload, numpy_fk, posed_bodies
from inferbiomechanics_tpu_torch.viz.mesh import load_body_meshes
from inferbiomechanics_tpu_torch.viz.viewer import STANDARD_BONES

REVIEW_STATES = ('GOOD', 'BAD', 'WIP')


class SegmentReviewSession:
    """Playback state machine for the segment-review GUI loop
    (ref review_file.py:304-324): frame loops inside the CURRENT
    suspicious segment; space pauses, 'e'/'a' step with wrap at the
    segment bounds, 'n' cycles to the next segment."""

    def __init__(self, segments: List[Tuple[int, int, int, str]],
                 packet_for_frame):
        if not segments:
            raise ValueError('no suspicious segments to review')
        self.segments = segments           # (trial, start, end, state)
        self.segment_index = 0
        self.frame = segments[0][1]
        self.playing = True
        self._packet_for_frame = packet_for_frame
        self._lock = threading.Lock()

    @property
    def num_frames(self) -> int:           # LiveViewerServer compatibility
        _t, s, e, _st = self.segments[self.segment_index]
        return e - s

    def key(self, key: str) -> None:
        with self._lock:
            trial, start, end, _state = self.segments[self.segment_index]
            if key == ' ':
                self.playing = not self.playing
            elif key == 'e':
                self.frame += 1
                if self.frame >= end:
                    self.frame = start
            elif key == 'a':
                self.frame -= 1
                if self.frame < start:
                    self.frame = end - 1
            elif key == 'n':
                self.segment_index = (self.segment_index + 1) % len(self.segments)
                self.frame = self.segments[self.segment_index][1]

    def tick(self) -> dict:
        with self._lock:
            trial, start, end, state = self.segments[self.segment_index]
            if self.frame < start or self.frame >= end:
                self.frame = start
            frame = self.frame
            if self.playing:
                self.frame += 1
                if self.frame >= end:
                    self.frame = start
        packet = self._packet_for_frame(trial, frame)
        packet.setdefault('type', 'frame')
        packet['frame'] = frame
        packet['total'] = end
        packet['hud'] = (f'segment {self.segment_index + 1}/'
                         f'{len(self.segments)} trial {trial} '
                         f'[{start},{end}) state={state}   '
                         f"(n: next segment)")
        return packet


def find_suspicious_segments(per_frame_loss: np.ndarray,
                             threshold_ratio: float = 3.0) -> List[Tuple[int, int]]:
    """Frames with loss > ratio * mean, merged into [start, end) segments."""
    if per_frame_loss.size == 0:
        return []
    suspicious = per_frame_loss > threshold_ratio * per_frame_loss.mean()
    segments = []
    start = None
    for i, s in enumerate(suspicious):
        if s and start is None:
            start = i
        elif not s and start is not None:
            segments.append((start, i))
            start = None
    if start is not None:
        segments.append((start, len(suspicious)))
    return segments


def register_subcommand(sub) -> None:
    p = sub.add_parser('review-file', conflict_handler='resolve',
                       help='QA a .b3d file: flag high-loss segments')
    p.add_argument('--file', type=str, required=True)
    p.add_argument('--out-csv', type=str, default=None,
                   help='Review-state CSV (default: <file>.review.csv)')
    p.add_argument('--threshold-ratio', type=float, default=3.0)
    p.add_argument('--tta-mirror', action='store_true',
                   help='Mirror test-time augmentation: average each prediction with the '
                        'un-mirrored prediction of the sagittally mirrored window')
    p.add_argument('--live', action='store_true',
                   help='Serve the segment-review GUI loop on port 8080 (space/e/a '
                        'transport, n: next segment; raw plate forces in red)')
    p.add_argument('--port', type=int, default=8080)
    p.add_argument('--host', type=str, default='127.0.0.1',
                   help='Bind address (default loopback; use 0.0.0.0 to allow remote access)')
    add_config_flags(p)
    add_run_config_flag(p)
    add_device_flag(p, 'predict and pose')


def review_segments(predictor, ds, out_csv: str, threshold_ratio: float = 3.0
                    ) -> List[Tuple[int, int, int, str]]:
    """Every trial of subject 0 predicted, its suspicious segments written
    to ``out_csv`` (a segment's earlier state kept); returns (trial, start,
    end, state) a segment."""
    existing = {}
    if os.path.exists(out_csv):
        with open(out_csv) as f:
            for row in csv.reader(f):
                # skip the header and any malformed rows
                if len(row) >= 4 and row[0].lstrip('-').isdigit():
                    existing[(int(row[0]), int(row[1]), int(row[2]))] = row[3]

    all_segments: List[Tuple[int, int, int, str]] = []
    with open(out_csv, 'w', newline='') as f:
        writer = csv.writer(f)
        writer.writerow(['trial', 'segment_start', 'segment_end', 'state', 'mean_loss'])
        for trial in range(ds.subjects[0].getNumTrials()):
            pred = predictor.predict_trial(0, trial)
            if pred is None:
                continue
            segments = find_suspicious_segments(pred.per_window_loss, threshold_ratio)
            for (s, e) in segments:
                fs, fe = int(pred.last_frame[s]), int(pred.last_frame[e - 1]) + 1
                state = existing.get((trial, fs, fe), 'WIP')
                all_segments.append((trial, fs, fe, state))
                writer.writerow([trial, fs, fe, state,
                                 float(pred.per_window_loss[s:e].mean())])
                print(f'trial {trial}: suspicious frames [{fs},{fe}) '
                      f'loss={pred.per_window_loss[s:e].mean():.4f} [{state}]')
    print(f'wrote {out_csv}')
    return all_segments


def run(args: argparse.Namespace) -> int:
    config = use_run_config_if_requested(config_from_args(args), args)
    device = resolve_device(args.device)
    ds = WindowDataset(args.file, window_size=config.window_size, stride=config.stride,
                       skip_loading_skeletons=True)
    predictor = make_predictor(config, ds, args.tta_mirror, device)
    out_csv = args.out_csv or (args.file + '.review.csv')
    all_segments = review_segments(predictor, ds, out_csv, args.threshold_ratio)
    if args.live:
        if not all_segments:
            print('no suspicious segments — nothing to review live')
            return 0
        serve_segment_review(ds, all_segments, port=args.port,
                             title=os.path.basename(args.file), host=args.host,
                             device=device)
    return 0


def build_segment_packet_fn(ds, device=None):
    """World-frame packets for the segment loop (ref :341-356):
    skeleton posed from the LAST pass' positions, raw force-plate forces
    (world-frame contact channels) drawn at their CoPs scaled 1/mass. FK
    runs on ``device`` (default cuda)."""
    dev = resolve_device(device or 'cuda')
    subject = ds.subjects[0]
    mass = subject.getMassKg()
    offs = subject.field_offsets
    o_pos, w_pos = offs['pos']
    o_f, w_f = offs['groundContactForce']
    o_c, _ = offs['groundContactCenterOfPressure']
    o_jc, w_jc = offs['jointCentersInRootFrame']
    o_rw, _ = offs['rootPosInWorld']
    nb = w_f // 3

    fk_fn = None
    body_names: List[str] = []
    meshes = {}
    try:
        spec = subject.readSkel(subject.getNumProcessingPasses() - 1)
        skel = compile_skeleton(spec, device=dev)
        body_names = skel.body_names
        fk_fn = numpy_fk(skel)
        meshes = load_body_meshes(ds.geometry_folder or './Geometry', body_names)
    except (ValueError, KeyError):
        pass

    def packet_for_frame(trial: int, frame: int) -> dict:
        n_passes = subject.getTrialNumProcessingPasses(trial)
        last = subject.trial_pass_matrix(trial, n_passes - 1)
        row = last[frame]
        packet: dict = {
            # world-frame joint markers: root-frame centers shifted by the
            # root world translation (exact for small root rotation; the
            # raw plate forces are the QA signal here)
            'joints': (row[o_jc:o_jc + w_jc].reshape(-1, 3)
                       + row[o_rw:o_rw + 3][None, :]).tolist(),
            'label_forces': [
                [row[o_c + 3 * b:o_c + 3 * b + 3].tolist(),
                 (row[o_f + 3 * b:o_f + 3 * b + 3] / mass).tolist()]
                for b in range(nb)],
        }
        missing = subject.getMissingGRF(trial)
        packet['missing'] = bool(int(missing[frame]) != 0)
        if fk_fn is not None:
            q = np.array(row[o_pos:o_pos + w_pos], np.float64)
            packet['bodies'] = posed_bodies(*fk_fn(q), body_names, meshes)
        return packet

    return packet_for_frame, meshes


def serve_segment_review(ds, segments, port: int = 8080,
                         title: str = 'review', block: bool = True,
                         host: str = '127.0.0.1', device=None):
    packet_for_frame, meshes = build_segment_packet_fn(ds, device)
    session = SegmentReviewSession(segments, packet_for_frame)
    init = {'bones': STANDARD_BONES, 'meshes': mesh_payload(meshes)}
    server = LiveViewerServer(session, init, title=f'{title} (review)',
                              port=port, tick_interval=0.1,  # 10 FPS, ref :298
                              host=host)
    bound = server.start()
    print(f'segment review serving on http://{host}:{bound} '
          f'({len(segments)} segments; n: next, space: pause)')
    if block:
        server.block()
    return server
