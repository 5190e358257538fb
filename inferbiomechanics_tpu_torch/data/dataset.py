"""Window dataset: enumeration, featurization, and packed batch assembly.

Capability parity: reference ``src/data/AddBiomechanicsDataset.py`` —
the same window enumeration (every start where no strided frame has a
missing-GRF reason, ref :132-139), the same input/label semantics
(inputs from processingPasses[0], tau/residual/comAcc labels from
processingPasses[-1], the four GRF label groups from the FIRST pass,
ref :174-247), the same mass-normalization split (forces/torques/
wrenches ÷ mass, CoP untouched, ref :252-261), and the same
contact-body canonical reordering with zero-fill (ref :233-261).

TPU-first redesign: instead of the reference's per-sample
``readFrames`` + ~18 small tensor builds (the #1 bottleneck, SURVEY.md
§3.5), each trial is featurized ONCE into two packed float32 matrices —
``F [T, C_in]`` (inputs, canonical concat order) and ``L [T, C_lab]``
(labels) — concatenated across all trials. A batch of B windows is then
a single fancy-index gather ``F_all[rows]`` producing a fixed-shape
``[B, W, C]`` array ready for ``device_put``. Models receive the packed
array; per-key dict views are zero-cost column slices that XLA folds
into the consuming ops.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from inferbiomechanics_tpu_torch.data import keys as K
from inferbiomechanics_tpu_torch.data.b3d import MissingGRFReason, SubjectOnDisk

# ---------------------------------------------------------------------------
# Packed channel layouts
# ---------------------------------------------------------------------------


def input_layout(num_dofs: int, root_history_len: int) -> List[Tuple[str, int]]:
    widths = K.input_channel_widths(num_dofs, root_history_len)
    return [(k, widths[k]) for k in K.INPUT_CONCAT_ORDER]


LABEL_PACK_ORDER: List[str] = [
    K.OutputDataKeys.TAU,
    K.OutputDataKeys.RESIDUAL_WRENCH_IN_ROOT_FRAME,
    K.OutputDataKeys.COM_ACC_IN_ROOT_FRAME,
    K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME,
    K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME,
    K.OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME,
    K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME,
    K.OutputDataKeys.CONTACT,
]


def label_layout(num_dofs: int, num_contact_bodies: int) -> List[Tuple[str, int]]:
    widths = K.label_channel_widths(num_dofs, num_contact_bodies)
    return [(k, widths[k]) for k in LABEL_PACK_ORDER]


def _offsets(layout: Sequence[Tuple[str, int]]) -> Dict[str, Tuple[int, int]]:
    out, off = {}, 0
    for name, w in layout:
        out[name] = (off, w)
        off += w
    return out


def unpack(packed, layout_offsets: Dict[str, Tuple[int, int]]):
    """Split a packed [..., C] array into a dict of column-slice views."""
    return {k: packed[..., o:o + w] for k, (o, w) in layout_offsets.items()}


# ---------------------------------------------------------------------------
# Batch container
# ---------------------------------------------------------------------------


@dataclass
class Batch:
    """One fixed-shape training batch (host numpy or device jax arrays)."""
    inputs: 'np.ndarray'          # [B, W, C_in]
    labels: 'np.ndarray'          # [B, out_frames, C_lab]
    subject_indices: 'np.ndarray'  # [B] int32
    trial_indices: 'np.ndarray'    # [B] int32


class WindowDataset:
    """Enumerates and serves fixed-length kinematic windows.

    Args mirror the reference dataset's constructor
    (AddBiomechanicsDataset.py:63-139). ``window_size`` is in raw frames;
    a window contains ``window_size // stride`` model frames.
    """

    def __init__(self,
                 data_path: str,
                 window_size: int,
                 geometry_folder: str = '',
                 dtype: np.dtype = np.float32,
                 testing_with_short_dataset: bool = False,
                 stride: int = 1,
                 output_data_format: str = 'last_frame',
                 skip_loading_skeletons: bool = False,
                 trial_filter: Optional[str] = None,
                 materialize_features: bool = True):
        """``materialize_features=False`` keeps input features ON DISK:
        windows are gathered straight from the mmap'd kinematics-pass
        matrices with a fused column-select (native ib_gather_columns),
        so host RAM holds only the (small) label matrix — the low-memory
        mode for datasets far beyond RAM."""
        self.stride = int(stride)
        self.window_size = int(window_size)
        self.output_data_format = output_data_format
        self.trial_filter = trial_filter
        self.materialize_features = materialize_features
        self.geometry_folder = geometry_folder
        self.dtype = dtype

        # -- subject discovery (parity: skip files containing 'vander') ----
        self.subject_paths: List[str] = []
        if os.path.isdir(data_path):
            for root, _dirs, files in os.walk(data_path):
                for f in sorted(files):
                    if f.endswith('.b3d') and 'vander' not in f.lower():
                        self.subject_paths.append(os.path.join(root, f))
        elif os.path.isfile(data_path):
            if not data_path.endswith('.b3d'):
                raise ValueError(f'{data_path}: expected a .b3d subject file')
            self.subject_paths.append(data_path)
        else:
            raise FileNotFoundError(
                f'{data_path}: no such file or directory (expected a .b3d '
                f'file or a directory containing .b3d files)')
        if testing_with_short_dataset:
            self.subject_paths = self.subject_paths[11:12] or self.subject_paths[:1]
        self.subject_indices = {p: i for i, p in enumerate(self.subject_paths)}

        # Legacy (nimble protobuf) .b3d files are auto-converted to B3D-TPU
        # once, next to the source, then mmap'd like native files
        # (data/b3d_legacy.py). The legacy schema tables are a
        # reconstruction not yet byte-validated against a real
        # AddBiomechanics file; conversion validates header invariants
        # and raises 'unrecognized legacy schema' (with a --verify
        # diagnosis path) rather than ingesting garbage on a mismatch.
        from inferbiomechanics_tpu_torch.data.b3d_legacy import ensure_tpu_format
        open_paths = [ensure_tpu_format(p) for p in self.subject_paths]
        self.subjects: List[SubjectOnDisk] = [SubjectOnDisk(p) for p in open_paths]

        # -- canonical contact-body order from the first subject ------------
        self.contact_bodies: List[str] = []
        if self.subjects:
            self.num_dofs = self.subjects[0].getNumDofs()
            self.root_history_len = self.subjects[0].getRootHistoryLen()
            for body in self.subjects[0].getGroundForceBodies():
                if body != 'pelvis' and body not in self.contact_bodies:
                    self.contact_bodies.append(body)
        else:
            self.num_dofs = 0
            self.root_history_len = 0
        self.num_contact_bodies = len(self.contact_bodies)

        self.skeletons = []
        if not skip_loading_skeletons:
            for s in self.subjects:
                try:
                    self.skeletons.append(s.readSkel(s.getNumProcessingPasses() - 1,
                                                     geometry_folder))
                except ValueError:
                    self.skeletons.append(None)

        # -- packed layouts --------------------------------------------------
        self.in_layout = input_layout(self.num_dofs, self.root_history_len)
        self.lab_layout = label_layout(self.num_dofs, self.num_contact_bodies)
        self.in_offsets = _offsets(self.in_layout)
        self.lab_offsets = _offsets(self.lab_layout)
        self.num_input_channels = sum(w for _, w in self.in_layout)
        self.num_label_channels = sum(w for _, w in self.lab_layout)

        # source-column map for on-demand featurization: packed input
        # layout -> kinematics-pass columns (identical across subjects)
        self.feature_col_idx = None
        if self.subjects:
            src_offs = self.subjects[0].field_offsets
            cols = []
            for key, _w in self.in_layout:
                o, w = src_offs[key]
                cols.extend(range(o, o + w))
            self.feature_col_idx = np.asarray(cols, np.int64)

        # -- featurize every trial once; build the global window table ------
        feats: List[np.ndarray] = []
        labs: List[np.ndarray] = []
        self.ft_to_subject_trial: List[Tuple[int, int]] = []
        trial_row_offset: List[int] = []
        win_ft: List[np.ndarray] = []      # flat-trial id per window
        win_subject: List[np.ndarray] = []
        win_trial: List[np.ndarray] = []
        win_start: List[np.ndarray] = []
        rows = 0
        ft_id = 0
        for s_idx, subject in enumerate(self.subjects):
            mass = subject.getMassKg()
            gfb = subject.getGroundForceBodies()
            contact_indices = [gfb.index(b) if b in gfb else -1
                               for b in self.contact_bodies]
            for t_idx in range(subject.getNumTrials()):
                # --trial-filter parity: only trials whose name contains the
                # filter substring participate (reference train.py:67-68)
                if (self.trial_filter and
                        self.trial_filter not in subject.getTrialName(t_idx)):
                    continue
                F, L = self._featurize_trial(subject, t_idx, mass, contact_indices,
                                             build_features=self.materialize_features)
                if F is not None:
                    feats.append(F)
                labs.append(L)
                self.ft_to_subject_trial.append((s_idx, t_idx))
                trial_row_offset.append(rows)
                rows += L.shape[0]

                starts = self._enumerate_starts(subject, t_idx)
                if starts.size:
                    win_ft.append(np.full(starts.shape, ft_id, np.int32))
                    win_subject.append(np.full(starts.shape, s_idx, np.int32))
                    win_trial.append(np.full(starts.shape, t_idx, np.int32))
                    win_start.append(starts.astype(np.int32))
                ft_id += 1

        if labs:
            self.features_all = (np.concatenate(feats, axis=0)
                                 if self.materialize_features else None)
            self.labels_all = np.concatenate(labs, axis=0)
        else:
            self.features_all = np.zeros((0, self.num_input_channels), np.float32)
            self.labels_all = np.zeros((0, self.num_label_channels), np.float32)
        self.trial_row_offset = np.asarray(trial_row_offset, np.int64)
        if win_ft:
            self.win_ft = np.concatenate(win_ft)
            self.win_subject = np.concatenate(win_subject)
            self.win_trial = np.concatenate(win_trial)
            self.win_start = np.concatenate(win_start)
        else:
            self.win_ft = np.zeros(0, np.int32)
            self.win_subject = np.zeros(0, np.int32)
            self.win_trial = np.zeros(0, np.int32)
            self.win_start = np.zeros(0, np.int32)

        self.num_model_frames = self.window_size // self.stride
        self.num_output_frames = (self.num_model_frames
                                  if output_data_format == 'all_frames' else 1)

    def inspect_dof_indices(self) -> None:
        """Assert the 23-DOF standard skeleton layout is identical across
        subjects (parity: AddBiomechanicsDataset.py:141-156)."""
        from collections import defaultdict
        index_to_dof = defaultdict(list)
        for i, subject in enumerate(self.subjects):
            names = subject.getDofNames()
            print(f'Subject {i + 1}/{len(self.subjects)}: {len(names)} DOFs')
            for j, name in enumerate(names):
                index_to_dof[j].append(name)
        assert len(index_to_dof) == 23, \
            f'{len(index_to_dof)} unique dof indices found, expected 23'
        for key, val in index_to_dof.items():
            assert len(val) == len(self.subjects), \
                f'{len(val)} entries at dof index {key}, expected {len(self.subjects)}'
            assert len(set(val)) == 1, \
                f'{len(set(val))} distinct dof names at index {key}, expected 1'

    # -- reference-parity window enumeration --------------------------------

    def _enumerate_starts(self, subject: SubjectOnDisk, trial: int) -> np.ndarray:
        """Vectorized version of AddBiomechanicsDataset.py:132-139."""
        T = subject.getTrialLength(trial)
        missing = np.asarray(
            [int(r) != int(MissingGRFReason.notMissingGRF)
             for r in subject.getMissingGRF(trial)], dtype=bool)
        n_starts = max(T - self.window_size - 1, 0)
        if n_starts == 0:
            return np.zeros(0, np.int32)
        # window k uses frames k + stride*[0..W/stride); a start is valid iff
        # none of those frames is missing.
        frame_idx = (np.arange(n_starts)[:, None] +
                     np.arange(0, self.window_size, self.stride)[None, :])
        bad = missing[frame_idx].any(axis=1)
        return np.nonzero(~bad)[0].astype(np.int32)

    # -- featurization (once per trial, fully vectorized) -------------------

    def featurize_trial_features(self, ft_id: int) -> np.ndarray:
        """Input features [T, C_in] of one flat trial, built on demand.

        The per-trial entry the pod-sharded device tier uses to
        materialize ONLY the trials owned by this process's shards
        (train/sharded_data.py) when the dataset was opened with
        ``materialize_features=False`` — host RAM then scales with the
        process count instead of every host holding the full matrix.
        """
        s_idx, t_idx = self.ft_to_subject_trial[ft_id]
        subject = self.subjects[s_idx]
        F, _ = self._featurize_trial(subject, t_idx, subject.getMassKg(),
                                     [], build_features=True,
                                     build_labels=False)
        return F

    def _featurize_trial(self, subject: SubjectOnDisk, trial: int, mass: float,
                         contact_indices: List[int],
                         build_features: bool = True,
                         build_labels: bool = True
                         ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        kin = subject.trial_pass_matrix(trial, 0)
        n_passes = subject.getTrialNumProcessingPasses(trial)
        offs = subject.field_offsets
        T = kin.shape[0]

        def col(mat, name):
            o, w = offs[name]
            return mat[:, o:o + w]

        # inputs — all from the kinematics pass (ref :174,181-210)
        F = None
        if build_features:
            F = np.empty((T, self.num_input_channels), np.float32)
            for key, (o, w) in self.in_offsets.items():
                F[:, o:o + w] = col(kin, key)
        if not build_labels:
            return F, None
        dyn = subject.trial_pass_matrix(trial, n_passes - 1)

        # labels — tau/residual/comAcc from last pass; GRF groups from the
        # FIRST pass (ref asymmetry :214-247), reindexed + mass-normalized.
        L = np.zeros((T, self.num_label_channels), np.float32)

        def put(key, val):
            o, w = self.lab_offsets[key]
            L[:, o:o + w] = val

        put(K.OutputDataKeys.TAU, col(dyn, 'tau'))
        put(K.OutputDataKeys.RESIDUAL_WRENCH_IN_ROOT_FRAME,
            col(dyn, 'residualWrenchInRootFrame'))
        put(K.OutputDataKeys.COM_ACC_IN_ROOT_FRAME, col(dyn, 'comAccInRootFrame'))

        src_wrench = col(kin, 'groundContactWrenchesInRootFrame')
        src_cop = col(kin, 'groundContactCenterOfPressureInRootFrame')
        src_torque = col(kin, 'groundContactTorqueInRootFrame')
        src_force = col(kin, 'groundContactForceInRootFrame')
        src_contact = col(kin, 'contact')

        ow, _ = self.lab_offsets[K.OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME]
        oc, _ = self.lab_offsets[K.OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME]
        ot, _ = self.lab_offsets[K.OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME]
        of, _ = self.lab_offsets[K.OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME]
        ob, _ = self.lab_offsets[K.OutputDataKeys.CONTACT]
        inv_mass = 1.0 / mass
        for i, src_i in enumerate(contact_indices):
            if src_i < 0:
                continue
            L[:, ow + 6 * i: ow + 6 * i + 6] = src_wrench[:, 6 * src_i:6 * src_i + 6] * inv_mass
            L[:, oc + 3 * i: oc + 3 * i + 3] = src_cop[:, 3 * src_i:3 * src_i + 3]
            L[:, ot + 3 * i: ot + 3 * i + 3] = src_torque[:, 3 * src_i:3 * src_i + 3] * inv_mass
            L[:, of + 3 * i: of + 3 * i + 3] = src_force[:, 3 * src_i:3 * src_i + 3] * inv_mass
            L[:, ob + i] = src_contact[:, src_i]
        return F, L

    # -- python Dataset protocol --------------------------------------------

    def __len__(self) -> int:
        return int(self.win_start.shape[0])

    def __getitem__(self, index: int):
        """Single-window fetch, dict form (compat path; hot path is gather)."""
        b = self.gather(np.asarray([index]))
        inputs = {k: b.inputs[0][..., o:o + w] for k, (o, w) in self.in_offsets.items()}
        labels = {k: b.labels[0][..., o:o + w] for k, (o, w) in self.lab_offsets.items()}
        return inputs, labels, int(b.subject_indices[0]), int(b.trial_indices[0])

    # -- the hot path --------------------------------------------------------

    def gather(self, indices: np.ndarray, n_threads: Optional[int] = None) -> Batch:
        """Assemble a fixed-shape batch; native C++ threaded gather when the
        library is built (native/ib_native.cpp), numpy otherwise.
        ``n_threads`` maps the reference's --data-loading-workers knob."""
        from inferbiomechanics_tpu_torch.data import native
        ft = self.win_ft[indices]
        start = self.win_start[indices]
        base = self.trial_row_offset[ft] + start            # [B]
        frames = self.num_model_frames
        if self.features_all is not None:
            inputs = native.gather_windows(self.features_all, base, frames,
                                           self.stride, n_threads=n_threads)
        else:
            # on-demand mode: fused column gather from the mmap'd
            # kinematics pass, grouped per trial
            inputs = np.empty((indices.shape[0], frames,
                               self.num_input_channels), np.float32)
            ones = np.ones(self.feature_col_idx.shape[0], np.float32)
            for f in np.unique(ft):
                sel = np.nonzero(ft == f)[0]
                s_idx, t_idx = self.ft_to_subject_trial[int(f)]
                kin = self.subjects[s_idx].trial_pass_matrix(t_idx, 0)
                inputs[sel] = native.gather_columns(
                    kin, start[sel].astype(np.int64), frames, self.stride,
                    self.feature_col_idx, ones, n_threads=n_threads)
        if self.output_data_format == 'all_frames':
            labels = native.gather_windows(self.labels_all, base, frames,
                                           self.stride, n_threads=n_threads)
        else:
            last = base + (frames - 1) * self.stride
            labels = native.gather_windows(self.labels_all, last, 1, 1,
                                           n_threads=n_threads)
        return Batch(inputs=inputs, labels=labels,
                     subject_indices=self.win_subject[indices],
                     trial_indices=self.win_trial[indices])

    def unpack_inputs(self, packed) -> Dict[str, 'np.ndarray']:
        return unpack(packed, self.in_offsets)

    def unpack_labels(self, packed) -> Dict[str, 'np.ndarray']:
        return unpack(packed, self.lab_offsets)

    # -- epoch iteration ------------------------------------------------------

    def batches(self, batch_size: int, *, shuffle: bool = True,
                drop_last: bool = True, seed: int = 0,
                shard_index: int = 0, num_shards: int = 1,
                n_threads: Optional[int] = None) -> Iterator[Batch]:
        """Yield batches; with sharding this replaces DistributedSampler."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        # Equalize shards: truncate to a multiple of num_shards so every
        # process yields an IDENTICAL batch count per epoch. Uneven shards
        # (up to +1 window) can floor-divide to one extra train step on one
        # host, and under SPMD that extra pjit dispatch is a collective the
        # other hosts never join — a multi-host deadlock. The reference's
        # DistributedSampler pads to equal length; we truncate instead
        # (drops < num_shards windows per epoch, reshuffled each epoch).
        order = order[:(n // num_shards) * num_shards]
        order = order[shard_index::num_shards]
        n_shard = order.shape[0]
        stop = (n_shard // batch_size) * batch_size if drop_last else n_shard
        for i in range(0, stop, batch_size):
            yield self.gather(order[i:i + batch_size], n_threads=n_threads)
