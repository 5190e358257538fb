"""``make-plots`` subcommand — dataset statistics / figures engine.

Capability parity: reference ``src/cli/make_plots.py`` (1,842 LoC) — the
paper-figure engine: per-trial validity filtering (kinematics pass ∧
dynamics pass ∧ notMissingGRF, ref :1476), histograms of trial lengths /
speeds / contact distribution / max GRF (ref :1200-1223), the contact
pie chart (ref :1225-1240), demographics aggregation with per-dataset
overrides and split-file dedup (age/sex/BMI, ref :1000-1052), the full
ScatterPlots matrix set (per-DOF joint pos/acc/tau vs COM-acc / total
GRF / first-contact / GRF-distribution, COM-acc vs GRF components, joint
centers vs GRF, root velocities/accelerations vs GRF — ref :560-616,
907-985,1735-1820), the ``TrialRaw`` kinematics-only variant (``--raw``,
ref :1623-1733), error-vs-frequency curves (Butterworth low-pass at
0..30 Hz, ref :420-444,1245-1260), and pickle caches replayable via
``make-plots-from-cache`` (ref :1331-1383). Computation is vectorized
over whole trial matrices instead of per-frame Python loops.

The port's copy of ``inferbiomechanics_tpu/cli/make_plots_cmd.py``, with its
flags: the statistics (:func:`collect_stats`, the classification rules, the
demographics, :func:`_butter_lowpass` on scipy, :func:`correlation`) are the
JAX code on the port's ``data/b3d.py::SubjectOnDisk`` and
``data/b3d_legacy.py::ensure_tpu_format``, the keyword classes are
``cli/motion.py``'s. :func:`render_plots` names the same figure files as the
JAX one: drawn by matplotlib where it is installed, else by
``utils/png_plot.py``. The cache pickle holds only builtins and numpy
values, so the JAX command, ``make_plots_from_cache.py`` and this one read
each other's caches. A host-side command: it runs no model and takes no
``--device``.

    python -m inferbiomechanics_tpu_torch make-plots --data-path D [--out-dir O] [--use-cache]
"""

from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from inferbiomechanics_tpu_torch.cli.motion import MOTION_CLASSES, classify_motion
from inferbiomechanics_tpu_torch.data.b3d import MissingGRFReason, SubjectOnDisk
from inferbiomechanics_tpu_torch.data.b3d_legacy import ensure_tpu_format
from inferbiomechanics_tpu_torch.utils import png_plot

GRAVITY_MAG = 9.81
FREQ_CUTOFFS = list(range(0, 31, 3))   # ref :1245 — [0, 3, ..., 30] Hz

# Motion-class labeling. Two tiers (ref :661-785):
#  1. classify_motion_ref — the reference's exact machinery: per-dataset
#     rule tables (Carter2023 / Han2023) plus manual-classification
#     dicts loaded from `<class_path>/<dataset>/<subj_id>/<subj_id>.npy`
#     (arrays of {'trial_name', 'motion_class'} records), with the
#     reference's relabeling quirks. Active when --class-path is given
#     or a rule-table dataset name appears in the subject path.
#  2. classify_motion (cli/motion.py) — generic trial-name keyword
#     fallback with the same class vocabulary, for data without
#     classification inputs.
CLASS_COLORS = {'walking': '#346beb', 'running': '#e0544f',
                'stairs': '#52b06d', 'jump': '#c87ae0', 'squat': '#e0a33e',
                'other': '#8a94a3', 'unknown': '#8a94a3',
                'walking_treadmill': '#346beb', 'walking_overground': '#5a8df0',
                'running_treadmill': '#e0544f', 'standing': '#7d8ca3',
                'jump_dropjump': '#c87ae0'}

# Datasets shipping one subject split across several .b3d files — their
# demographics must be counted once per unique subject (ref :626,1040-1052).
DATASETS_WITH_SPLITS = ('Camargo2021', 'Carter2023', 'Han2023')


def parse_subject_id(subj_path: str, raw: bool = False) -> str:
    """Subject ID from the file path (ref :662-674): processed AddB files
    are named ``..._no_arm_<id>.b3d``; raw data uses the bare basename.
    Unlike the reference (which raises), unmatched processed names fall
    back to the basename so arbitrary datasets still work."""
    import re
    base_id = os.path.splitext(os.path.basename(subj_path))[0]
    if raw:
        return base_id
    m = re.search(r'no_arm_(.*?)\.b3d', subj_path, re.IGNORECASE)
    return m.group(1) if m else base_id


def load_class_dict(class_dir: str, class_datasets: List[str],
                    subj_path: str, subj_id: str) -> Dict[str, str]:
    """Load the per-subject manual classification dict (ref :677-688):
    ``<class_dir>/<dataset>/<subj_id>/<subj_id>.npy`` holding an array of
    records with ``trial_name`` and ``motion_class`` keys."""
    name = next((n for n in class_datasets if n and n in subj_path), '')
    if not name:
        return {}
    path = os.path.join(class_dir, name, subj_id, subj_id + '.npy')
    if not os.path.exists(path):
        print(f'Did not find class dict for subject {subj_path}')
        return {}
    records = np.load(path, allow_pickle=True)
    return {r['trial_name']: r['motion_class'] for r in records}


def classify_motion_ref(subj_path: str, trial_name: str,
                        class_dict: Dict[str, str]) -> str:
    """The reference's exact classification rules (ref :732-785).

    Returns the motion class; a class containing 'bad' means the trial
    must be skipped entirely (ref :786-788).
    """
    if 'Carter2023' in subj_path:
        low = trial_name.lower()
        if 'static' in low:
            return 'standing'
        if 'walk' in low:
            return 'walking_treadmill'
        return 'running_treadmill'
    if 'Han2023' in subj_path:
        if any(m in trial_name for m in ('chair', '_squat_')):
            return 'squat'
        if any(m in trial_name for m in ('_hop_', 'balletsmalljump',
                                         'jumpingjack')):
            return 'jump'
        if '_step_' in trial_name:
            return 'stairs'
        if any(m in trial_name for m in ('_idling_', '_static')):
            return 'standing'
        if '_walk_' in trial_name:
            return 'walking_overground'
        return 'other'
    # manually classified datasets
    if class_dict:
        motion_class = class_dict.get(trial_name)
        if motion_class is None:
            motion_class = 'unknown'
    else:
        motion_class = 'unknown'
    if 'transition' in motion_class:
        motion_class = 'other'
    if motion_class == 'walking_ramp':   # Camargo ramp trials: overground
        motion_class = 'walking_overground'
    if 'Tan2021' in subj_path and 's9' in subj_path \
            and motion_class == 'unknown':
        motion_class = 'running_treadmill'
    if 'Uhlrich2023' in subj_path and 'subject2' in subj_path \
            and motion_class == 'unknown':
        motion_class = 'jump_dropjump'
    return motion_class


def apply_demographic_overrides(subj_path: str, subj_id: str, age: int,
                                sex: str, demo_csv: Optional[Dict] = None):
    """Per-dataset demographic fixes (ref :1007-1026): Fregly sexes are
    encoded in the file name; Carter2023 ages/sexes come from a
    demographics CSV (``Participant_code``/``Age (years)``/``Sex``)."""
    if 'Fregly' in subj_path:
        if '3GC' in subj_path:
            sex = 'female'
        elif '4GC' in subj_path or '6GC' in subj_path:
            sex = 'male'
    elif 'Carter2023' in subj_path and demo_csv:
        code = subj_id.split('_')[0]
        row = demo_csv.get(code)
        if row:
            age = int(float(row.get('Age (years)', age) or age))
            sex = row.get('Sex', sex) or sex
    return age, sex


def load_demographics_csv(data_path: str) -> Optional[Dict]:
    """Find a Carter2023-style demographics CSV under the data root."""
    import csv
    for root, _dirs, files in os.walk(data_path):
        for f in files:
            if f.lower().endswith('.csv') and 'demo' in f.lower():
                with open(os.path.join(root, f)) as fh:
                    rows = list(csv.DictReader(fh))
                if rows and 'Participant_code' in rows[0]:
                    return {r['Participant_code']: r for r in rows}
    return None


def estimate_mass(total_grf: 'np.ndarray', com_acc: 'np.ndarray',
                  valid: 'np.ndarray') -> float:
    """Mass estimate from ‖ΣGRF‖ / ‖a_com − g‖ over valid frames
    (capability parity: ref :371-418)."""
    g = np.array([0.0, -GRAVITY_MAG, 0.0])
    acc = com_acc[valid] - g[None, :]
    f = total_grf[valid]
    denom = np.linalg.norm(acc, axis=1)
    keep = denom > 1.0
    if not keep.any():
        return float('nan')
    return float(np.median(np.linalg.norm(f[keep], axis=1) / denom[keep]))


def stance_speed(root_vel: 'np.ndarray', contact: 'np.ndarray',
                 valid: 'np.ndarray') -> float:
    """Treadmill-aware mean speed: sagittal root speed averaged over
    stance frames only (capability parity: ref :253-281)."""
    stance = (contact.sum(axis=1) > 0) & valid
    if not stance.any():
        return float('nan')
    return float(np.linalg.norm(root_vel[stance][:, [0, 2]], axis=1).mean())


def _butter_lowpass(signal: np.ndarray, cutoff_hz: float, fs: float) -> np.ndarray:
    """Zero-phase 3rd-order Butterworth low-pass (ref :420-444)."""
    from scipy.signal import butter, filtfilt
    if cutoff_hz <= 0 or cutoff_hz >= fs / 2:
        return signal
    b, a = butter(3, cutoff_hz / (fs / 2), btype='low')
    return filtfilt(b, a, signal, axis=0)


# ---------------------------------------------------------------------------
# ScatterPlots matrix set (ref :560-616 definitions, :907-985 updates)
# ---------------------------------------------------------------------------

# (figure name, y sample key, x sample key, corr type, y in degrees)
PER_DOF_MATRICES = [
    ('jointacc_vs_comacc', 'joint_acc', 'comacc_y', 'pearson', False),
    ('jointacc_vs_totgrf', 'joint_acc', 'totgrf_y', 'pearson', False),
    ('jointacc_vs_firstcontact', 'joint_acc', 'contact_first', 'biserial', False),
    ('jointacc_vs_firstdist', 'joint_acc', 'grf_dist_y', 'pearson', False),
    ('jointpos_vs_comacc', 'joint_pos', 'comacc_y', 'pearson', True),
    ('jointpos_vs_totgrf', 'joint_pos', 'totgrf_y', 'pearson', True),
    ('jointpos_vs_firstcontact', 'joint_pos', 'contact_first', 'biserial', True),
    ('jointpos_vs_firstdist', 'joint_pos', 'grf_dist_y', 'pearson', True),
    ('jointpos_vs_totgrf_norm', 'joint_pos', 'totgrf_norm', 'pearson', True),
    ('jointtau_vs_comacc', 'joint_tau', 'comacc_y', 'pearson', False),
    ('jointtau_vs_totgrf', 'joint_tau', 'totgrf_y', 'pearson', False),
    ('jointtau_vs_firstcontact', 'joint_tau', 'contact_first', 'biserial', False),
    ('jointtau_vs_firstdist', 'joint_tau', 'grf_dist_y', 'pearson', False),
]

SINGLE_PLOTS = [
    ('comacc_vs_totgrf_x', 'comacc_kin_x', 'totgrf_x', 'pearson'),
    ('comacc_vs_totgrf_y', 'comacc_kin_y', 'totgrf_y', 'pearson'),
    ('comacc_vs_totgrf_z', 'comacc_kin_z', 'totgrf_z', 'pearson'),
    ('comacc_vs_firstcontact', 'comacc_kin_y', 'contact_first', 'biserial'),
    ('comacc_vs_firstdist', 'comacc_kin_y', 'grf_dist_y', 'pearson'),
    ('root_lin_vel_vs_totgrf', 'root_lin_vel_y', 'totgrf_y', 'pearson'),
    ('root_ang_vel_vs_totgrf', 'root_ang_vel_y', 'totgrf_y', 'pearson'),
    ('root_lin_acc_vs_totgrf', 'root_lin_acc_y', 'totgrf_y', 'pearson'),
    ('root_ang_acc_vs_totgrf', 'root_ang_acc_y', 'totgrf_y', 'pearson'),
    # the CVPR-paper hip-adduction singles (ref :979-985): DOF 7 = right
    # hip adduction, DOF 14 = left, in the rajagopal_no_arms DOF order
    ('jointpos_vs_firstdist_add_r', ('joint_pos', 7), 'grf_dist_y', 'pearson'),
    ('jointpos_vs_firstdist_add_l', ('joint_pos', 14), 'grf_dist_y', 'pearson'),
]


def correlation(x: np.ndarray, y: np.ndarray) -> float:
    """Pearson r (point-biserial is pearson with a binary x, ref :1781-1787;
    nan -> 0 like ref :1790)."""
    if x.size < 3 or np.std(x) == 0 or np.std(y) == 0:
        return 0.0
    r = float(np.corrcoef(x, y)[0, 1])
    return 0.0 if np.isnan(r) else r


def collect_stats(subject_paths: List[str], short: bool = False,
                  raw: bool = False, downsample: int = 10,
                  demo_csv: Optional[Dict] = None,
                  class_dir: str = '',
                  class_datasets: Optional[List[str]] = None,
                  scatter_random: bool = False) -> Dict:
    """One pass over all subjects -> the plot-data cache dict.

    ``raw=True`` is the TrialRaw variant (ref :1623-1733): kinematics-pass
    only — trials without a dynamics pass are still included, and the
    dynamics-dependent products (tau matrices, mass estimation,
    error-vs-frequency) are skipped.

    ``downsample`` is the reference's ``downsample_size`` frame stride
    for scatter samples (ref :909-985 ``[::downsample_size]``).

    ``class_dir``/``class_datasets`` activate the reference's motion
    classification machinery (``.npy`` class dicts + per-dataset rule
    tables, ref :661-785); otherwise trial-name keyword rules label the
    activity chart. Trials classified 'bad' are skipped entirely.
    """
    sf_keys = ['comacc_y', 'totgrf_x', 'totgrf_y', 'totgrf_z', 'totgrf_norm',
               'contact_first', 'grf_dist_y', 'comacc_kin_x', 'comacc_kin_y',
               'comacc_kin_z', 'root_lin_vel_y', 'root_ang_vel_y',
               'root_lin_acc_y', 'root_ang_acc_y']
    stats: Dict = {
        'raw': raw,
        'trial_lengths_s': [], 'speeds_m_s': [], 'max_grf_n_kg': [],
        'contact_counts': {'flight': 0, 'single': 0, 'double': 0},
        'ages': [], 'sexes': [], 'bmis': [], 'masses': [], 'heights': [],
        'dataset_n': {}, 'num_valid_subjs': 0,
        'freq_cutoffs': FREQ_CUTOFFS,
        'freq_rmse': {c: [] for c in FREQ_CUTOFFS},
        # same accumulation keyed by motion class for
        # err_vs_freq_by_motion.png (ref make_plots.py:1253-1260)
        'freq_rmse_by_motion': {},
        'num_subjects': 0, 'num_trials': 0, 'total_frames': 0,
        'valid_frames': 0, 'total_hours': 0.0,
        'motion_class_hours': {c: 0.0 for c in MOTION_CLASSES},
        'estimated_masses': [],
        'stance_speeds_m_s': [],
        'dof_names': [], 'joint_names': [],
        'scatter_frames': {k: [] for k in sf_keys},
        'scatter_class': [],
        'joint_pos': [], 'joint_acc': [], 'joint_tau': [],
        'joint_centers_y': [],
        # legacy summary kept for cache compatibility
        'scatter': {'joint_acc': [], 'total_grf': [], 'com_acc': [],
                    'grf_dist': []},
        'scatter_correlations': {},
    }
    if short:
        subject_paths = subject_paths[:2]
    seen_split_subjects = set()
    scatter_rng = np.random.default_rng(0)
    for path in subject_paths:
        # legacy protobuf files convert on first touch like WindowDataset
        s = SubjectOnDisk(ensure_tpu_format(path))
        subj_id = parse_subject_id(path, raw)
        class_dict = load_class_dict(class_dir, class_datasets or [],
                                     path, subj_id) if class_dir else {}
        # per-SUBJECT tier decision: the ref machinery applies only where
        # it has something to say about this subject (a rule table match
        # or a loaded class dict); other datasets in the same scan keep
        # the keyword fallback instead of degrading to 'unknown'
        use_ref_classes = bool(class_dict) or any(
            d in path for d in ('Carter2023', 'Han2023'))
        dataset_name = os.path.basename(os.path.dirname(path)) or 'unknown'
        mass = s.getMassKg()
        height = s.getHeightM()
        stats['num_subjects'] += 1
        if not stats['dof_names']:
            stats['dof_names'] = s.getDofNames()
            stats['joint_names'] = list(s.header.get(
                'joint_names', [f'joint_{i}' for i in range(12)]))
        offs = s.field_offsets

        def col(mat, name):
            o, w = offs[name]
            return mat[:, o:o + w]

        subj_valid_trials = 0
        for trial in range(s.getNumTrials()):
            # --scatter-random skips the WHOLE trial (every statistic),
            # keeping ~40% (lunge trials always kept) — ref :698-701
            if (scatter_random
                    and 'lunge' not in s.getTrialName(trial).lower()
                    and scatter_rng.random() < 0.6):
                continue
            n_passes = s.getTrialNumProcessingPasses(trial)
            if not raw and n_passes < 2:
                continue   # validity filter: needs a dynamics pass (ref :1476)
            # motion classification (ref :661-788); 'bad' skips the trial
            if use_ref_classes:
                cls = classify_motion_ref(path, s.getTrialName(trial),
                                          class_dict)
                if 'bad' in cls:
                    print(f'SKIPPING TRIAL {trial + 1} '
                          f'({s.getTrialName(trial)}) for {path} because '
                          f'motion_class = bad')
                    continue
            else:
                cls = classify_motion(s.getTrialName(trial))
            subj_valid_trials += 1
            stats['num_trials'] += 1
            T = s.getTrialLength(trial)
            dt = s.getTrialTimestep(trial)
            fs = 1.0 / dt
            stats['trial_lengths_s'].append(T * dt)
            stats['total_frames'] += T
            stats['total_hours'] += T * dt / 3600.0
            kin = s.trial_pass_matrix(trial, 0)
            dyn = kin if raw else s.trial_pass_matrix(trial, n_passes - 1)
            valid = np.asarray([int(r) == int(MissingGRFReason.notMissingGRF)
                                for r in s.getMissingGRF(trial)])
            if raw:
                valid = np.ones(T, bool)  # TrialRaw keeps all frames
            stats['valid_frames'] += int(valid.sum())

            # forward speed from root linear velocity (sagittal magnitude)
            v = col(kin, 'rootLinearVelInRootFrame')
            if valid.any():
                stats['speeds_m_s'].append(float(np.linalg.norm(
                    v[valid][:, [0, 2]], axis=1).mean()))

            grf = col(dyn, 'groundContactForce')
            nb = grf.shape[1] // 3
            grf_vecs = grf.reshape(T, nb, 3)
            total_grf = grf_vecs.sum(axis=1)
            if valid.any():
                stats['max_grf_n_kg'].append(
                    float(np.linalg.norm(total_grf[valid], axis=1).max() / mass))

            contact = col(dyn, 'contact')[:, :2]
            n_contact = (contact > 0.5).sum(axis=1)
            stats['contact_counts']['flight'] += int((n_contact[valid] == 0).sum())
            stats['contact_counts']['single'] += int((n_contact[valid] == 1).sum())
            stats['contact_counts']['double'] += int((n_contact[valid] >= 2).sum())

            # error-vs-frequency: kinematics COM acc vs GRF/mass - g
            if not raw:
                com_acc_kin = col(kin, 'comAcc')
                grf_acc = total_grf / mass
                grf_acc = grf_acc + np.array([0.0, -GRAVITY_MAG, 0.0])[None, :]
                if valid.sum() > 30:
                    by_motion = stats['freq_rmse_by_motion'].setdefault(
                        cls, {c: [] for c in FREQ_CUTOFFS})
                    for c in FREQ_CUTOFFS:
                        filt = _butter_lowpass(com_acc_kin, c, fs) if c > 0 \
                            else np.zeros_like(com_acc_kin)
                        err = filt[valid] - grf_acc[valid]
                        rmse = float(np.sqrt((err ** 2).mean()))
                        stats['freq_rmse'][c].append(rmse)
                        by_motion[c].append(rmse)

            # motion-class hours for the activity chart (ref :91-162);
            # cls was computed at the top of the trial loop
            stats['motion_class_hours'][cls] = \
                stats['motion_class_hours'].get(cls, 0.0) + T * dt / 3600.0

            if not raw:
                # mass estimation from dynamics (ref :371-418)
                m_est = estimate_mass(total_grf, col(dyn, 'comAcc'), valid)
                if np.isfinite(m_est):
                    stats['estimated_masses'].append(m_est)

            # treadmill-aware stance-phase speed (ref :253-281)
            sp = stance_speed(v, contact > 0.5, valid)
            if np.isfinite(sp):
                stats['stance_speeds_m_s'].append(sp)

            # scatter samples at the ref's downsample_size frame stride
            if valid.any():
                idx = np.nonzero(valid)[0][::max(1, int(downsample))]
                tg = total_grf[idx] / mass
                first = grf_vecs[idx, 0]
                # share of vertical GRF on the first body; only meaningful
                # when total vertical GRF is positive (weight-bearing)
                tot_y = total_grf[idx, 1]
                with np.errstate(invalid='ignore', divide='ignore'):
                    dist_y = np.where(tot_y > 1e-6,
                                      first[:, 1] / np.where(tot_y > 1e-6,
                                                             tot_y, 1.0),
                                      0.0)
                sf = stats['scatter_frames']
                sf['comacc_y'] += col(dyn, 'comAcc')[idx, 1].tolist()
                sf['totgrf_x'] += tg[:, 0].tolist()
                sf['totgrf_y'] += tg[:, 1].tolist()
                sf['totgrf_z'] += tg[:, 2].tolist()
                sf['totgrf_norm'] += np.linalg.norm(tg, axis=1).tolist()
                sf['contact_first'] += (contact[idx, 0] > 0.5).astype(
                    float).tolist()
                sf['grf_dist_y'] += dist_y.tolist()
                ca_kin = col(kin, 'comAcc')[idx]
                sf['comacc_kin_x'] += ca_kin[:, 0].tolist()
                sf['comacc_kin_y'] += ca_kin[:, 1].tolist()
                sf['comacc_kin_z'] += ca_kin[:, 2].tolist()
                sf['root_lin_vel_y'] += col(kin, 'rootLinearVelInRootFrame')[idx, 1].tolist()
                sf['root_ang_vel_y'] += col(kin, 'rootAngularVelInRootFrame')[idx, 1].tolist()
                sf['root_lin_acc_y'] += col(kin, 'rootLinearAccInRootFrame')[idx, 1].tolist()
                sf['root_ang_acc_y'] += col(kin, 'rootAngularAccInRootFrame')[idx, 1].tolist()
                stats['scatter_class'] += [cls] * len(idx)
                stats['joint_pos'] += col(kin, 'pos')[idx].tolist()
                stats['joint_acc'] += col(kin, 'acc')[idx].tolist()
                stats['joint_tau'] += col(dyn, 'tau')[idx].tolist()
                stats['joint_centers_y'] += col(
                    kin, 'jointCentersInRootFrame')[idx].reshape(
                        len(idx), -1, 3)[:, :, 1].tolist()

                # legacy summary samples
                stats['scatter']['joint_acc'] += np.linalg.norm(
                    col(kin, 'acc')[idx], axis=1).tolist()
                stats['scatter']['total_grf'] += np.linalg.norm(tg, axis=1).tolist()
                stats['scatter']['com_acc'] += np.linalg.norm(
                    col(dyn, 'comAcc')[idx], axis=1).tolist()
                stats['scatter']['grf_dist'] += dist_y.tolist()

        # Demographics only for subjects with ≥1 valid trial, dedup'd for
        # split datasets (ref :1000-1052)
        if subj_valid_trials >= 1:
            age = s.getAgeYears()
            sex = s.getBiologicalSex()
            age, sex = apply_demographic_overrides(path, subj_id, age, sex,
                                                   demo_csv)
            sex_int = {'male': 0, 'female': 1}.get(sex.lower(), 2)
            bmi = mass / max(height * height, 1e-6)
            count_it = True
            if any(d in path for d in DATASETS_WITH_SPLITS):
                unique = subj_id.split('_')[0]
                if unique in seen_split_subjects:
                    count_it = False
                seen_split_subjects.add(unique)
            if count_it:
                stats['num_valid_subjs'] += 1
                stats['dataset_n'][dataset_name] = \
                    stats['dataset_n'].get(dataset_name, 0) + 1
                stats['ages'].append(age)
                stats['sexes'].append(sex_int)
                stats['bmis'].append(bmi)
                stats['masses'].append(mass)
                stats['heights'].append(height)

    # Pearson correlations between legacy scatter dims (ref :1778-1789)
    sc = {k: np.asarray(v) for k, v in stats['scatter'].items()}
    keys = list(sc.keys())
    for i in range(len(keys)):
        for j in range(i + 1, len(keys)):
            stats['scatter_correlations'][f'{keys[i]}~{keys[j]}'] = \
                correlation(sc[keys[i]], sc[keys[j]])
    return stats


def _render_scatter_matrix(plt, stats, name, ykey, xkey, corr_type,
                           in_degrees, out_dir, written, max_cols=4):
    x = np.asarray(stats['scatter_frames'][xkey])
    if isinstance(ykey, tuple):
        base, dof = ykey
        Y = np.asarray(stats[base])
        if Y.ndim != 2 or Y.shape[1] <= dof:
            return
        Y = Y[:, dof:dof + 1]
        labels = [stats['dof_names'][dof] if dof < len(stats['dof_names'])
                  else f'dof_{dof}']
    elif ykey in ('joint_pos', 'joint_acc', 'joint_tau'):
        Y = np.asarray(stats[ykey])
        labels = stats['dof_names']
    elif ykey == 'joint_centers_y':
        Y = np.asarray(stats[ykey])
        labels = stats['joint_names']
    else:
        Y = np.asarray(stats['scatter_frames'][ykey]).reshape(-1, 1)
        labels = ['']
    if Y.size == 0 or x.size == 0 or len(x) != len(Y):
        return
    classes = np.asarray(stats.get('scatter_class', ['other'] * len(x)))
    n = Y.shape[1]
    if n == 1:
        fig = png_plot.Figure(figsize=(5, 4.2), title=name, dpi=100)
    else:
        rows = -(-n // max_cols)
        fig = png_plot.Figure(rows, max_cols, figsize=(3.2 * max_cols, 2.6 * rows),
                              title=name, dpi=100)
    for i in range(n):
        y = np.degrees(Y[:, i]) if in_degrees else Y[:, i]
        panel = fig[i]
        for cls in sorted(set(classes)):
            m = classes == cls
            panel.points(x[m], y[m], color=CLASS_COLORS.get(cls, '#8a94a3'), label=cls)
        r = correlation(x, y)
        label = labels[i] if i < len(labels) else str(i)
        panel.title = f'{label}  ({corr_type} r={r:.2f})'
    path = os.path.join(out_dir, f'scatter_{name}.png')
    fig.save(path, plt)
    written.append(path)


def render_plots(stats: Dict, out_dir: str,
                 scatter_matrices: bool = True,
                 groups: Optional[set] = None) -> List[str]:
    """Render the figure set to PNG files, by matplotlib where it is
    installed, else by ``utils/png_plot.py`` (the same files).

    ``groups`` mirrors the reference's output toggles (make_plots.py:67-80):
    a subset of {'histograms', 'errvfreq', 'scatterplots'}; None renders
    everything.
    """
    plt = png_plot.pyplot()
    os.makedirs(out_dir, exist_ok=True)
    written = []

    def enabled(group):
        return groups is None or group in groups

    def figure(figsize=(5, 4), **kw):
        fig = png_plot.Figure(figsize=figsize)
        for k, v in kw.items():
            setattr(fig[0], k, v)
        return fig, fig[0]

    def save(fig, name):
        path = os.path.join(out_dir, name)
        fig.save(path, plt)
        written.append(path)

    hist_specs = [('trial_lengths_s', 'Trial lengths', 's'),
                  ('speeds_m_s', 'Mean speeds', 'm/s'),
                  ('stance_speeds_m_s', 'Stance-phase speeds', 'm/s'),
                  ('max_grf_n_kg', 'Max total GRF', 'N/kg'),
                  ('ages', 'Ages', 'years'),
                  ('estimated_masses', 'Estimated masses', 'kg'),
                  ('bmis', 'BMI', 'kg/m^2')]
    for key, title, unit in hist_specs if enabled('histograms') else []:
        data = stats.get(key, [])
        if len(data):
            fig, panel = figure(title=title, xlabel=unit, ylabel='count')
            panel.hist(np.asarray(data, np.float64), bins=min(30, max(5, len(data))),
                       colors=('#346beb',))
            save(fig, f'hist_{key}.png')

    cc = stats['contact_counts']
    if enabled('histograms') and sum(cc.values()) > 0:
        fig, panel = figure(title='Contact distribution')
        panel.pie(list(cc.values()), labels=list(cc.keys()))
        save(fig, 'contact_pie.png')

    mc = stats.get('motion_class_hours', {})
    if enabled('histograms') and any(v > 0 for v in mc.values()):
        names = [k for k, v in mc.items() if v > 0]
        fig, panel = figure((6, 4), title='Hours by activity class', ylabel='hours',
                            xticks=names)
        panel.bars(range(len(names)), [mc[k] for k in names], color='#346beb')
        save(fig, 'activity_bars.png')

    # demographics broken down by biological sex (ref make_plots.py:
    # 1157-1198 plot_demographics_by_sex_{histograms,boxplots}; sex codes
    # male=0 female=1 unknown=2, ref :1164-1166)
    sexes = np.asarray(stats.get('sexes', []))
    ages = np.asarray(stats.get('ages', []), float)
    bmis = np.asarray(stats.get('bmis', []), float)
    if enabled('histograms') and sexes.size and ages.size == sexes.size:
        sex_colors = ['#006BA4', '#FF800E', '#ABABAB']
        sex_labels = ['male', 'female', 'unknown']
        groups_ix = [np.where(sexes == code)[0] for code in (0, 1, 2)]
        for data, unit, outname in [
                (ages, 'age (years)', 'age_bysex_histo.png'),
                (bmis, 'BMI (kg/m^2)', 'bmi_bysex_histo.png')]:
            fig, panel = figure(ylabel='no. of subjects', xlabel=unit, legend=True)
            panel.hist([data[ix] for ix in groups_ix], bins=6, colors=sex_colors,
                       labels=sex_labels)
            save(fig, outname)
        # boxplots: male/female only, restricted to plausible age/BMI
        # (ref :1180-1182: age > 0, BMI > 11)
        valid = (ages > 0) & (bmis > 11)
        m_ix = np.where(valid & (sexes == 0))[0]
        f_ix = np.where(valid & (sexes == 1))[0]
        if m_ix.size or f_ix.size:
            for data, unit, outname in [
                    (ages, 'age (years)', 'age_bysex_boxplot.png'),
                    (bmis, 'BMI (kg/m^2)', 'bmi_bysex_boxplot.png')]:
                fig, panel = figure((4, 4), ylabel=unit)
                panel.box([data[m_ix], data[f_ix]], labels=['male', 'female'])
                save(fig, outname)

    dn = stats.get('dataset_n', {})
    if enabled('histograms') and dn:
        fig, panel = figure((6, 4), title='Valid subjects per dataset', ylabel='subjects',
                            xticks=list(dn.keys()), xtick_rotation=30)
        panel.bars(range(len(dn)), list(dn.values()), color='#52b06d')
        save(fig, 'dataset_subjects.png')

    # full ScatterPlots matrix set (ref :560-616,907-985)
    if enabled('scatterplots') and scatter_matrices \
            and stats.get('scatter_frames', {}).get('totgrf_y'):
        matrices = [m for m in PER_DOF_MATRICES
                    if not (stats.get('raw') and m[1] == 'joint_tau')]
        for name, ykey, xkey, corr_type, in_deg in matrices:
            _render_scatter_matrix(plt, stats, name, ykey, xkey, corr_type,
                                   in_deg, out_dir, written)
        _render_scatter_matrix(plt, stats, 'jointcenters_vs_totgrf',
                               'joint_centers_y', 'totgrf_y', 'pearson',
                               False, out_dir, written, max_cols=3)
        for name, ykey, xkey, corr_type in SINGLE_PLOTS:
            _render_scatter_matrix(plt, stats, name, ykey, xkey, corr_type,
                                   name.startswith('jointpos'), out_dir,
                                   written)

    # legacy 4-pair summary figure
    sc = {k: np.asarray(v) for k, v in stats.get('scatter', {}).items()}
    pairs = [('joint_acc', 'total_grf'), ('com_acc', 'total_grf'),
             ('total_grf', 'grf_dist'), ('joint_acc', 'com_acc')]
    ready = [(a, b) for a, b in pairs
             if sc.get(a) is not None and sc[a].size > 2 and sc[b].size == sc[a].size]
    if enabled('scatterplots') and ready:
        n = len(ready)
        fig = png_plot.Figure(1, n, figsize=(4 * n, 3.6))
        corr = stats.get('scatter_correlations', {})
        for panel, (a, b) in zip(fig.panels, ready):
            panel.points(sc[a], sc[b], color='#346beb', alpha=0.3)
            r = corr.get(f'{a}~{b}', corr.get(f'{b}~{a}'))
            panel.title = f'{a} vs {b}' + (f'  (r={r:.2f})' if r is not None else '')
            panel.xlabel, panel.ylabel = a, b
        save(fig, 'scatter_matrix.png')

    fr = stats['freq_rmse']
    cutoffs = [c for c in stats['freq_cutoffs'] if fr[c]]
    if enabled('errvfreq') and cutoffs:
        fig, panel = figure(title='COM acc vs GRF/mass RMSE by low-pass cutoff',
                            xlabel='cutoff (Hz)', ylabel='RMSE (m/s^2)')
        panel.line(cutoffs, [float(np.mean(fr[c])) for c in cutoffs], color='#1f77b4',
                   linewidth=1.5, marker=True)
        save(fig, 'err_vs_frequency.png')

    # per-motion-class error-vs-frequency curves (ref make_plots.py:
    # 1253-1260: sorted class names, class colors, 'unknown'/'bad'
    # excluded) with the reference's optional std band (ref :1094-1096)
    frm = stats.get('freq_rmse_by_motion', {})
    classes = [c for c in sorted(frm)
               if c not in ('unknown', 'bad')
               and any(frm[c][k] for k in stats['freq_cutoffs'])]
    if enabled('errvfreq') and classes:
        fig, panel = figure(title='COM acc vs GRF/mass RMSE by cutoff, per motion class',
                            xlabel='cutoff (Hz)', ylabel='RMSE (m/s^2)', legend=True)
        for cls in classes:
            cuts = [c for c in stats['freq_cutoffs'] if frm[cls][c]]
            means = np.array([float(np.mean(frm[cls][c])) for c in cuts])
            color = CLASS_COLORS.get(cls, '#8a94a3')
            panel.line(cuts, means, color=color, label=cls, marker=True)
            stds = np.array([float(np.std(frm[cls][c])) for c in cuts])
            if np.any(stds > 0):
                panel.band(cuts, means - stds, means + stds, color=color)
        save(fig, 'err_vs_freq_by_motion.png')
    return written


def register_subcommand(sub) -> None:
    parser = sub.add_parser(
        'make-plots', help='Compute dataset statistics and render figures')
    parser.add_argument('--data-path', type=str, default='../data')
    parser.add_argument('--datasets', type=str, nargs='+', default=[''],
                        help='Restrict to subject paths containing any '
                             'of these dataset names (ref :26)')
    parser.add_argument('--class-path', type=str, default='',
                        help='Root dir of motion-classification .npy '
                             'dicts: <class-path>/<dataset>/<subj>/'
                             '<subj>.npy (ref :27,677-688)')
    parser.add_argument('--class-datasets', type=str, nargs='+',
                        default=['none'],
                        help='Dataset names that have classification '
                             'data under --class-path (ref :28)')
    parser.add_argument('--downsample-size', type=int, default=10,
                        help='Frame stride for scatter samples '
                             '(ref :30)')
    parser.add_argument('--out-dir', '--out-path', dest='out_dir',
                        type=str, default='outputs/plots',
                        help='Figure output dir (ref flag: --out-path)')
    parser.add_argument('--scatter-random', action='store_true',
                        help='Randomly skip ~60%% of non-lunge trials '
                             'entirely, like the reference subsampling '
                             'for scatter plots (ref :532,698-701)')
    # the single pickle cache already persists both figure groups;
    # the reference split them into two flags (ref :49-51)
    parser.add_argument('--save-histo-data', action='store_true')
    parser.add_argument('--save-scatter-data', action='store_true')
    parser.add_argument('--cache', type=str, default='outputs/plots/cache.pkl')
    parser.add_argument('--use-cache', action='store_true',
                        help='Replay an existing cache instead of rescanning')
    parser.add_argument('--short', action='store_true')
    parser.add_argument('--raw', '--raw-data', dest='raw',
                        action='store_true',
                        help='TrialRaw variant: kinematics-only stats, '
                             'no dynamics pass required (ref flag: '
                             '--raw-data, :1623-1733)')
    parser.add_argument('--no-scatter', action='store_true',
                        help='Skip the per-DOF scatter matrix figures')
    # reference output toggles (ref :33-41). Unlike the reference
    # (which renders NOTHING unless asked), passing none of these
    # renders every figure group.
    parser.add_argument('--output-histograms', action='store_true')
    parser.add_argument('--output-scatterplots', action='store_true')
    parser.add_argument('--output-errvfreq', action='store_true')
    parser.add_argument('--output-subjmetrics', action='store_true',
                        help='Print aggregated subject demographics '
                             '(ref :1309-1317)')
    parser.add_argument('--output-trialmetrics', action='store_true',
                        help='Print aggregated trial metrics '
                             '(ref :1319-1330)')


def subject_paths(args: argparse.Namespace) -> List[str]:
    """The ``.b3d`` files under ``--data-path`` (none with 'vander' in its
    name), restricted to ``--datasets``."""
    dataset_filter = [d for d in args.datasets if d.strip()]
    paths = []
    for root, _dirs, files in os.walk(args.data_path):
        for fname in sorted(files):
            if fname.endswith('.b3d') and 'vander' not in fname.lower():
                p = os.path.join(root, fname)
                if dataset_filter and not any(d in p for d in dataset_filter):
                    continue
                paths.append(p)
    return paths


def run(args: argparse.Namespace) -> int:
    if args.use_cache and os.path.exists(args.cache):
        with open(args.cache, 'rb') as f:
            stats = pickle.load(f)
        print(f'loaded cache {args.cache}')
    else:
        paths = subject_paths(args)
        print(f'scanning {len(paths)} subjects...')
        # ref :698 gates the random trial skip on output_scatterplots
        # too; with no output_* toggle given, every group renders,
        # which counts as scatterplots being on
        any_toggle = any([args.output_histograms,
                          args.output_scatterplots, args.output_errvfreq])
        scatter_on = args.output_scatterplots or not any_toggle
        stats = collect_stats(paths, short=args.short, raw=args.raw,
                              downsample=args.downsample_size,
                              demo_csv=load_demographics_csv(args.data_path),
                              class_dir=args.class_path,
                              class_datasets=args.class_datasets,
                              scatter_random=args.scatter_random
                              and scatter_on)
        os.makedirs(os.path.dirname(os.path.abspath(args.cache)), exist_ok=True)
        with open(args.cache, 'wb') as f:
            pickle.dump(stats, f)
        print(f'wrote cache {args.cache}')

    print(f"subjects={stats['num_subjects']} trials={stats['num_trials']} "
          f"hours={stats['total_hours']:.2f} "
          f"valid_frames={stats['valid_frames']}/{stats['total_frames']} "
          f"valid_subjects={stats.get('num_valid_subjs', 0)} "
          f"datasets={stats.get('dataset_n', {})}")
    if args.output_subjmetrics:   # ref :1309-1317
        print(f"ages: {stats.get('ages', [])}")
        print(f"bmis: {stats.get('bmis', [])}")
        print(f"sexes: {stats.get('sexes', [])}")
    if args.output_trialmetrics:  # ref :1319-1330
        print(f"trial_lengths_s: {stats.get('trial_lengths_s', [])}")
        print(f"speeds_m_s: {stats.get('speeds_m_s', [])}")
        print(f"stance_speeds_m_s: {stats.get('stance_speeds_m_s', [])}")
    toggles = {'histograms': args.output_histograms,
               'scatterplots': args.output_scatterplots,
               'errvfreq': args.output_errvfreq}
    groups = ({g for g, on in toggles.items() if on}
              if any(toggles.values()) else None)
    for path in render_plots(stats, args.out_dir,
                             scatter_matrices=not args.no_scatter,
                             groups=groups):
        print(f'wrote {path}')
    return 0
