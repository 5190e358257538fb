"""B3D-TPU subject store: the framework's native biomechanics file format.

Capability parity: ``nimble.biomechanics.SubjectOnDisk`` as consumed by the
reference (SURVEY.md §2.9; reference src/data/AddBiomechanicsDataset.py:104-139,
161-172) — subject header (mass/height/age/sex, DOFs, ground-force bodies),
per-trial processing passes (kinematics → dynamics), per-frame missing-GRF
reasons, and random access to frame windows.

TPU-first redesign (NOT a port of nimble's length-prefixed-protobuf layout):
frames are stored as contiguous ``[num_frames, num_channels]`` float32
matrices per (trial, processing pass), 64-byte aligned, memory-mapped on
read. A training window is a strided row slice of an mmap — O(1) and
zero-decode — versus the reference's per-window ``readFrames`` protobuf
decode, which SURVEY.md §3.5 identifies as the dominant throughput
bottleneck. The header is a single JSON blob (metadata is cold data; only
frame payloads need to be fast).

File layout (version 2; v2 == v1 bytes with a revised MissingGRFReason
enum — values 9/10 swapped to match nimble's ordering and 11-18 added —
so v1 files are rejected with a reconvert hint rather than silently
reinterpreting those reason codes)::

    bytes 0..4    magic  b"B3DT"
    bytes 4..8    u32 version
    bytes 8..16   u64 header_json_length
    ...           header JSON (utf-8)
    (64-aligned)  frame blobs, each [T, C] float32 row-major, 64-aligned

The header records, per (trial, pass), the blob byte offset and shape.
A converter from nimble's protobuf ``.b3d`` can be layered on top when
nimblephysics is importable (``from_nimble`` below); everything else in the
framework only speaks this interface.
"""

from __future__ import annotations

import json
import mmap
import struct
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

MAGIC = b'B3DT'
# v2: MissingGRFReason enum revision (9/10 swapped, 11-18 added). The
# byte layout is unchanged, but v1 files carry the old enum meaning for
# reasons >= 9, so they are rejected instead of silently reinterpreted
# (ADVICE r2): B3D-TPU files are caches — delete and reconvert.
VERSION = 2
_ALIGN = 64


def is_current_b3dt(path: str) -> bool:
    """True iff `path` is a B3D-TPU file of the CURRENT format version.

    Cache-reuse paths (ensure_tpu_format, convert-b3d) use this so files
    written before a version bump are transparently reconverted instead
    of failing at open time.
    """
    try:
        with open(path, 'rb') as f:
            if f.read(4) != MAGIC:
                return False
            version, = struct.unpack('<I', f.read(4))
            return version == VERSION
    except (OSError, struct.error):
        return False


class ProcessingPassType(IntEnum):
    """Parity with nimble.biomechanics.ProcessingPassType (SURVEY.md §2.9)."""
    KINEMATICS = 0
    DYNAMICS = 1
    LOW_PASS_FILTER = 2
    ACC_MINIMIZING_FILTER = 3


class MissingGRFReason(IntEnum):
    """Why a frame's ground-reaction-force labels are untrustworthy.

    ``notMissingGRF`` (== 0) marks a clean frame; anything else excludes the
    frame from training windows (reference AddBiomechanicsDataset.py:134-139).
    """
    notMissingGRF = 0
    measuredGrfZeroWhenAccelerationNonZero = 1
    unmeasuredExternalForceDetected = 2
    torqueDiscrepancy = 3
    forceDiscrepancy = 4
    notOverForcePlate = 5
    missingImpact = 6
    missingBlip = 7
    shiftGRF = 8
    interpolatedClippedGRF = 9
    manualReview = 10
    footContactDetectedButNoForce = 11
    tooHighMarkerRMS = 12
    hasInputOutliers = 13
    hasNoForcePlateData = 14
    velocitiesStillTooHighAfterFiltering = 15
    copOutsideConvexFootError = 16
    zeroForceFrame = 17
    extendedToNearestPeakForce = 18


# ---------------------------------------------------------------------------
# Per-pass frame channel layout
# ---------------------------------------------------------------------------

def pass_channel_layout(num_dofs: int, num_contact_bodies: int,
                        root_history_len: int) -> List[Tuple[str, int]]:
    """Ordered (field, width) channel layout of one processing-pass matrix.

    Field names mirror the nimble FramePass attributes the reference consumes
    (SURVEY.md §2.9: AddBiomechanicsDataset.py:181-247, make_plots.py:1479-1524).
    """
    d, nb, rh = num_dofs, num_contact_bodies, root_history_len
    return [
        ('pos', d),
        ('vel', d),
        ('acc', d),
        ('tau', d),
        ('comPos', 3),
        ('comVel', 3),
        ('comAcc', 3),
        ('comAccInRootFrame', 3),
        ('residualWrenchInRootFrame', 6),
        ('jointCentersInRootFrame', 12 * 3),
        ('rootLinearVelInRootFrame', 3),
        ('rootAngularVelInRootFrame', 3),
        ('rootLinearAccInRootFrame', 3),
        ('rootAngularAccInRootFrame', 3),
        ('rootPosHistoryInRootFrame', rh * 3),
        ('rootEulerHistoryInRootFrame', rh * 3),
        # Root world transform (position + euler XYZ) so viz / analytics can
        # reconstruct world-frame motion without FK.
        ('rootPosInWorld', 3),
        ('rootEulerInWorld', 3),
        # Ground contact, root frame.
        ('groundContactWrenchesInRootFrame', 6 * nb),
        ('groundContactCenterOfPressureInRootFrame', 3 * nb),
        ('groundContactTorqueInRootFrame', 3 * nb),
        ('groundContactForceInRootFrame', 3 * nb),
        # Ground contact, world frame (consumed by make-plots / review tools).
        ('groundContactWrenches', 6 * nb),
        ('groundContactCenterOfPressure', 3 * nb),
        ('groundContactTorque', 3 * nb),
        ('groundContactForce', 3 * nb),
        ('contact', nb),
    ]


def layout_offsets(layout: Sequence[Tuple[str, int]]) -> Dict[str, Tuple[int, int]]:
    """Map field -> (start_col, width)."""
    out, off = {}, 0
    for name, width in layout:
        out[name] = (off, width)
        off += width
    return out


def layout_total(layout: Sequence[Tuple[str, int]]) -> int:
    return sum(w for _, w in layout)


# ---------------------------------------------------------------------------
# Skeleton spec (header-resident; consumed by ops.skeleton for FK/ID)
# ---------------------------------------------------------------------------

@dataclass
class JointSpec:
    """One joint in the kinematic tree.

    type: 'free' (6-DOF root: 3 rotation DOFs then 3 translation),
          'ball' (3 rotation DOFs), or 'revolute' (1 DOF about ``axis``).
    ``translation`` is the joint center offset in the parent body frame.

    OpenSim-fidelity fields (all default to the legacy no-op values, so
    old specs / serialized skeletons keep their exact semantics):

    - ``orientation``: euler-XYZ rotation of the PARENT offset frame
      (OpenSim PhysicalOffsetFrame <orientation>), applied before the
      joint motion.
    - ``child_translation`` / ``child_orientation``: the CHILD body's
      offset frame; the joint connects parent offset frame to child
      offset frame, so the child BODY transform post-multiplies the
      inverse of this offset.
    - ``rot_axes``: for 'ball'/'free' CustomJoints, the three ordered
      rotation axes (e.g. Rajagopal hips rotate about z, x, y). ``None``
      means canonical euler-XYZ (the legacy behavior).
    - ``couplings``: for 1-DOF CustomJoints, the ordered TransformAxis
      list driven by the single coordinate q — each entry
      ``{'kind': 'rotation'|'translation', 'axis': [x,y,z],
         'fn': {'type': 'identity'|'linear'|'constant'|'spline', ...}}``
      ('linear' carries ``coeffs`` [a, b] for a*q+b; 'constant' carries
      ``value``; 'spline' carries natural-cubic knots ``x``/``y``, the
      SimmSpline/NaturalCubicSpline representation — e.g. the Rajagopal
      walker-knee translation splines). Empty = plain hinge about
      ``axis``.
    """
    name: str
    type: str
    parent_body: int  # -1 for world
    child_body: int
    translation: List[float]
    axis: List[float] = field(default_factory=lambda: [0.0, 0.0, 1.0])
    orientation: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    child_translation: List[float] = field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    child_orientation: List[float] = field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    rot_axes: Optional[List[List[float]]] = None
    couplings: List[dict] = field(default_factory=list)


@dataclass
class BodySpec:
    name: str
    mass: float
    com: List[float]              # COM offset in body frame
    inertia: List[float]          # [Ixx, Iyy, Izz, Ixy, Ixz, Iyz] about COM


@dataclass
class SkeletonSpec:
    joints: List[JointSpec]
    bodies: List[BodySpec]
    # approximations made while deriving this spec (e.g. unsupported
    # OpenSim function types, data/osim.py). NOT serialized; surfaced
    # once per run by consumers whose numbers they could bias
    # (analyze --compute-report, the analytical baseline).
    fidelity_warnings: List[str] = field(default_factory=list)

    @property
    def num_dofs(self) -> int:
        w = {'free': 6, 'ball': 3, 'revolute': 1, 'fixed': 0}
        return sum(w[j.type] for j in self.joints)

    def dof_names(self) -> List[str]:
        names: List[str] = []
        for j in self.joints:
            if j.type == 'free':
                names += [f'{j.name}_rot_{a}' for a in 'xyz']
                names += [f'{j.name}_t{a}' for a in 'xyz']
            elif j.type == 'ball':
                names += [f'{j.name}_{a}' for a in 'xyz']
            elif j.type == 'revolute':
                names.append(j.name)
            # 'fixed' joints contribute no DOFs
        return names

    def to_json(self) -> dict:
        out = {
            'joints': [vars(j) for j in self.joints],
            'bodies': [vars(b) for b in self.bodies],
        }
        # carried through native-file headers so `analyze` can surface
        # parse-time approximations even on CONVERTED datasets (the osim
        # text itself is not re-parsed after conversion)
        if self.fidelity_warnings:
            out['fidelity_warnings'] = list(self.fidelity_warnings)
        return out

    @staticmethod
    def from_json(d: dict) -> 'SkeletonSpec':
        return SkeletonSpec(
            joints=[JointSpec(**j) for j in d['joints']],
            bodies=[BodySpec(**b) for b in d['bodies']],
            fidelity_warnings=list(d.get('fidelity_warnings', [])),
        )


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

@dataclass
class TrialData:
    """In-memory trial: one [T, C] matrix per processing pass."""
    name: str
    timestep: float
    passes: List[np.ndarray]                 # each [T, C] float32
    pass_types: List[int]
    missing_grf_reasons: List[int]           # len T

    @property
    def length(self) -> int:
        return self.passes[0].shape[0]


def write_subject(path: str,
                  *,
                  num_dofs: int,
                  ground_force_bodies: List[str],
                  root_history_len: int,
                  trials: List[TrialData],
                  skeleton: Optional[SkeletonSpec] = None,
                  mass_kg: float = 70.0,
                  height_m: float = 1.75,
                  age_years: int = 30,
                  biological_sex: str = 'unknown',
                  dof_names: Optional[List[str]] = None,
                  joint_names: Optional[List[str]] = None) -> None:
    """Serialize a subject to a B3D-TPU v1 file."""
    nb = len([b for b in ground_force_bodies if b != 'pelvis'])
    layout = pass_channel_layout(num_dofs, nb, root_history_len)
    total_c = layout_total(layout)

    blob_index = []
    offset = 0  # relative to payload start; fixed up after header is sized
    blobs: List[np.ndarray] = []
    for t_idx, trial in enumerate(trials):
        assert len(trial.passes) == len(trial.pass_types)
        assert len(trial.missing_grf_reasons) == trial.length
        for p_idx, mat in enumerate(trial.passes):
            mat = np.ascontiguousarray(mat, dtype=np.float32)
            if mat.shape != (trial.length, total_c):
                raise ValueError(
                    f'trial {t_idx} pass {p_idx}: expected shape '
                    f'{(trial.length, total_c)}, got {mat.shape}')
            blob_index.append({'trial': t_idx, 'pass': p_idx,
                               'offset': offset, 'rows': int(mat.shape[0]),
                               'cols': int(mat.shape[1])})
            blobs.append(mat)
            nbytes = mat.nbytes
            offset += (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN

    header = {
        'subject': {
            'mass_kg': float(mass_kg),
            'height_m': float(height_m),
            'age_years': int(age_years),
            'biological_sex': biological_sex,
        },
        'num_dofs': int(num_dofs),
        'ground_force_bodies': list(ground_force_bodies),
        'root_history_len': int(root_history_len),
        'dof_names': dof_names or (skeleton.dof_names() if skeleton else
                                   [f'dof_{i}' for i in range(num_dofs)]),
        'joint_names': joint_names or [f'joint_{i}' for i in range(12)],
        'layout': [[n, w] for n, w in layout],
        'skeleton': skeleton.to_json() if skeleton else None,
        'trials': [{
            'name': t.name,
            'length': t.length,
            'timestep': t.timestep,
            'pass_types': [int(pt) for pt in t.pass_types],
            'missing_grf': [int(r) for r in t.missing_grf_reasons],
        } for t in trials],
        'blob_index': blob_index,
    }
    header_bytes = json.dumps(header).encode('utf-8')

    with open(path, 'wb') as f:
        f.write(MAGIC)
        f.write(struct.pack('<I', VERSION))
        f.write(struct.pack('<Q', len(header_bytes)))
        f.write(header_bytes)
        pos = f.tell()
        pad = (-pos) % _ALIGN
        f.write(b'\0' * pad)
        payload_start = f.tell()
        for entry, mat in zip(blob_index, blobs):
            target = payload_start + entry['offset']
            cur = f.tell()
            if cur < target:
                f.write(b'\0' * (target - cur))
            f.write(mat.tobytes())


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def check_read_frames_args(include_sensor_data: bool) -> None:
    if include_sensor_data:
        raise ValueError('readFrames(includeSensorData=True): this reader stores no '
                         'sensor channels')


def contact_from_forces(forces: np.ndarray, threshold: float) -> np.ndarray:
    """nimble's contact flags: ``forces`` [..., 3 nb] -> [..., nb], 1 where
    a body's force norm is above ``threshold``."""
    f = np.asarray(forces, np.float64)
    norms = np.linalg.norm(f.reshape(f.shape[:-1] + (-1, 3)), axis=-1)
    return (norms > threshold).astype(np.float64)


def with_thresholded_contact(row: np.ndarray, offsets: Dict[str, Tuple[int, int]],
                             threshold: float) -> np.ndarray:
    """A copy of a pass row whose ``contact`` columns are recomputed from its
    ``groundContactForce`` columns at ``threshold``."""
    o_f, w_f = offsets['groundContactForce']
    o_c, w_c = offsets['contact']
    out = np.array(row)
    out[o_c:o_c + w_c] = contact_from_forces(row[o_f:o_f + w_f], threshold)
    return out


class Frame:
    """One decoded frame: ``processingPasses[i].<field>`` views + metadata.

    Compatibility object for viz/analysis paths that want the reference's
    frame-at-a-time interface (visualize_file.py:217-222). The training hot
    path never builds these.
    """
    __slots__ = ('processingPasses', 'missingGRFReason', 'trial', 'index')

    def __init__(self, passes, missing, trial, index):
        self.processingPasses = passes
        self.missingGRFReason = missing
        self.trial = trial
        self.index = index


class FramePassView:
    """Attribute access onto one row of a pass matrix."""
    __slots__ = ('_row', '_offsets', 'type')

    def __init__(self, row: np.ndarray, offsets: Dict[str, Tuple[int, int]],
                 pass_type: int):
        self._row = row
        self._offsets = offsets
        self.type = ProcessingPassType(pass_type)

    def __getattr__(self, name: str) -> np.ndarray:
        try:
            off, width = self._offsets[name]
        except KeyError as e:
            raise AttributeError(name) from e
        return self._row[off:off + width]


class SubjectOnDisk:
    """Memory-mapped reader for B3D-TPU subject files.

    API parity with ``nimble.biomechanics.SubjectOnDisk`` (the exact surface
    the reference consumes — SURVEY.md §2.9), plus the fast-path
    :meth:`trial_pass_matrix` that the TPU input pipeline is built on.
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, 'rb') as f:
            magic = f.read(4)
            if magic != MAGIC:
                raise ValueError(f'{path}: not a B3D-TPU file (magic={magic!r})')
            version, = struct.unpack('<I', f.read(4))
            if version != VERSION:
                hint = (' (written before the MissingGRFReason enum '
                        'revision — delete it and reconvert from the '
                        'source .b3d, e.g. via convert-b3d or '
                        'ensure_tpu_format)') if version == 1 else ''
                raise ValueError(
                    f'{path}: unsupported B3D-TPU version {version}, '
                    f'this build reads version {VERSION}{hint}')
            hlen, = struct.unpack('<Q', f.read(8))
            self.header = json.loads(f.read(hlen).decode('utf-8'))
            pos = f.tell()
            self._payload_start = pos + ((-pos) % _ALIGN)

        self._layout = [(n, int(w)) for n, w in self.header['layout']]
        self._offsets = layout_offsets(self._layout)
        self._num_channels = layout_total(self._layout)
        self._blob: Dict[Tuple[int, int], dict] = {
            (e['trial'], e['pass']): e for e in self.header['blob_index']}
        self._file = open(path, 'rb')
        self._mmap = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self._skeleton_spec: Optional[SkeletonSpec] = None

    def close(self) -> None:
        self._mmap.close()
        self._file.close()

    # -- fast path ---------------------------------------------------------

    def trial_pass_matrix(self, trial: int, pass_index: int) -> np.ndarray:
        """Zero-copy [T, C] float32 view of one processing pass."""
        e = self._blob[(trial, pass_index)]
        start = self._payload_start + e['offset']
        count = e['rows'] * e['cols']
        arr = np.frombuffer(self._mmap, dtype=np.float32,
                            count=count, offset=start)
        return arr.reshape(e['rows'], e['cols'])

    @property
    def field_offsets(self) -> Dict[str, Tuple[int, int]]:
        return self._offsets

    def field_columns(self, name: str) -> slice:
        off, width = self._offsets[name]
        return slice(off, off + width)

    # -- nimble SubjectOnDisk parity surface --------------------------------

    def getNumDofs(self) -> int:
        return int(self.header['num_dofs'])

    def getNumJoints(self) -> int:
        return len(self.header['joint_names'])

    def getNumTrials(self) -> int:
        return len(self.header['trials'])

    def getTrialLength(self, trial: int) -> int:
        return int(self.header['trials'][trial]['length'])

    def getTrialTimestep(self, trial: int) -> float:
        return float(self.header['trials'][trial]['timestep'])

    def getTrialName(self, trial: int) -> str:
        return self.header['trials'][trial]['name']

    def getMissingGRF(self, trial: int) -> List[MissingGRFReason]:
        return [MissingGRFReason(r) for r in self.header['trials'][trial]['missing_grf']]

    def getGroundForceBodies(self) -> List[str]:
        return list(self.header['ground_force_bodies'])

    def getNumProcessingPasses(self) -> int:
        return max(len(t['pass_types']) for t in self.header['trials'])

    def getTrialNumProcessingPasses(self, trial: int) -> int:
        return len(self.header['trials'][trial]['pass_types'])

    def getProcessingPassType(self, index: int) -> ProcessingPassType:
        # pass lists are per-trial and may have different lengths; the
        # subject-level pass type at `index` is defined by whichever trials
        # reach that index — and must agree across them
        seen = {t['pass_types'][index] for t in self.header['trials']
                if index < len(t['pass_types'])}
        if not seen:
            raise IndexError(f'no trial has a processing pass {index}')
        if len(seen) > 1:
            raise ValueError(
                f'trials disagree on processing pass {index}: {sorted(seen)}')
        return ProcessingPassType(seen.pop())

    def getMassKg(self) -> float:
        return float(self.header['subject']['mass_kg'])

    def getHeightM(self) -> float:
        return float(self.header['subject']['height_m'])

    def getAgeYears(self) -> int:
        return int(self.header['subject']['age_years'])

    def getBiologicalSex(self) -> str:
        return self.header['subject']['biological_sex']

    def getRootHistoryLen(self) -> int:
        return int(self.header['root_history_len'])

    def getDofNames(self) -> List[str]:
        return list(self.header['dof_names'])

    def readSkel(self, processing_pass: int, geometry_folder: str = '') -> SkeletonSpec:
        """Return the skeleton spec (pass/geometry args kept for parity)."""
        if self._skeleton_spec is None:
            sk = self.header.get('skeleton')
            if sk is None:
                raise ValueError(f'{self.path}: no skeleton in header')
            self._skeleton_spec = SkeletonSpec.from_json(sk)
        return self._skeleton_spec

    def readFrames(self, trial: int, startFrame: int, numFramesToRead: int,
                   stride: int = 1, includeSensorData: bool = False,
                   includeProcessingPasses: bool = True,
                   contactThreshold: float = 1.0) -> List[Frame]:
        """Frame-object window (compat path for viz/review tools).

        ``contactThreshold`` other than the default 1.0 recomputes each
        pass's ``contact`` flags as nimble does: a body is in contact where
        the norm of its ``groundContactForce`` is above the threshold. At
        the default the stored flags are returned. No sensor channels are
        stored, so ``includeSensorData=True`` raises."""
        check_read_frames_args(includeSensorData)
        n_passes = self.getTrialNumProcessingPasses(trial)
        mats = [self.trial_pass_matrix(trial, p) for p in range(n_passes)]
        types = self.header['trials'][trial]['pass_types']
        missing = self.header['trials'][trial]['missing_grf']
        # clamp to the trial end like nimble's readFrames (short read, not
        # an IndexError, when the window runs past the last frame)
        T = self.getTrialLength(trial)
        if startFrame < T:
            numFramesToRead = min(numFramesToRead,
                                  (T - 1 - startFrame) // max(stride, 1) + 1)
        else:
            numFramesToRead = 0
        frames = []
        for k in range(numFramesToRead):
            idx = startFrame + k * stride
            rows = [mats[p][idx] for p in range(n_passes)] if includeProcessingPasses else []
            if contactThreshold != 1.0:
                rows = [with_thresholded_contact(r, self._offsets, contactThreshold)
                        for r in rows]
            passes = [FramePassView(r, self._offsets, t) for r, t in zip(rows, types)]
            frames.append(Frame(passes, MissingGRFReason(missing[idx]), trial, idx))
        return frames

    # -- conversion ---------------------------------------------------------

    @staticmethod
    def from_nimble(nimble_path: str, out_path: str) -> None:
        """Convert a legacy protobuf .b3d to B3D-TPU — no nimblephysics
        needed: :mod:`inferbiomechanics_tpu_torch.data.b3d_legacy` parses the
        length-prefixed protobuf wire format directly (SURVEY.md §7 step 1)."""
        from inferbiomechanics_tpu_torch.data.b3d_legacy import convert_to_tpu
        convert_to_tpu(nimble_path, out_path)
