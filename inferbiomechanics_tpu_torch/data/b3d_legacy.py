"""Legacy AddBiomechanics ``.b3d`` (length-prefixed protobuf) support.

Capability parity: ``nimble.biomechanics.SubjectOnDisk`` constructed on a
*legacy* protobuf subject file, as the reference consumes it
(src/data/AddBiomechanicsDataset.py:104-139,161-172 — header-only open,
``readFrames(trial, start, n, stride, includeProcessingPasses=True)``
returning per-frame ``processingPasses[i].<field>`` arrays), WITHOUT any
nimblephysics dependency (SURVEY.md §7 step 1 names this the #1 hard part).

Three layers, smallest-trust-surface first:

1. A minimal **protobuf wire-format codec** (varints, 64-bit fields,
   length-delimited submessages, packed repeated scalars). ~100 lines, no
   ``google.protobuf`` runtime needed, fully unit-tested.
2. A **schema table** mapping semantic field names -> protobuf field
   numbers, reconstructed from the public nimblephysics schema
   (``dart/proto/SubjectOnDisk.proto``). The numbering below is this
   project's documented reconstruction: exact byte-parity against files
   written by a specific nimblephysics release can only be validated with
   a real fixture, which this offline environment cannot provide
   (BASELINE.md). All format knowledge is concentrated in the ``_H/_TH/
   _PH/_F/_PF`` tables — when a real file disagrees, ONLY those tables
   (and at most the framing constants) need to change.
3. ``LegacySubjectOnDisk`` (random-access window reader with nimble's
   access profile: per-window seek + protobuf decode) and
   ``convert_to_tpu`` (one-shot sequential decode -> B3D-TPU matrices),
   plus ``write_legacy_subject`` so fixtures and round-trip tests exist
   without nimblephysics.

File framing (little-endian)::

    bytes 0..8   u64 header_proto_length
    ...          SubjectOnDiskHeader proto
    per frame    u64 frame_proto_length + SubjectOnDiskFrame proto,
                 trials concatenated in order, frames in order

Random access: the trial header records every frame record's byte size
(``frame_bytes``), so ``readFrames`` computes exact offsets — O(1) seek +
O(window) decode, matching nimble's design of seekable frames.
"""

from __future__ import annotations

import os
import struct
import sys
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from inferbiomechanics_tpu_torch.data.b3d import (
    MissingGRFReason, ProcessingPassType, SkeletonSpec, TrialData, check_read_frames_args,
    contact_from_forces, layout_offsets, layout_total, pass_channel_layout, write_subject,
)

# ---------------------------------------------------------------------------
# 1. Protobuf wire-format codec
# ---------------------------------------------------------------------------

_VARINT = 0
_I64 = 1
_LEN = 2
_I32 = 5


def encode_varint(value: int) -> bytes:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement, 64-bit, like protobuf
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def decode_varint(buf, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError('malformed varint')


def _tag(field: int, wire: int) -> bytes:
    return encode_varint((field << 3) | wire)


def enc_int(field: int, value: int) -> bytes:
    return _tag(field, _VARINT) + encode_varint(int(value))


def enc_double(field: int, value: float) -> bytes:
    return _tag(field, _I64) + struct.pack('<d', float(value))


def enc_bytes(field: int, data: bytes) -> bytes:
    return _tag(field, _LEN) + encode_varint(len(data)) + data


def enc_str(field: int, s: str) -> bytes:
    return enc_bytes(field, s.encode('utf-8'))


def enc_packed_doubles(field: int, values: Sequence[float]) -> bytes:
    arr = np.ascontiguousarray(values, dtype='<f8')
    return enc_bytes(field, arr.tobytes())


def enc_packed_ints(field: int, values: Sequence[int]) -> bytes:
    payload = b''.join(encode_varint(int(v)) for v in values)
    return enc_bytes(field, payload)


def enc_message(field: int, body: bytes) -> bytes:
    return enc_bytes(field, body)


def parse_message(buf) -> Dict[int, List[Tuple[int, object]]]:
    """Decode one message into {field_number: [(wire_type, raw_value), ...]}.

    varint -> int, 64-bit -> float (double), length-delimited -> memoryview,
    32-bit -> float. Unknown fields are preserved (forward compatibility).
    """
    view = memoryview(buf)
    fields: Dict[int, List[Tuple[int, object]]] = {}
    pos, end = 0, len(view)
    try:
        while pos < end:
            key, pos = decode_varint(view, pos)
            field, wire = key >> 3, key & 7
            if wire == _VARINT:
                val, pos = decode_varint(view, pos)
            elif wire == _I64:
                val = struct.unpack_from('<d', view, pos)[0]
                pos += 8
            elif wire == _LEN:
                ln, pos = decode_varint(view, pos)
                if ln > end - pos:
                    raise ValueError(f'truncated LEN field {field}')
                val = view[pos:pos + ln]
                pos += ln
            elif wire == _I32:
                val = struct.unpack_from('<f', view, pos)[0]
                pos += 4
            else:
                raise ValueError(
                    f'unsupported wire type {wire} (field {field})')
            fields.setdefault(field, []).append((wire, val))
    except (struct.error, IndexError) as e:
        raise ValueError(f'malformed protobuf message: {e}') from e
    return fields


def get_int(fields, num: int, default: int = 0) -> int:
    vals = fields.get(num)
    return int(vals[-1][1]) if vals else default


def get_double(fields, num: int, default: float = 0.0) -> float:
    vals = fields.get(num)
    return float(vals[-1][1]) if vals else default


def get_str(fields, num: int, default: str = '') -> str:
    vals = fields.get(num)
    return bytes(vals[-1][1]).decode('utf-8') if vals else default


def get_strs(fields, num: int) -> List[str]:
    return [bytes(v).decode('utf-8') for _, v in fields.get(num, [])]


def get_packed_doubles(fields, num: int) -> np.ndarray:
    """Packed (one LEN record) or non-packed (repeated I64) doubles."""
    chunks = []
    for wire, v in fields.get(num, []):
        if wire == _LEN:
            chunks.append(np.frombuffer(bytes(v), dtype='<f8'))
        else:
            chunks.append(np.array([v], dtype=np.float64))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float64)


def get_packed_ints(fields, num: int) -> List[int]:
    """Packed (LEN) or repeated varints."""
    out: List[int] = []
    for wire, v in fields.get(num, []):
        if wire == _LEN:
            pos, end = 0, len(v)
            try:
                while pos < end:
                    val, pos = decode_varint(v, pos)
                    out.append(val)
            except IndexError as e:
                # a varint's continuation bit ran past the payload: the
                # bytes are not packed varints (clean-ValueError contract)
                raise ValueError(
                    f'field {num}: truncated packed varint payload') from e
        else:
            out.append(int(v))
    return out


def get_messages(fields, num: int) -> List[Dict[int, List[Tuple[int, object]]]]:
    return [parse_message(v) for wire, v in fields.get(num, []) if wire == _LEN]


# ---------------------------------------------------------------------------
# 2. Schema tables (reconstructed from nimblephysics' public proto)
# ---------------------------------------------------------------------------

# SubjectOnDiskHeader
_H = dict(num_dofs=1, num_joints=2, ground_force_body=3, trial_header=4,
          processing_pass_header=5, biological_sex=6, mass_kg=7, height_m=8,
          age_years=9, dof_name=10, joint_name=11, subject_tags=12, href=13,
          notes=14, version=15)

# SubjectOnDiskPassHeader (subject-level processing pass)
_PH = dict(type=1, model_osim_text=2, skeleton_json=3)

# SubjectOnDiskTrialHeader
_TH = dict(name=1, trial_length=2, trial_timestep=3, missing_grf_reason=4,
           trial_pass_type=5, frame_bytes=6, trial_tags=7,
           original_trial_name=8, split_index=9)

# SubjectOnDiskFrame
_F = dict(missing_grf_reason=1, processing_pass=2,
          raw_force_plate_forces=3, raw_force_plate_cops=4)

# SubjectOnDiskPassFrame: field number = 1 + index into pass_channel_layout,
# so the wire schema and the B3D-TPU channel layout can never drift apart.
_PF_FIELDS: List[str] = [name for name, _ in pass_channel_layout(1, 1, 1)]
_PF = {name: i + 1 for i, name in enumerate(_PF_FIELDS)}
_PF_CONTACT_FIELD = _PF['contact']  # contact flags are packed ints, not doubles


# ---------------------------------------------------------------------------
# 3a. Writer (fixtures / round-trip tests / export)
# ---------------------------------------------------------------------------

def _encode_pass_frame(row: np.ndarray,
                       offsets: Dict[str, Tuple[int, int]]) -> bytes:
    parts = []
    for name, field_num in _PF.items():
        off, width = offsets[name]
        vals = row[off:off + width]
        if field_num == _PF_CONTACT_FIELD:
            parts.append(enc_packed_ints(field_num, [int(v) for v in vals]))
        else:
            parts.append(enc_packed_doubles(field_num, vals))
    return b''.join(parts)


def write_legacy_subject(path: str,
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
                         joint_names: Optional[List[str]] = None,
                         num_force_plates: int = 2,
                         model_osim_text: str = '') -> None:
    """Serialize a subject in the legacy length-prefixed protobuf format.

    Same argument surface as :func:`b3d.write_subject` so tests can write
    the same subject in both formats and diff the decoded values.
    """
    nb = len([b for b in ground_force_bodies if b != 'pelvis'])
    layout = pass_channel_layout(num_dofs, nb, root_history_len)
    offsets = layout_offsets(layout)
    total_c = layout_total(layout)

    import json as _json
    skeleton_json = _json.dumps(skeleton.to_json()) if skeleton else ''

    # frames (encoded first: trial headers need per-frame byte sizes)
    trial_frames: List[List[bytes]] = []
    for t_idx, trial in enumerate(trials):
        frames: List[bytes] = []
        for mat in trial.passes:
            if mat.shape != (trial.length, total_c):
                raise ValueError(
                    f'trial {t_idx}: expected {(trial.length, total_c)}, '
                    f'got {mat.shape}')
        for k in range(trial.length):
            body = [enc_int(_F['missing_grf_reason'],
                            trial.missing_grf_reasons[k])]
            for mat in trial.passes:
                body.append(enc_message(_F['processing_pass'],
                                        _encode_pass_frame(mat[k], offsets)))
            # raw force-plate channels: world-frame force/CoP per plate
            # (the layout's world-frame contact fields, one plate per body)
            f_off, f_w = offsets['groundContactForce']
            c_off, c_w = offsets['groundContactCenterOfPressure']
            raw_f = trial.passes[0][k, f_off:f_off + f_w]
            raw_c = trial.passes[0][k, c_off:c_off + c_w]
            body.append(enc_packed_doubles(_F['raw_force_plate_forces'], raw_f))
            body.append(enc_packed_doubles(_F['raw_force_plate_cops'], raw_c))
            frames.append(b''.join(body))
        trial_frames.append(frames)

    # header
    hparts = [
        enc_int(_H['num_dofs'], num_dofs),
        enc_int(_H['num_joints'], len(joint_names) if joint_names else 12),
        enc_str(_H['biological_sex'], biological_sex),
        enc_double(_H['mass_kg'], mass_kg),
        enc_double(_H['height_m'], height_m),
        enc_int(_H['age_years'], age_years),
        enc_int(_H['version'], 1),
    ]
    for b in ground_force_bodies:
        hparts.append(enc_str(_H['ground_force_body'], b))
    for n in (dof_names or [f'dof_{i}' for i in range(num_dofs)]):
        hparts.append(enc_str(_H['dof_name'], n))
    for n in (joint_names or [f'joint_{i}' for i in range(12)]):
        hparts.append(enc_str(_H['joint_name'], n))
    n_passes = max(len(t.pass_types) for t in trials)
    for p in range(n_passes):
        ptype = next(t.pass_types[p] for t in trials if p < len(t.pass_types))
        ph = enc_int(_PH['type'], ptype)
        if model_osim_text:
            ph += enc_str(_PH['model_osim_text'], model_osim_text)
        if skeleton_json:
            ph += enc_str(_PH['skeleton_json'], skeleton_json)
        hparts.append(enc_message(_H['processing_pass_header'], ph))
    for t_idx, trial in enumerate(trials):
        th = b''.join([
            enc_str(_TH['name'], trial.name),
            enc_int(_TH['trial_length'], trial.length),
            enc_double(_TH['trial_timestep'], trial.timestep),
            enc_packed_ints(_TH['missing_grf_reason'],
                            trial.missing_grf_reasons),
            enc_packed_ints(_TH['trial_pass_type'], trial.pass_types),
            enc_packed_ints(_TH['frame_bytes'],
                            [len(f) + 8 for f in trial_frames[t_idx]]),
        ])
        hparts.append(enc_message(_H['trial_header'], th))
    header = b''.join(hparts)

    with open(path, 'wb') as f:
        f.write(struct.pack('<Q', len(header)))
        f.write(header)
        for frames in trial_frames:
            for frame in frames:
                f.write(struct.pack('<Q', len(frame)))
                f.write(frame)


# ---------------------------------------------------------------------------
# 3b. Reader
# ---------------------------------------------------------------------------

class LegacyFramePass:
    """One processing pass of one frame: nimble FramePass attribute surface.
    ``contact``, when given, stands in for the stored contact flags."""
    __slots__ = ('_fields', 'type', '_contact')

    def __init__(self, fields, pass_type: int, contact: Optional[np.ndarray] = None):
        self._fields = fields
        self.type = ProcessingPassType(pass_type)
        self._contact = contact

    def __getattr__(self, name: str) -> np.ndarray:
        if name == 'contact' and self._contact is not None:
            return self._contact
        try:
            num = _PF[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if num == _PF_CONTACT_FIELD:
            return np.asarray(get_packed_ints(self._fields, num), np.float64)
        return get_packed_doubles(self._fields, num)


class LegacyFrame:
    """nimble Frame surface: processingPasses + missingGRFReason + raw plates."""
    __slots__ = ('processingPasses', 'missingGRFReason', 'trial', 'index',
                 'rawForcePlateForces', 'rawForcePlateCenterOfPressures')

    def __init__(self, passes, missing, trial, index, raw_f, raw_c):
        self.processingPasses = passes
        self.missingGRFReason = missing
        self.trial = trial
        self.index = index
        self.rawForcePlateForces = raw_f
        self.rawForcePlateCenterOfPressures = raw_c


class LegacySubjectOnDisk:
    """Header-only open + random-access window reads of a legacy .b3d.

    Mirrors nimble's access profile — construction decodes only the header;
    every ``readFrames`` seeks and protobuf-decodes the requested frames
    (the per-window decode cost SURVEY.md §3.5 identifies as the reference
    pipeline's bottleneck; this class is also the honest-baseline cost
    model for BASELINE.md).
    """

    def __init__(self, path: str):
        self.path = path
        with open(path, 'rb') as f:
            prefix = f.read(8)
            if len(prefix) < 8:
                raise ValueError(f'{path}: truncated legacy .b3d')
            hlen, = struct.unpack('<Q', prefix)
            fsize = os.fstat(f.fileno()).st_size
            if hlen == 0 or hlen > fsize - 8:
                raise ValueError(
                    f'{path}: implausible legacy header length {hlen}')
            h = parse_message(f.read(hlen))
        self._frames_start = 8 + hlen
        self.num_dofs = get_int(h, _H['num_dofs'])
        self.num_joints = get_int(h, _H['num_joints'])
        self.ground_force_bodies = get_strs(h, _H['ground_force_body'])
        self.biological_sex = get_str(h, _H['biological_sex'], 'unknown')
        self.mass_kg = get_double(h, _H['mass_kg'])
        self.height_m = get_double(h, _H['height_m'])
        self.age_years = get_int(h, _H['age_years'])
        self.dof_names = get_strs(h, _H['dof_name'])
        self.joint_names = get_strs(h, _H['joint_name'])
        self.href = get_str(h, _H['href'])
        self.notes = get_str(h, _H['notes'])

        self.pass_types: List[int] = []
        self.skeleton_specs: List[Optional[SkeletonSpec]] = []
        self.model_osim_texts: List[str] = []
        for ph in get_messages(h, _H['processing_pass_header']):
            self.pass_types.append(get_int(ph, _PH['type']))
            self.model_osim_texts.append(get_str(ph, _PH['model_osim_text']))
            sk = get_str(ph, _PH['skeleton_json'])
            if sk:
                import json as _json
                self.skeleton_specs.append(SkeletonSpec.from_json(_json.loads(sk)))
            else:
                self.skeleton_specs.append(None)

        self.trials: List[dict] = []
        offset = self._frames_start
        for th in get_messages(h, _H['trial_header']):
            length = get_int(th, _TH['trial_length'])
            frame_bytes = get_packed_ints(th, _TH['frame_bytes'])
            if len(frame_bytes) != length:
                raise ValueError(
                    f'{path}: trial frame index has {len(frame_bytes)} '
                    f'entries for {length} frames')
            starts = offset + np.concatenate(
                [[0], np.cumsum(frame_bytes[:-1])]).astype(np.int64) \
                if length else np.zeros(0, np.int64)
            self.trials.append({
                'name': get_str(th, _TH['name']),
                'length': length,
                'timestep': get_double(th, _TH['trial_timestep']),
                'missing_grf': get_packed_ints(th, _TH['missing_grf_reason']),
                'pass_types': get_packed_ints(th, _TH['trial_pass_type'])
                              or list(self.pass_types),
                'frame_starts': starts,
                'frame_bytes': frame_bytes,
            })
            offset += int(sum(frame_bytes))
        self._file = open(path, 'rb')

    def close(self) -> None:
        self._file.close()

    # -- nimble SubjectOnDisk parity surface --------------------------------

    def getNumDofs(self) -> int:
        return self.num_dofs

    def getNumJoints(self) -> int:
        return self.num_joints

    def getNumTrials(self) -> int:
        return len(self.trials)

    def getTrialLength(self, trial: int) -> int:
        return self.trials[trial]['length']

    def getTrialTimestep(self, trial: int) -> float:
        return self.trials[trial]['timestep']

    def getTrialName(self, trial: int) -> str:
        return self.trials[trial]['name']

    def getMissingGRF(self, trial: int) -> List[MissingGRFReason]:
        return [MissingGRFReason(r) for r in self.trials[trial]['missing_grf']]

    def getGroundForceBodies(self) -> List[str]:
        return list(self.ground_force_bodies)

    def getNumProcessingPasses(self) -> int:
        return len(self.pass_types) or max(
            (len(t['pass_types']) for t in self.trials), default=0)

    def getTrialNumProcessingPasses(self, trial: int) -> int:
        return len(self.trials[trial]['pass_types'])

    def getProcessingPassType(self, index: int) -> ProcessingPassType:
        if self.pass_types:
            return ProcessingPassType(self.pass_types[index])
        seen = {t['pass_types'][index] for t in self.trials
                if index < len(t['pass_types'])}
        if len(seen) != 1:
            raise ValueError(f'ambiguous pass type at {index}: {sorted(seen)}')
        return ProcessingPassType(seen.pop())

    def getMassKg(self) -> float:
        return self.mass_kg

    def getHeightM(self) -> float:
        return self.height_m

    def getAgeYears(self) -> int:
        return self.age_years

    def getBiologicalSex(self) -> str:
        return self.biological_sex

    def getDofNames(self) -> List[str]:
        return list(self.dof_names)

    def readSkel(self, processing_pass: int,
                 geometry_folder: str = '') -> SkeletonSpec:
        spec = self.skeleton_specs[processing_pass] \
            if processing_pass < len(self.skeleton_specs) else None
        if spec is None and processing_pass < len(self.model_osim_texts) \
                and self.model_osim_texts[processing_pass]:
            # real nimble files carry the scaled OpenSim model XML here
            from inferbiomechanics_tpu_torch.data.osim import parse_osim
            spec, warnings = parse_osim(self.model_osim_texts[processing_pass])
            for w in warnings:
                import logging
                logging.getLogger(__name__).warning('%s: osim: %s',
                                                    self.path, w)
            self.skeleton_specs[processing_pass] = spec
        if spec is None:
            raise ValueError(
                f'{self.path}: pass {processing_pass} carries no skeleton '
                f'spec or osim model (convert with an explicit skeleton '
                f'via convert_to_tpu(skeleton=...))')
        return spec

    def _decode_frame(self, trial: int, index: int) -> LegacyFrame:
        t = self.trials[trial]
        self._file.seek(int(t['frame_starts'][index]))
        rec = self._file.read(int(t['frame_bytes'][index]))
        ln, = struct.unpack('<Q', rec[:8])
        fields = parse_message(rec[8:8 + ln])
        types = t['pass_types']
        passes = [LegacyFramePass(pf, types[i] if i < len(types) else 0)
                  for i, pf in enumerate(get_messages(fields, _F['processing_pass']))]
        return LegacyFrame(
            passes,
            MissingGRFReason(get_int(fields, _F['missing_grf_reason'])),
            trial, index,
            get_packed_doubles(fields, _F['raw_force_plate_forces']),
            get_packed_doubles(fields, _F['raw_force_plate_cops']))

    def readFrames(self, trial: int, startFrame: int, numFramesToRead: int,
                   stride: int = 1, includeSensorData: bool = False,
                   includeProcessingPasses: bool = True,
                   contactThreshold: float = 1.0) -> List[LegacyFrame]:
        """nimble's ``readFrames``. ``contactThreshold`` other than the
        default 1.0 recomputes each pass's ``contact`` flags as nimble does
        (a body's ``groundContactForce`` norm above the threshold); at the
        default the stored flags are returned. Sensor channels are not
        decoded, so ``includeSensorData=True`` raises."""
        del includeProcessingPasses
        check_read_frames_args(includeSensorData)
        # short read at the trial end, like nimble (no IndexError)
        T = self.trials[trial]['length']
        if startFrame >= T:
            return []
        numFramesToRead = min(numFramesToRead,
                              (T - 1 - startFrame) // max(stride, 1) + 1)
        frames = [self._decode_frame(trial, startFrame + k * stride)
                  for k in range(numFramesToRead)]
        if contactThreshold != 1.0:
            for frame in frames:
                frame.processingPasses = [
                    LegacyFramePass(p._fields, p.type, contact_from_forces(
                        p.groundContactForce, contactThreshold))
                    for p in frame.processingPasses]
        return frames


# ---------------------------------------------------------------------------
# 3c. Validation / strict verification
# ---------------------------------------------------------------------------

_MAX_MISSING_GRF = max(int(r) for r in MissingGRFReason)
_MAX_PASS_TYPE = max(int(t) for t in ProcessingPassType)


def validate_legacy_header(
        subj: 'LegacySubjectOnDisk') -> Tuple[List[str], List[str]]:
    """Cheap invariant checks that catch a mis-matched schema table.

    The ``_H/_TH/_PH/_F/_PF`` field numbering is a reconstruction of the
    public nimblephysics proto; if a real file was written with different
    numbering, scalar fields read other fields' varints and produce
    implausible values. These checks turn that failure mode into a loud,
    named error instead of silent garbage.

    Returns ``(problems, warnings)``. Problems gate conversion; warnings
    do not. The discriminator for demographic scalars: a proto3 scalar
    that is simply UNSET decodes as exactly 0.0 — a legitimate file
    missing mass/height must still convert (the reference tolerates
    absent demographics, SubjectOnDisk just returns them) — while a
    field-number collision reads another field's bits and yields garbage
    doubles (e.g. 3e-250), which are nonzero and out of range.
    """
    p: List[str] = []
    w: List[str] = []

    def demographic(value: float, lo: float, hi: float, name: str):
        if value == 0.0:
            w.append(f'{name} unset (absent proto3 scalar decodes as 0.0)')
        elif not (lo <= value <= hi):
            p.append(f'{name}={value!r} implausible (_H.{name})')

    if not (1 <= subj.num_dofs <= 200):
        p.append(f'num_dofs={subj.num_dofs} implausible (_H.num_dofs)')
    if subj.dof_names and len(subj.dof_names) != subj.num_dofs:
        p.append(f'{len(subj.dof_names)} dof_names for num_dofs='
                 f'{subj.num_dofs} (_H.dof_name/_H.num_dofs)')
    if not (0 <= subj.num_joints <= 200):
        p.append(f'num_joints={subj.num_joints} implausible (_H.num_joints)')
    demographic(subj.mass_kg, 10.0, 400.0, 'mass_kg')
    demographic(subj.height_m, 0.3, 3.0, 'height_m')
    if not (0 <= subj.age_years <= 130):
        p.append(f'age_years={subj.age_years} implausible (_H.age_years)')
    if not subj.ground_force_bodies:
        p.append('no ground_force_body entries (_H.ground_force_body)')
    if not subj.trials:
        p.append('no trial headers (_H.trial_header)')
    for i, t in enumerate(subj.trials):
        if len(t['missing_grf']) != t['length']:
            p.append(f"trial {i}: {len(t['missing_grf'])} missing_grf "
                     f"entries for length {t['length']} "
                     f"(_TH.missing_grf_reason/_TH.trial_length)")
        bad = [r for r in t['missing_grf'] if r > _MAX_MISSING_GRF]
        if bad:
            p.append(f'trial {i}: unknown MissingGRFReason values '
                     f'{sorted(set(bad))[:5]} (_TH.missing_grf_reason)')
        bad = [v for v in t['pass_types'] if v > _MAX_PASS_TYPE]
        if bad:
            p.append(f'trial {i}: unknown ProcessingPassType values '
                     f'{sorted(set(bad))[:5]} (_TH.trial_pass_type)')
        if t['length'] > 0 and not (0.0 < t['timestep'] < 1.0):
            if t['timestep'] == 0.0:
                w.append(f'trial {i}: timestep unset (absent proto3 scalar)')
            else:
                p.append(f"trial {i}: timestep={t['timestep']!r} implausible "
                         f"(_TH.trial_timestep)")
    return p, w


def verify_legacy(path: str, max_frames_per_trial: Optional[int] = None) -> dict:
    """Strict decode of a legacy .b3d: field-by-field diagnosis.

    Exercised by ``convert-b3d --verify`` so the FIRST real
    AddBiomechanics file either converts cleanly or yields a report that
    points at the exact schema-table entries to fix (VERDICT round 2 #5;
    reference consumption contract AddBiomechanicsDataset.py:161-172).

    Returns a dict report::

        {'path', 'ok', 'problems': [str], 'frames_checked': int,
         'unknown_header_fields', 'unknown_trial_fields',
         'unknown_frame_fields', 'unknown_pass_fields': {field_num: count},
         'width_mismatches': {field_name: count}}

    Checks, beyond what plain conversion exercises:
    - every message fully consumed (parse_message already guarantees no
      trailing bytes; any decode error is caught per-frame and reported)
    - unknown-field census for all four message levels — a nonempty
      census for LOW field numbers is the signature of numbering drift
    - frame length-prefix vs the trial header's ``frame_bytes`` index,
      and total stream size vs file size (framing reconciliation)
    - per-pass channel widths vs the layout implied by the header
      (``pass_channel_layout``), and the per-frame pass count vs the
      trial's pass-type list
    - per-frame ``missing_grf_reason`` consistent with the trial header
    """
    report = {
        'path': path, 'ok': False, 'problems': [], 'warnings': [],
        'frames_checked': 0,
        'unknown_header_fields': {}, 'unknown_trial_fields': {},
        'unknown_frame_fields': {}, 'unknown_pass_fields': {},
        'width_mismatches': {},
    }
    problems: List[str] = report['problems']

    def census(fields, known_nums, bucket: dict):
        for num in fields:
            if num not in known_nums:
                bucket[num] = bucket.get(num, 0) + len(fields[num])

    try:
        subj = LegacySubjectOnDisk(path)
    except (ValueError, OSError) as e:
        problems.append(f'header: {e}')
        return report
    try:
        hdr_problems, hdr_warnings = validate_legacy_header(subj)
        problems.extend(hdr_problems)
        report['warnings'].extend(hdr_warnings)

        # header / trial-header unknown-field census (re-parse raw header)
        with open(path, 'rb') as f:
            hlen, = struct.unpack('<Q', f.read(8))
            h = parse_message(f.read(hlen))
        census(h, set(_H.values()), report['unknown_header_fields'])
        for th in get_messages(h, _H['trial_header']):
            census(th, set(_TH.values()), report['unknown_trial_fields'])
        for ph in get_messages(h, _H['processing_pass_header']):
            census(ph, set(_PH.values()), report['unknown_pass_fields'])

        # framing: total stream length vs file size
        fsize = os.path.getsize(path)
        stream_end = subj._frames_start + sum(
            int(sum(t['frame_bytes'])) for t in subj.trials)
        if stream_end != fsize:
            problems.append(
                f'framing: header + frame index accounts for {stream_end} '
                f'bytes but the file has {fsize} (_TH.frame_bytes)')

        # expected channel widths (root-history width read from the data).
        # Until a pass carries a POSITIVE history width, the two history
        # channels are excluded from width checks: a pass that simply
        # omits the optional history field decodes as width 0, and
        # latching rh=0 from it would flag every later pass that carries
        # real history data as a false mismatch.
        nb = len([b for b in subj.ground_force_bodies if b != 'pelvis'])
        _HISTORY_FIELDS = ('rootPosHistoryInRootFrame',
                           'rootEulerHistoryInRootFrame')
        rh = None
        expected: Dict[str, int] = {
            name: width
            for name, width in pass_channel_layout(subj.num_dofs, nb, 0)
            if name not in _HISTORY_FIELDS}

        for t_idx, t in enumerate(subj.trials):
            n = t['length']
            if max_frames_per_trial is not None:
                n = min(n, max_frames_per_trial)
            for k in range(n):
                try:
                    rec_start = int(t['frame_starts'][k])
                    subj._file.seek(rec_start)
                    rec = subj._file.read(int(t['frame_bytes'][k]))
                    ln, = struct.unpack('<Q', rec[:8])
                    if ln + 8 != int(t['frame_bytes'][k]):
                        problems.append(
                            f'trial {t_idx} frame {k}: record length prefix '
                            f'{ln}+8 != indexed frame_bytes '
                            f"{int(t['frame_bytes'][k])} (_TH.frame_bytes)")
                    fields = parse_message(rec[8:8 + ln])
                except (ValueError, struct.error) as e:
                    problems.append(f'trial {t_idx} frame {k}: {e}')
                    continue
                census(fields, set(_F.values()),
                       report['unknown_frame_fields'])
                reason = get_int(fields, _F['missing_grf_reason'])
                if k < len(t['missing_grf']) and reason != t['missing_grf'][k]:
                    problems.append(
                        f'trial {t_idx} frame {k}: frame missing_grf_reason '
                        f"{reason} != trial header {t['missing_grf'][k]} "
                        f'(_F.missing_grf_reason/_TH.missing_grf_reason)')
                passes = get_messages(fields, _F['processing_pass'])
                if len(passes) != len(t['pass_types']):
                    problems.append(
                        f'trial {t_idx} frame {k}: {len(passes)} processing '
                        f"passes vs {len(t['pass_types'])} trial pass types "
                        f'(_F.processing_pass/_TH.trial_pass_type)')
                for pf in passes:
                    census(pf, set(_PF.values()),
                           report['unknown_pass_fields'])
                    if rh is None:
                        for hf in _HISTORY_FIELDS:
                            try:
                                w = len(get_packed_doubles(pf, _PF[hf]))
                            except ValueError:
                                continue
                            if w > 0 and w % 3 == 0:
                                rh = w // 3
                                expected = dict(pass_channel_layout(
                                    subj.num_dofs, nb, rh))
                                break
                    for name, fnum in _PF.items():
                        if name not in expected or fnum not in pf:
                            continue
                        try:
                            if fnum == _PF_CONTACT_FIELD:
                                got = len(get_packed_ints(pf, fnum))
                            else:
                                got = len(get_packed_doubles(pf, fnum))
                        except ValueError:
                            got = -1   # undecodable payload counts as drift
                        if got != expected[name]:
                            report['width_mismatches'][name] = \
                                report['width_mismatches'].get(name, 0) + 1
                report['frames_checked'] += 1
    finally:
        subj.close()

    for name, count in sorted(report['width_mismatches'].items()):
        problems.append(
            f'channel width mismatch for {name!r} in {count} frames '
            f'(expected {expected.get(name)} values; _PF.{name})')
    low_unknown = [n for n in report['unknown_pass_fields'] if n <= len(_PF)]
    if low_unknown:
        problems.append(
            f'unknown LOW pass-frame field numbers {sorted(low_unknown)} — '
            f'likely _PF numbering drift vs the writer of this file')
    report['ok'] = not problems
    return report


def format_verify_report(report: dict) -> str:
    lines = [f"verify {report['path']}: "
             f"{'OK' if report['ok'] else 'FAILED'} "
             f"({report['frames_checked']} frames checked)"]
    for key in ('unknown_header_fields', 'unknown_trial_fields',
                'unknown_frame_fields', 'unknown_pass_fields'):
        if report[key]:
            lines.append(f'  {key}: {report[key]} '
                         f'(forward-compatible; preserved, not decoded)')
    for warning in report.get('warnings', ()):
        lines.append(f'  WARNING: {warning}')
    for prob in report['problems']:
        lines.append(f'  PROBLEM: {prob}')
    if not report['ok']:
        lines.append('  -> fix the named b3d_legacy._H/_TH/_PH/_F/_PF '
                     'entries; all format knowledge lives in those tables')
    return '\n'.join(lines)


# ---------------------------------------------------------------------------
# 3d. Conversion legacy -> B3D-TPU
# ---------------------------------------------------------------------------

def is_legacy_b3d(path: str) -> bool:
    """True if `path` is a legacy protobuf .b3d (vs B3D-TPU, magic b'B3DT')."""
    with open(path, 'rb') as f:
        return f.read(4) != b'B3DT'


def convert_to_tpu(legacy_path: str, out_path: str,
                   skeleton: Optional[SkeletonSpec] = None) -> None:
    """Decode a legacy .b3d once, sequentially, into B3D-TPU matrices.

    This is the ``SubjectOnDisk.from_nimble`` capability without nimble:
    after conversion the training pipeline never pays per-window protobuf
    decodes again (the B3D-TPU design premise, data/b3d.py docstring).
    """
    subj = LegacySubjectOnDisk(legacy_path)
    try:
        problems, warnings = validate_legacy_header(subj)
        if problems:
            raise ValueError(
                f'{legacy_path}: unrecognized legacy .b3d schema: '
                + '; '.join(problems) +
                ' — the field-number tables (b3d_legacy._H/_TH/_PH/_F/_PF) '
                'may not match the writer of this file; run '
                '`main.py convert-b3d --verify` for a field-by-field '
                'diagnosis')
        for warning in warnings:
            # absent optional metadata (exact-0.0 proto3 scalars) does not
            # gate conversion — the reference tolerates it — but mass=0
            # will make mass-normalized labels degenerate downstream
            print(f'[convert-b3d] {legacy_path}: WARNING: {warning}',
                  file=sys.stderr)
        nb = len([b for b in subj.ground_force_bodies if b != 'pelvis'])
        # root_history_len from the first frame's history channel width
        rh = 0
        for t_idx, t in enumerate(subj.trials):
            if t['length'] > 0 and subj.getTrialNumProcessingPasses(t_idx) > 0:
                f0 = subj._decode_frame(t_idx, 0)
                rh = len(f0.processingPasses[0].rootPosHistoryInRootFrame) // 3
                break
        layout = pass_channel_layout(subj.num_dofs, nb, rh)
        offsets = layout_offsets(layout)
        total_c = layout_total(layout)

        # field-number -> (column, width) tables for the C decoder
        max_field = max(_PF.values())
        field_col = np.zeros(max_field + 1, np.int64)
        field_width = np.zeros(max_field + 1, np.int64)
        for name, fnum in _PF.items():
            field_col[fnum], field_width[fnum] = offsets[name]

        trials: List[TrialData] = []
        for t_idx, t in enumerate(subj.trials):
            n_passes = subj.getTrialNumProcessingPasses(t_idx)
            mats = None
            if t['length'] > 0:
                # native C decoder (multithreaded varint/packed-double
                # parse, native/ib_native.cpp); None -> Python fallback
                from inferbiomechanics_tpu_torch.data.native import (
                    decode_legacy_trial,
                )
                start = int(t['frame_starts'][0]) if t['length'] else 0
                blob_len = int(sum(t['frame_bytes']))
                subj._file.seek(start)
                blob = subj._file.read(blob_len)
                rel_offsets = np.asarray(t['frame_starts'], np.int64) - start
                mats = decode_legacy_trial(
                    blob, rel_offsets, field_col, field_width,
                    _PF_CONTACT_FIELD, n_passes, total_c)
            if mats is None:
                mats = [np.zeros((t['length'], total_c), np.float32)
                        for _ in range(n_passes)]
                for k in range(t['length']):
                    frame = subj._decode_frame(t_idx, k)
                    for p, fp in enumerate(frame.processingPasses[:n_passes]):
                        row = mats[p][k]
                        for name, (off, width) in offsets.items():
                            vals = getattr(fp, name)
                            row[off:off + min(width, len(vals))] = vals[:width]
            trials.append(TrialData(
                name=t['name'], timestep=t['timestep'], passes=mats,
                pass_types=list(t['pass_types'][:n_passes]),
                missing_grf_reasons=list(t['missing_grf'])))

        sk = skeleton
        if sk is None:
            for p in range(len(subj.skeleton_specs)):
                try:
                    sk = subj.readSkel(p)
                    break
                except ValueError:
                    continue
        write_subject(
            out_path, num_dofs=subj.num_dofs,
            ground_force_bodies=subj.ground_force_bodies,
            root_history_len=rh, trials=trials, skeleton=sk,
            mass_kg=subj.mass_kg, height_m=subj.height_m,
            age_years=subj.age_years, biological_sex=subj.biological_sex,
            dof_names=subj.dof_names or None,
            joint_names=subj.joint_names or None)
    finally:
        subj.close()


def ensure_tpu_format(path: str, cache_dir: Optional[str] = None) -> str:
    """Return a B3D-TPU path for `path`, converting legacy files on demand.

    Converted files land next to the source (``<name>.b3dtpu``) or in
    `cache_dir`, and are reused when newer than the source.
    """
    if not is_legacy_b3d(path):
        return path
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        out = os.path.join(cache_dir, os.path.basename(path) + 'tpu')
    else:
        out = path + 'tpu'
    from inferbiomechanics_tpu_torch.data.b3d import is_current_b3dt
    if (not os.path.exists(out)
            or os.path.getmtime(out) < os.path.getmtime(path)
            or not is_current_b3dt(out)):   # stale format version: reconvert
        # atomic publish: convert into a per-process temp file and
        # os.replace, so an interrupted conversion can never leave a
        # torn .b3dtpu that later runs mmap, and concurrent multi-host
        # processes racing on a shared filesystem each publish a
        # complete file (last writer wins, all writers identical)
        tmp = f'{out}.tmp.{os.getpid()}'
        try:
            convert_to_tpu(path, tmp)
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out
