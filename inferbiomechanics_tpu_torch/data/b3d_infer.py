"""Schema inference for unknown legacy ``.b3d`` protobuf files.

The legacy codec's field-number tables (``b3d_legacy._H/_TH/_PH/_F/_PF``)
are a documented reconstruction of nimblephysics' proto — byte-parity
against real AddBiomechanics downloads cannot be validated in this
offline environment (b3d_legacy.py module docstring; BASELINE.md). This
module de-risks that: it analyzes an unknown file's raw WIRE structure
with no table knowledge at all and proposes its own name -> field-number
mapping from structural invariants, then diffs the proposal against the
built-in tables. When a real nimble-written file disagrees with the
reconstruction, ``convert-b3d --infer-schema`` turns the failure into a
field-by-field diagnosis saying exactly which table entries to edit.

Invariants used (all table-free):

- file framing: u64 header length, then u64-prefixed frame records
  (nimble's seekable-frames design, b3d_legacy.py module docstring);
- ``frame_bytes``: the one packed-int trial-header field whose values
  equal the ACTUAL frame-record byte sizes walked from the file;
- ``num_dofs``: the packed-double width shared by the largest group of
  pass-frame fields (pos/vel/acc/tau are all num_dofs wide), which must
  also equal the length of one repeated-string header field (dof names)
  and the value of one varint header field;
- ``trial_header``: the repeated submessage field containing the
  frame_bytes match; ``processing_pass`` (frame level): the repeated
  submessage field whose count equals the per-trial pass count;
- value ranges for scalars (timestep in (1e-5, 1), height in (0.5, 2.7) m,
  mass in (10, 300) kg).

Width collisions (e.g. pos/vel/acc/tau) are reported as candidate SETS,
never silently resolved — the tool is a diagnosis, not an oracle.

Reference consumption contract this guards:
the reference's ``src/data/AddBiomechanicsDataset.py:104-139,161-172``.

The port's copy of ``inferbiomechanics_tpu/data/b3d_infer.py``, on the
port's ``data/b3d.py`` and ``data/b3d_legacy.py``. It reads the built-in
tables (``b3d_legacy._H/_TH/_F/_PF``) when it is called, not at import, so
a table moved in ``b3d_legacy`` (as the tests move them) is the table the
diff is made against. ``tests/test_torch_data.py`` holds the copy to the
original.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from inferbiomechanics_tpu_torch.data import b3d_legacy as _legacy
from inferbiomechanics_tpu_torch.data.b3d import pass_channel_layout
from inferbiomechanics_tpu_torch.data.b3d_legacy import (
    _LEN, _VARINT, _I64, decode_varint, get_packed_ints, parse_message,
)


def _try_utf8(mv) -> Optional[str]:
    try:
        s = bytes(mv).decode('utf-8')
    except UnicodeDecodeError:
        return None
    # packed small varints decode as control characters; real text never
    # carries controls beyond whitespace
    if any(ord(c) < 32 and c not in '\n\t\r' for c in s):
        return None
    return s


def _try_message(mv) -> Optional[dict]:
    """Strict: random scalar payloads (packed doubles/varints) can decode
    as SOME message, so only accept parses whose field numbers look like
    a real schema (small, nonzero, few)."""
    if len(mv) == 0:
        return None
    try:
        msg = parse_message(mv)
    except ValueError:
        return None
    if not msg or len(msg) > 64:
        return None
    if min(msg) < 1 or max(msg) > 512:
        return None
    return msg


def _try_packed_doubles(mv) -> Optional[np.ndarray]:
    if len(mv) == 0 or len(mv) % 8:
        return None
    arr = np.frombuffer(bytes(mv), dtype='<f8')
    return arr if np.isfinite(arr).all() and np.abs(arr).max(initial=0.0) < 1e12 else None


def _try_packed_ints(mv) -> Optional[List[int]]:
    out, pos, end = [], 0, len(mv)
    try:
        while pos < end:
            v, pos = decode_varint(mv, pos)
            out.append(v)
    except (IndexError, ValueError):
        return None
    return out


def _classify(records) -> dict:
    """Summarize one field's records: {'kind', 'count', ...samples}."""
    wires = {w for w, _ in records}
    n = len(records)
    if wires == {_VARINT}:
        return {'kind': 'varint', 'count': n,
                'values': [int(v) for _, v in records[:8]]}
    if wires == {_I64}:
        return {'kind': 'double', 'count': n,
                'values': [float(v) for _, v in records[:8]]}
    if wires == {_LEN}:
        payloads = [v for _, v in records]
        msgs = [_try_message(p) for p in payloads]
        strs = [_try_utf8(p) for p in payloads]
        # prefer strings over coincidental message parses for short text
        if all(s is not None for s in strs) and (
                any(m is None for m in msgs)
                or all(len(p) < 64 for p in payloads)):
            return {'kind': 'string', 'count': n,
                    'values': [s[:60] for s in strs[:8]]}
        # real repeated submessages share one schema: demand identical
        # field sets across records (scalar payloads that accidentally
        # message-parse produce inconsistent field sets)
        if all(m is not None for m in msgs) and len(
                {frozenset(m) for m in msgs}) == 1:
            return {'kind': 'message', 'count': n, 'parsed': msgs}
        dbl = [_try_packed_doubles(p) for p in payloads]
        if all(d is not None for d in dbl):
            return {'kind': 'packed_doubles', 'count': n,
                    'widths': sorted({d.size for d in dbl}),
                    'arrays': dbl}
        ints = [_try_packed_ints(p) for p in payloads]
        if all(i is not None for i in ints):
            return {'kind': 'packed_ints', 'count': n, 'lists': ints}
        if all(m is not None for m in msgs):
            return {'kind': 'message', 'count': n, 'parsed': msgs}
        return {'kind': 'bytes', 'count': n,
                'sizes': [len(p) for p in payloads[:8]]}
    return {'kind': 'mixed', 'count': n, 'wires': sorted(wires)}


def _summarize(fields) -> Dict[int, dict]:
    return {f: _classify(recs) for f, recs in sorted(fields.items())}


def walk_framing(path: str, max_records: Optional[int] = None
                 ) -> Tuple[bytes, List[int]]:
    """u64-framed walk: header blob + every frame record's byte size."""
    import os
    fsize = os.path.getsize(path)
    sizes: List[int] = []
    with open(path, 'rb') as f:
        raw = f.read(8)
        if len(raw) < 8:
            raise ValueError(f'{path}: too short for a u64 header length')
        (hlen,) = struct.unpack('<Q', raw)
        if hlen > fsize - 8:
            raise ValueError(f'{path}: header length {hlen} exceeds the '
                             f'file — not u64-framed legacy .b3d')
        header = f.read(hlen)
        if len(header) != hlen:
            raise ValueError(f'{path}: truncated header '
                             f'(wanted {hlen} bytes)')
        while True:
            raw = f.read(8)
            if not raw:
                break
            if len(raw) < 8:
                raise ValueError(f'{path}: trailing {len(raw)} bytes are '
                                 f'not a u64 record length')
            (flen,) = struct.unpack('<Q', raw)
            here = f.tell()
            if flen > fsize - here:     # seek past EOF would "succeed"
                raise ValueError(f'{path}: frame record length {flen} '
                                 f'exceeds the remaining file — truncated '
                                 f'or not u64-framed')
            f.seek(flen, 1)
            sizes.append(flen)
            if max_records is not None and len(sizes) >= max_records:
                break
    return header, sizes


def infer_legacy_schema(path: str, max_frames: int = 32) -> dict:
    """Analyze an unknown legacy file; return proposal + builtin diff."""
    header_blob, record_sizes = walk_framing(path)
    header = parse_message(header_blob)
    hsum = _summarize(header)

    proposed_h: Dict[str, int] = {}
    proposed_th: Dict[str, int] = {}
    proposed_f: Dict[str, int] = {}
    pf_classes: List[dict] = []
    notes: List[str] = []

    # --- trial headers: the submessage field carrying the frame_bytes
    # list that reconciles with the walked record sizes -----------------
    msg_fields = [f for f, s in hsum.items() if s['kind'] == 'message']
    frame_bytes_field = None
    trial_headers = None
    for f in msg_fields:
        subs = hsum[f]['parsed']
        candidate_tfs = sorted({tf for sub in subs for tf in sub})
        # try EVERY subfield as packed ints (classification can mislabel
        # varint payloads); the one matching the walked sizes wins
        with_prefix = [s + 8 for s in record_sizes]   # size may count the u64
        for tf in candidate_tfs:
            try:
                concat = []
                for sub in subs:
                    concat.extend(get_packed_ints(sub, tf))
            except ValueError:
                continue
            if concat and concat in (record_sizes, with_prefix):
                proposed_h['trial_header'] = f
                frame_bytes_field = tf
                trial_headers = subs
                if concat == with_prefix:
                    notes.append('frame_bytes includes the 8-byte record '
                                 'length prefix (the built-in writer\'s '
                                 'convention)')
                break
        if trial_headers is not None:
            break
    if trial_headers is None:
        notes.append('no submessage field carries per-frame byte sizes '
                     'matching the walked framing — trial_header / '
                     'frame_bytes unidentified (framing itself may differ)')

    # --- processing-pass headers: remaining repeated submessage field ---
    ph_candidates = [f for f in msg_fields
                     if f != proposed_h.get('trial_header')]
    if len(ph_candidates) == 1:
        proposed_h['processing_pass_header'] = ph_candidates[0]
    elif ph_candidates:
        notes.append(f'processing_pass_header ambiguous among header '
                     f'fields {ph_candidates}')

    # --- trial-header internals -----------------------------------------
    n_trials = len(trial_headers) if trial_headers else 0
    if trial_headers:
        proposed_th['frame_bytes'] = frame_bytes_field
        th0 = trial_headers[0]
        ts0 = _summarize(th0)
        n_frames0 = len(get_packed_ints(th0, frame_bytes_field))
        for tf, c in ts0.items():
            if tf == frame_bytes_field:
                continue
            if c['kind'] == 'string':
                proposed_th.setdefault('name', tf)
            elif c['kind'] == 'varint' and c['count'] == 1 \
                    and c['values'][0] == n_frames0:
                proposed_th.setdefault('trial_length', tf)
            elif c['kind'] == 'double' and 1e-5 < c['values'][0] < 1.0:
                proposed_th.setdefault('trial_timestep', tf)
            elif c['kind'] == 'packed_ints':
                vals = [v for lst in c['lists'] for v in lst]
                if len(vals) == n_frames0 and all(v <= 32 for v in vals):
                    proposed_th.setdefault('missing_grf_reason', tf)
                elif vals and len(vals) < n_frames0 \
                        and all(v <= 8 for v in vals):
                    # short list of tiny enums = per-pass type codes
                    proposed_th.setdefault('trial_pass_type', tf)
            elif c['kind'] in ('varint', 'mixed') and c['count'] > 1:
                proposed_th.setdefault('trial_pass_type', tf)

    # --- frame + pass-frame internals ------------------------------------
    num_dofs = None
    with open(path, 'rb') as f:
        f.seek(8 + len(header_blob))
        frames = []
        for _ in range(min(max_frames, len(record_sizes))):
            (flen,) = struct.unpack('<Q', f.read(8))
            frames.append(parse_message(f.read(flen)))
    pass_field = None
    if frames:
        fs0 = _summarize(frames[0])
        for ff, c in fs0.items():
            if c['kind'] == 'message':
                proposed_f.setdefault('processing_pass', ff)
                pass_field = ff
            elif c['kind'] == 'varint':
                proposed_f.setdefault('missing_grf_reason', ff)
            elif c['kind'] == 'packed_doubles':
                proposed_f.setdefault('raw_force_plate (one of)', ff)
    if pass_field is not None:
        pass0 = fs0[pass_field]['parsed'][0]
        ps = _summarize(pass0)
        widths: Dict[int, int] = {}
        for pf, c in ps.items():
            if c['kind'] == 'packed_doubles':
                widths[pf] = c['arrays'][0].size
            elif c['kind'] in ('packed_ints', 'varint'):
                widths[pf] = -1          # contact flags (ints)
        # num_dofs: the value v such that a header VARINT equals v, a
        # repeated-string header field has v entries (the dof names), and
        # v appears as a pass-frame width (pos/vel/acc/tau are all v
        # wide). All three must agree — no table knowledge involved.
        pass_widths = {w for w in widths.values() if w > 0}
        varint_vals = {c['values'][0]: hf for hf, c in hsum.items()
                       if c['kind'] == 'varint' and c['count'] == 1}
        strlist_counts = {c['count']: hf for hf, c in hsum.items()
                          if c['kind'] == 'string'}
        for v in sorted(pass_widths & set(varint_vals)
                        & set(strlist_counts), reverse=True):
            num_dofs = v
            proposed_h.setdefault('num_dofs', varint_vals[v])
            proposed_h.setdefault('dof_name', strlist_counts[v])
            break
        if num_dofs is None and pass_widths:
            num_dofs = max((w for w in pass_widths if w > 6),
                           default=max(pass_widths))
            notes.append(f'num_dofs={num_dofs} is a fallback guess (no '
                         f'header varint + dof-name list agreed with a '
                         f'pass width)')
        # num_joints: a header varint v with a v-entry string list and an
        # observed width of 3v (joint centers), v != num_dofs
        for v, hf in sorted(varint_vals.items(), reverse=True):
            if v != num_dofs and v in strlist_counts and 3 * v in pass_widths:
                proposed_h.setdefault('num_joints', hf)
                proposed_h.setdefault('joint_name', strlist_counts[v])
                break
        # candidate names per observed width, from the layout signature
        # (rh/nb solved so the signature covers the observed widths best)
        best = None
        for nb in (1, 2, 3, 4):
            for rh in (1, 3, 5, 10, 20):
                layout = pass_channel_layout(num_dofs or 1, nb, rh)
                lw: Dict[int, List[str]] = {}
                for name, w in layout:
                    lw.setdefault(w, []).append(name)
                hit = sum(1 for w in widths.values() if w in lw)
                if best is None or hit > best[0]:
                    best = (hit, nb, rh, lw)
        _, nb, rh, lw = best
        for pf in sorted(widths):
            w = widths[pf]
            cands = (['contact'] if w == -1 else lw.get(w, []))
            pf_classes.append({'field': pf, 'width': w,
                               'candidates': cands})
        notes.append(f'pass-frame width signature solved with '
                     f'num_contact_bodies={nb}, root_history_len={rh}')
        # ordering check: do the observed fields, in field-number order,
        # carry exactly the built-in layout's width sequence? If yes the
        # whole _PF table (index+1 numbering) is confirmed, collisions
        # included.
        layout_widths = [w for _, w in pass_channel_layout(
            num_dofs or 1, nb, rh)]
        observed = [(-1 if widths[pf] == -1 else widths[pf])
                    for pf in sorted(widths)]
        expect = [(-1 if name == 'contact' else w)
                  for name, w in pass_channel_layout(num_dofs or 1, nb, rh)]
        if sorted(widths) == list(range(1, len(expect) + 1)) \
                and observed == expect:
            notes.append('pass-frame field order matches the built-in '
                         'layout width-for-width: _PF confirmed '
                         'including collision classes')
        elif len(observed) != len(expect):
            notes.append(f'pass-frame field count {len(observed)} != '
                         f'built-in layout count {len(expect)} — _PF '
                         f'needs editing (see candidates below)')
        else:
            notes.append('pass-frame width sequence differs from the '
                         'built-in layout order — map fields by the '
                         'candidates below')
        # ground_force_body: a repeated string header field with nb entries
        for hf, c in hsum.items():
            if c['kind'] == 'string' and c['count'] == nb \
                    and hf != proposed_h.get('dof_name'):
                proposed_h.setdefault('ground_force_body', hf)

    # scalar header fields by range
    for hf, c in hsum.items():
        if c['kind'] == 'double' and c['count'] == 1:
            v = c['values'][0]
            if 0.5 < v < 2.7:
                proposed_h.setdefault('height_m', hf)
            elif 10.0 < v < 300.0:
                proposed_h.setdefault('mass_kg', hf)

    # --- diff vs the built-in reconstruction ------------------------------
    diff: List[str] = []
    _PF = _legacy._PF
    for table_name, builtin, proposal in (('_H', _legacy._H, proposed_h),
                                          ('_TH', _legacy._TH, proposed_th),
                                          ('_F', _legacy._F, proposed_f)):
        for name, num in proposal.items():
            b = builtin.get(name.split(' ')[0])
            if b is not None and b != num:
                diff.append(f'{table_name}[{name}]: file says field {num}, '
                            f'built-in table says {b}')
    for entry in pf_classes:
        cands = entry['candidates']
        if len(cands) == 1 and cands[0] in _PF \
                and _PF[cands[0]] != entry['field']:
            diff.append(f"_PF[{cands[0]}]: file says field "
                        f"{entry['field']}, built-in says {_PF[cands[0]]}")

    return {
        'path': path,
        'framing': {'header_bytes': len(header_blob),
                    'num_frame_records': len(record_sizes),
                    'num_trials': n_trials},
        'header_fields': {f: {k: v for k, v in c.items()
                              if k not in ('parsed', 'arrays', 'lists')}
                          for f, c in hsum.items()},
        'proposed': {'H': proposed_h, 'TH': proposed_th, 'F': proposed_f,
                     'PF_width_classes': pf_classes},
        'num_dofs': num_dofs,
        'builtin_diff': diff,
        'notes': notes,
    }


def format_infer_report(report: dict) -> str:
    lines = [f"schema inference: {report['path']}",
             f"  framing: header {report['framing']['header_bytes']} B, "
             f"{report['framing']['num_frame_records']} frame records, "
             f"{report['framing']['num_trials']} trials",
             f"  inferred num_dofs: {report['num_dofs']}"]
    for tbl in ('H', 'TH', 'F'):
        prop = report['proposed'][tbl]
        if prop:
            lines.append(f'  proposed _{tbl}: ' + ', '.join(
                f'{k}={v}' for k, v in sorted(prop.items(),
                                              key=lambda kv: kv[1])))
    pf = report['proposed']['PF_width_classes']
    if pf:
        lines.append('  pass-frame fields (width -> candidates):')
        for e in pf:
            c = ', '.join(e['candidates']) or '??'
            lines.append(f"    field {e['field']:3d} width {e['width']:4d}"
                         f" -> {c}")
    for n in report['notes']:
        lines.append(f'  note: {n}')
    if report['builtin_diff']:
        lines.append('  DISAGREEMENTS with the built-in tables '
                     '(edit b3d_legacy.py accordingly):')
        for d in report['builtin_diff']:
            lines.append(f'    {d}')
    else:
        lines.append('  built-in tables CONSISTENT with every '
                     'uniquely-inferred field')
    return '\n'.join(lines)
