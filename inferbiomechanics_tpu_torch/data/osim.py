"""OpenSim ``.osim`` model XML -> :class:`SkeletonSpec` parser.

Capability parity: real AddBiomechanics ``.b3d`` files carry the subject's
scaled OpenSim model as raw XML in each processing-pass header
(``model_osim_text``); the reference hands it to nimblephysics'
``readSkel`` (AddBiomechanicsDataset.py:127), which parses the full
OpenSim model. This module extracts what the TPU framework's rigid-body
kernels consume (ops/skeleton.py): the body tree (mass / COM / inertia)
and joint topology, including (round 4):

- **coordinate-coupling functions** on CustomJoint TransformAxes —
  SimmSpline / NaturalCubicSpline (natural-cubic knots evaluated by
  ops/spline.py), LinearFunction, Constant, and MultiplierFunction
  (scale folded into the inner function). This covers the Rajagopal
  walker-knee translation splines present in the standard
  AddBiomechanics models.
- **offset-frame orientations**: non-zero ``<orientation>`` on parent
  AND child PhysicalOffsetFrames are carried into the joint transform
  (previously ignored with a warning).
- **ordered rotation axes** for 3-coordinate ('ball') and 6-coordinate
  ('free') CustomJoints (e.g. Rajagopal hips rotate about z, x, y —
  not euler-XYZ).

Remaining approximations (still surfaced via ``warnings``): unknown
function types (e.g. PolynomialFunction) and translation DOFs of
6-coordinate joints along non-canonical axes.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

from inferbiomechanics_tpu_torch.data.b3d import BodySpec, JointSpec, SkeletonSpec

_CANONICAL_AXES = ([1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0])
_FN_TAGS = ('SimmSpline', 'NaturalCubicSpline', 'LinearFunction',
            'Constant', 'MultiplierFunction', 'PiecewiseLinearFunction',
            'PolynomialFunction')


def _floats(text: Optional[str]) -> List[float]:
    return [float(v) for v in (text or '').split()]


def _find_text(el, tag: str, default: str = '') -> str:
    child = el.find(tag)
    return child.text.strip() if child is not None and child.text else default


def _parse_function(el, warnings: List[str], ctx: str) -> Optional[dict]:
    """Parse one OpenSim function element into a coupling 'fn' dict.
    Returns None for functions we cannot represent (warned)."""
    tag = el.tag
    if tag in ('SimmSpline', 'NaturalCubicSpline'):
        x = _floats(_find_text(el, 'x'))
        y = _floats(_find_text(el, 'y'))
        if len(x) != len(y) or len(x) < 2:
            warnings.append(f'{ctx}: malformed spline knots ({len(x)} x, '
                            f'{len(y)} y)')
            return None
        return {'type': 'spline', 'x': x, 'y': y}
    if tag == 'LinearFunction':
        co = _floats(_find_text(el, 'coefficients', '1 0'))
        co = (co + [0.0, 0.0])[:2]
        return {'type': 'linear', 'coeffs': co}
    if tag == 'Constant':
        return {'type': 'constant',
                'value': float(_find_text(el, 'value', '0') or 0)}
    if tag == 'MultiplierFunction':
        scale = float(_find_text(el, 'scale', '1') or 1)
        inner_el = None
        wrapper = el.find('function')
        pool = list(wrapper) if wrapper is not None else list(el)
        for c in pool:
            if c.tag in _FN_TAGS:
                inner_el = c
                break
        if inner_el is None:
            warnings.append(f'{ctx}: MultiplierFunction without inner '
                            f'function')
            return None
        inner = _parse_function(inner_el, warnings, ctx)
        if inner is None:
            return None
        if inner['type'] == 'spline':
            inner['y'] = [v * scale for v in inner['y']]
        elif inner['type'] == 'linear':
            inner['coeffs'] = [v * scale for v in inner['coeffs']]
        elif inner['type'] == 'constant':
            inner['value'] *= scale
        return inner
    warnings.append(f'{ctx}: unsupported function {tag} approximated as '
                    f'identity')
    return None


def _axis_function(ta, warnings: List[str], ctx: str) -> Optional[dict]:
    """The function attached to a TransformAxis: a direct child function
    element (OpenSim 4.x) or one wrapped in <function> (3.x). A
    coordinate-driven axis with no function element is the identity."""
    wrapper = ta.find('function')
    pool = list(wrapper) if wrapper is not None else list(ta)
    for c in pool:
        if c.tag in _FN_TAGS:
            return _parse_function(c, warnings, ctx)
    return {'type': 'identity'}


def _fn_is_zero(fn: Optional[dict]) -> bool:
    if fn is None:
        return True
    if fn['type'] == 'constant':
        return abs(fn['value']) < 1e-12
    if fn['type'] == 'linear':
        return all(abs(v) < 1e-12 for v in fn['coeffs'])
    if fn['type'] == 'spline':
        return all(abs(v) < 1e-12 for v in fn['y'])
    return False


def parse_osim(xml_text: str) -> Tuple[SkeletonSpec, List[str]]:
    """Parse an OpenSim model XML string. Returns (spec, warnings)."""
    warnings: List[str] = []
    root = ET.fromstring(xml_text)
    model = root.find('Model') if root.tag == 'OpenSimDocument' else root
    if model is None:
        raise ValueError('no <Model> element in osim XML')

    # -- bodies ---------------------------------------------------------
    bodies: List[BodySpec] = []
    body_index: Dict[str, int] = {}
    bodyset = model.find('BodySet/objects')
    for b in (bodyset if bodyset is not None else []):
        if b.tag != 'Body':
            continue
        name = b.get('name', f'body_{len(bodies)}')
        mass = float(_find_text(b, 'mass', '0') or 0)
        com = _floats(_find_text(b, 'mass_center', '0 0 0')) or [0, 0, 0]
        inertia = _floats(_find_text(b, 'inertia', ''))
        if not inertia:  # OpenSim 3.x style: six scalar elements
            inertia = [float(_find_text(b, f'inertia_{k}', '0') or 0)
                       for k in ('xx', 'yy', 'zz', 'xy', 'xz', 'yz')]
        if len(inertia) != 6:
            inertia = (inertia + [0.0] * 6)[:6]
        body_index[name] = len(bodies)
        bodies.append(BodySpec(name=name, mass=mass, com=com[:3],
                               inertia=inertia))

    # -- joints ---------------------------------------------------------
    def frame_of(joint_el, socket_tag: str):
        """Resolve a joint's parent/child socket to
        (body name, translation, orientation)."""
        ref = _find_text(joint_el, socket_tag)
        frame_name = ref.split('/')[-1]
        for fr in joint_el.findall('frames/PhysicalOffsetFrame'):
            if fr.get('name') == frame_name:
                parent = _find_text(fr, 'socket_parent')
                trans = _floats(_find_text(fr, 'translation', '0 0 0'))
                orient = _floats(_find_text(fr, 'orientation', '0 0 0'))
                body = parent.split('/')[-1]
                return (body, (trans + [0, 0, 0])[:3],
                        (orient + [0, 0, 0])[:3])
        # direct socket to a body/ground (no offset frame)
        return frame_name, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]

    joints: List[JointSpec] = []
    jointset = model.find('JointSet/objects')
    for j in (jointset if jointset is not None else []):
        name = j.get('name', f'joint_{len(joints)}')
        parent_body, translation, orientation = frame_of(
            j, 'socket_parent_frame')
        child_body, child_trans, child_orient = frame_of(
            j, 'socket_child_frame')
        parent_idx = body_index.get(parent_body, -1)  # ground -> -1
        if child_body not in body_index:
            warnings.append(f'{name}: unknown child body {child_body}, '
                            f'skipped')
            continue
        child_idx = body_index[child_body]

        axis = [0.0, 0.0, 1.0]
        rot_axes: Optional[List[List[float]]] = None
        couplings: List[dict] = []
        if j.tag == 'WeldJoint':
            jtype = 'fixed'
        elif j.tag == 'PinJoint':
            jtype = 'revolute'
        elif j.tag in ('BallJoint', 'GimbalJoint'):
            jtype = 'ball'
        elif j.tag == 'FreeJoint':
            jtype = 'free'
        elif j.tag == 'CustomJoint':
            coords = [c.get('name')
                      for c in j.findall('coordinates/Coordinate')]
            # ordered TransformAxis records: (name, axis, coord, fn)
            axes = []
            for ta in j.findall('SpatialTransform/TransformAxis'):
                ta_name = ta.get('name', '')
                ta_axis = (_floats(_find_text(ta, 'axis', '0 0 1'))
                           + [0, 0, 1])[:3]
                ta_coord = _find_text(ta, 'coordinates')
                fn = _axis_function(ta, warnings, f'{name}/{ta_name}')
                axes.append((ta_name, ta_axis, ta_coord, fn))

            def axes_for(coord_names, kind_prefix):
                """Ordered rotation axes matched to coordinates by name
                (falling back to TransformAxis order)."""
                picked = []
                pool = [a for a in axes if a[0].startswith(kind_prefix)
                        and a[2]]
                for ci, cn in enumerate(coord_names):
                    match = next((a for a in pool if a[2] == cn),
                                 pool[ci] if ci < len(pool) else None)
                    picked.append(match[1] if match else
                                  list(_CANONICAL_AXES[min(ci, 2)]))
                return picked

            if len(coords) >= 6:
                jtype = 'free'
                rot_axes = axes_for(coords[:3], 'rotation')
                driven_rots = {a[2] for a in axes
                               if a[0].startswith('rotation') and a[2]}
                if driven_rots and not all(c in driven_rots
                                           for c in coords[:3]):
                    warnings.append(
                        f'{name}: free-joint coordinate order assumed '
                        f'[3 rotations, 3 translations] but the first '
                        f'three do not all drive rotation axes')
                # translation DOFs must ride canonical axes (they do in
                # every standard model); anything else is approximated
                for a in axes:
                    if (a[0].startswith('translation') and a[2]
                            and a[2] in coords[3:]):
                        want = _CANONICAL_AXES[
                            int(a[0][-1]) - 1 if a[0][-1].isdigit() else 0]
                        if any(abs(x - w) > 1e-9
                               for x, w in zip(a[1], want)):
                            warnings.append(
                                f'{name}: non-canonical translation axis '
                                f'{a[1]} approximated as {list(want)}')
            elif len(coords) == 3:
                jtype = 'ball'
                rot_axes = axes_for(coords, 'rotation')
                # a true ball joint drives 3 ROTATION axes; a planar-style
                # joint (rotations + translations) cannot be represented
                # as 'ball' — keep the loud approximation warning
                driven_rots = {a[2] for a in axes
                               if a[0].startswith('rotation') and a[2]}
                if not all(c in driven_rots for c in coords):
                    warnings.append(
                        f'{name}: 3 coordinates approximated as ball '
                        f'(coordinates {sorted(set(coords) - driven_rots)} '
                        f'do not drive rotation axes)')
            elif len(coords) == 1:
                jtype = 'revolute'
                primary_rot = None
                for ta_name, ta_axis, ta_coord, fn in axes:
                    kind = ('rotation' if ta_name.startswith('rotation')
                            else 'translation')
                    if not ta_coord:
                        # constant offset axes: keep non-zero constants
                        if fn and fn['type'] == 'constant' \
                                and not _fn_is_zero(fn):
                            couplings.append({'kind': kind, 'axis': ta_axis,
                                              'fn': fn})
                        continue
                    if fn is None:  # unsupported function: identity fallback
                        fn = {'type': 'identity'}
                    if _fn_is_zero(fn):
                        continue
                    if (kind == 'rotation' and primary_rot is None
                            and fn['type'] == 'identity'):
                        primary_rot = ta_axis
                    couplings.append({'kind': kind, 'axis': ta_axis,
                                      'fn': fn})
                axis = primary_rot or next(
                    (c['axis'] for c in couplings if c['kind'] == 'rotation'),
                    [0.0, 0.0, 1.0])
                # a lone identity rotation is a plain hinge — drop the
                # coupling machinery so legacy specs stay byte-identical
                if (len(couplings) == 1
                        and couplings[0]['kind'] == 'rotation'
                        and couplings[0]['fn']['type'] == 'identity'):
                    couplings = []
            elif len(coords) == 0:
                jtype = 'fixed'
            else:
                jtype = 'ball'
                warnings.append(
                    f'{name}: {len(coords)} coordinates approximated as ball')
        else:
            warnings.append(f'{name}: joint tag {j.tag} treated as fixed')
            jtype = 'fixed'

        # canonical-euler rot_axes are the legacy default: drop them
        if rot_axes is not None and all(
                all(abs(x - w) < 1e-9 for x, w in zip(a, want))
                for a, want in zip(rot_axes, _CANONICAL_AXES)):
            rot_axes = None

        joints.append(JointSpec(
            name=name, type=jtype, parent_body=parent_idx,
            child_body=child_idx,
            translation=(translation + [0, 0, 0])[:3],
            axis=(axis + [0, 0, 1])[:3],
            orientation=orientation,
            child_translation=child_trans,
            child_orientation=child_orient,
            rot_axes=rot_axes,
            couplings=couplings))

    # topological order: parents before children (FK unrolls in order)
    ordered: List[JointSpec] = []
    placed = {-1}
    pending = list(joints)
    while pending:
        progress = False
        for j in list(pending):
            if j.parent_body in placed:
                ordered.append(j)
                placed.add(j.child_body)
                pending.remove(j)
                progress = True
        if not progress:
            warnings.append(f'{len(pending)} joints form no tree from '
                            f'ground; appended as-is')
            ordered.extend(pending)
            break
    spec = SkeletonSpec(joints=ordered, bodies=bodies)
    spec.fidelity_warnings = list(warnings)
    return spec, warnings
