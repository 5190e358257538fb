"""The port's rigid-body functions (inferbiomechanics_tpu_torch/ops/{spatial,
spline,skeleton}.py) against the JAX package's on the same numpy inputs.

Skeletons: the standard 12-joint, 23-DOF skeleton and the coupled OpenSim
models of tests/test_osim.py (``KNEE_OSIM``: a spline and a linear coupling
on a knee with both offset frames; ``OSIM``: a free root, ordered ball axes,
a coupled knee), parsed by each package's own ``data/osim.py`` from
``tests/fixtures/knee_golden.osim`` and ``tests/fixtures/subject_scaled.osim``.
Inputs from a seeded numpy generator, 16 frames a case.

Tolerances: float32 spatial, spline and FK functions at rtol 1e-5 / atol
1e-6 x max|.|; COM velocity and acceleration and tau at 1e-4 x max|.|. Each
side is also held to the port's float64 evaluation of the same inputs, so
that a failure names the side that moved. The JAX side compiles one program
a skeleton for the kinematics and one for inverse dynamics (the standard
skeleton's takes ~25 s here).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.data.osim import parse_osim as jax_parse_osim
from inferbiomechanics_tpu.data.synthetic import standard_skeleton as jax_standard_skeleton
from inferbiomechanics_tpu.ops import skeleton as jsk
from inferbiomechanics_tpu.ops import spatial as jsp
from inferbiomechanics_tpu.ops import spline as jspl
from inferbiomechanics_tpu_torch.data.osim import parse_osim
from inferbiomechanics_tpu_torch.data.synthetic import standard_skeleton
from inferbiomechanics_tpu_torch.ops import skeleton as tsk
from inferbiomechanics_tpu_torch.ops import spatial as tsp
from inferbiomechanics_tpu_torch.ops import spline as tspl

FIXTURES = Path(__file__).parent / 'fixtures'
N = 16
F32 = dict(rtol=1e-5, atol=1e-6)      # atol x max|float64|
DYN = dict(rtol=0.0, atol=1e-4)


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def held(name, port, jax_value, f64, rtol, atol):
    """``port`` and ``jax_value`` agree, and each agrees with the port's
    float64 evaluation ``f64`` (atol relative to max|f64|)."""
    f64 = np.asarray(f64, np.float64)
    tol = dict(rtol=rtol, atol=atol * max(float(np.abs(f64).max()), 1e-30))
    for side, v in (('port', port), ('jax', jax_value)):
        np.testing.assert_allclose(np.asarray(v, np.float64), f64, **tol,
                                   err_msg=f'{name}: {side} against float64')
    np.testing.assert_allclose(np.asarray(port, np.float64), np.asarray(jax_value, np.float64),
                               **tol, err_msg=f'{name}: port against jax')


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


# ---- spatial --------------------------------------------------------------

def test_spatial_functions_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(N, 3)).astype(np.float32)
    ang = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    axis = v / np.linalg.norm(v, axis=-1, keepdims=True)
    p = rng.normal(size=(N, 3)).astype(np.float32)
    w = rng.normal(size=(N, 6)).astype(np.float32)
    R = np.array(jsp.euler_xyz_to_matrix(ang))
    m = rng.normal(size=(N, 3, 3)).astype(np.float32)
    cases = {
        'skew': (lambda s, a: s.skew(a[0]), (v,)),
        'unskew': (lambda s, a: s.unskew(a[0]), (m,)),
        'euler_xyz_to_matrix': (lambda s, a: s.euler_xyz_to_matrix(a[0]), (ang,)),
        'axis_angle_to_matrix': (lambda s, a: s.axis_angle_to_matrix(a[0], a[1]),
                                 (axis, ang[:, 0])),
        'dAdInvT': (lambda s, a: s.dAdInvT(a[0], a[1], a[2]), (R, p, w)),
        'transform_point': (lambda s, a: s.transform_point(a[0], a[1], a[2]), (R, p, v)),
        'inverse_transform_point': (lambda s, a: s.inverse_transform_point(a[0], a[1], a[2]),
                                    (R, p, v)),
    }
    for name, (fn, args) in cases.items():
        want = np.asarray(fn(jsp, [jnp.asarray(a) for a in args]))
        got = fn(tsp, [_t(a) for a in args]).numpy()
        f64 = fn(tsp, [_t(a, torch.float64) for a in args]).numpy()
        assert got.shape == want.shape, name
        held(name, got, want, f64, **F32)


# ---- spline ---------------------------------------------------------------

KNOTS_X = [-2.0944, -1.5708, -1.0472, -0.5236, 0.0, 0.7854]
KNOTS_Y = [-0.0098, -0.0093, -0.0083, -0.0045, 0.0, 0.0019]


def test_second_derivative_matrix_is_the_jax_packages():
    np.testing.assert_array_equal(tspl.natural_cubic_second_derivative_matrix(KNOTS_X),
                                  jspl.natural_cubic_second_derivative_matrix(KNOTS_X))
    for bad, words in (([0.0], 'at least 2 knots'), ([0.0, 1.0, 1.0], 'strictly increasing')):
        for mod in (tspl, jspl):
            with pytest.raises(ValueError, match=words):
                mod.natural_cubic_second_derivative_matrix(bad)


@pytest.mark.parametrize('where', ['in_range', 'out_of_range'])
def test_spline_values_and_gradients_match_jax(where):
    rng = np.random.default_rng(1)
    lo, hi = (-2.0, 0.7) if where == 'in_range' else (-3.5, 2.0)
    q = rng.uniform(lo, hi, N).astype(np.float32)
    if where == 'out_of_range':
        q[:4] = [-3.5, -2.2, 0.9, 2.0]
    # one set of ordinates, and a row of scaled ordinates a query
    y_rows = (np.asarray(KNOTS_Y) * rng.uniform(0.8, 1.2, (N, 1))).astype(np.float32)
    jspline = jspl.NaturalCubicSpline(KNOTS_X)

    def port(dtype):
        s = tspl.NaturalCubicSpline(KNOTS_X, KNOTS_Y, dtype=dtype)
        qt, yt = _t(q, dtype), _t(y_rows, dtype)
        return (s(qt).numpy(), torch.func.grad(lambda x: s(x).sum())(qt).numpy(),
                s(qt, y=yt).numpy(),
                torch.func.grad(lambda x: s(x, y=yt).sum())(qt).numpy())

    y1 = jnp.asarray(KNOTS_Y, jnp.float32)
    want = [np.asarray(v) for v in jax.jit(lambda q, y_rows: (
        jspline(q, y=y1), jax.vmap(jax.grad(lambda x: jspline(x, y=y1)))(q),
        jax.vmap(lambda x, y: jspline(x, y=y))(q, y_rows),
        jax.vmap(jax.grad(lambda x, y: jspline(x, y=y)))(q, y_rows)))(q, y_rows)]
    for name, got, w, f64 in zip(('value', 'd/dq', 'value, rows', 'd/dq, rows'),
                                 port(torch.float32), want, port(torch.float64)):
        held(f'{where} {name}', got, w, f64, **F32)


# ---- skeletons ------------------------------------------------------------

def _skeletons():
    """name -> (port spec, JAX spec, q range, contact body indices)."""
    out = {'standard': (standard_skeleton(), jax_standard_skeleton(), 0.4, [4, 9])}
    for name, path in (('knee_osim', 'knee_golden.osim'), ('osim', 'subject_scaled.osim')):
        text = (FIXTURES / path).read_text()
        spec, _ = parse_osim(text)
        jspec, _ = jax_parse_osim(text)
        out[name] = (spec, jspec, 0.9, [0, len(spec.bodies) - 1])
    return out


SKELETONS = _skeletons()


def _inputs(name):
    spec, jspec, scale, cbi = SKELETONS[name]
    d = spec.num_dofs
    rng = np.random.default_rng(len(name))
    q = (rng.uniform(-1, 1, (N, d)) * scale).astype(np.float32)
    dq, ddq = (rng.normal(size=(N, d)).astype(np.float32) for _ in range(2))
    w = (rng.normal(size=(N, 6 * len(cbi))) * 20).astype(np.float32)
    return q, dq, ddq, w


@pytest.mark.parametrize('name', list(SKELETONS))
def test_kinematics_match_jax(name):
    """FK, joint centres, COM, COM velocity and acceleration: one JAX
    program a skeleton."""
    spec, jspec, _, _ = SKELETONS[name]
    q, dq, ddq, _ = _inputs(name)
    js = jsk.compile_skeleton(jspec)
    names = ('fk R', 'fk p', 'joint_world_positions', 'com', 'com_velocity',
             'com_acceleration')
    want = jax.jit(jax.vmap(lambda a, b, c: (
        *js.fk(a), js.joint_world_positions(a), js.com(a), js.com_velocity(a, b),
        js.com_acceleration(a, b, c))))(q, dq, ddq)

    def port(dtype):
        s = tsk.compile_skeleton(spec, dtype=dtype)
        a, b, c = (_t(v, dtype) for v in (q, dq, ddq))
        return [v.numpy() for v in (*s.fk(a), s.joint_world_positions(a), s.com(a),
                                     s.com_velocity(a, b), s.com_acceleration(a, b, c))]

    for fname, got, jv, f64 in zip(names, port(torch.float32), want, port(torch.float64)):
        held(f'{name} {fname}', got, np.asarray(jv), f64,
             **(DYN if fname.startswith('com_') else F32))


@pytest.mark.parametrize('name', list(SKELETONS))
def test_inverse_dynamics_matches_jax(name):
    """tau from predicted root-frame contact wrenches
    (``inverse_dynamics_from_predictions``) on every skeleton, and, on the
    smallest, also without external wrenches: one JAX program a skeleton
    (both functions in one program cost the standard skeleton ~11 s more)."""
    spec, jspec, _, cbi = SKELETONS[name]
    q, dq, ddq, w = _inputs(name)
    js = jsk.compile_skeleton(jspec)
    no_ext = name == 'knee_osim'

    def jax_fn(a, b, c, d):
        out = (js.inverse_dynamics_from_predictions(a, b, c, cbi, d),)
        return out + ((js.inverse_dynamics(a, b, c),) if no_ext else ())

    want = jax.jit(jax.vmap(jax_fn))(q, dq, ddq, w)

    def port(dtype):
        s = tsk.compile_skeleton(spec, dtype=dtype)
        a = [_t(v, dtype) for v in (q, dq, ddq, w)]
        out = (s.inverse_dynamics_from_predictions(*a[:3], cbi, a[3]).numpy(),)
        return out + ((s.inverse_dynamics(*a[:3]).numpy(),) if no_ext else ())

    for what, got, jv, f64 in zip(('from predictions', 'no external wrench'),
                                  port(torch.float32), want, port(torch.float64)):
        held(f'{name} tau, {what}', got, np.asarray(jv), f64, **DYN)
    if no_ext:     # the external wrenches move tau
        assert np.abs(np.asarray(want[0]) - np.asarray(want[1])).max() > 0.1


def test_constants_and_structure_match_jax():
    np.testing.assert_array_equal(np.float32(tsk.GRAVITY), np.asarray(jsk.GRAVITY))
    assert tsk.PARAM_FIELDS == jsk.PARAM_FIELDS
    specs = {n: v[:2] for n, v in SKELETONS.items()}
    for a in specs:
        for b in specs:
            assert (tsk.skeletons_structurally_equal(specs[a][0], specs[b][0])
                    == jsk.skeletons_structurally_equal(specs[a][1], specs[b][1])), (a, b)
    port = tsk.compile_skeleton(specs['osim'][0])
    js = jsk.compile_skeleton(specs['osim'][1])
    for f in tsk.PARAM_FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(js, f)), f)
    assert (port.dof_offsets, port.num_dofs, port.body_index, port.total_mass) == (
        js.dof_offsets, js.num_dofs, js.body_index, js.total_mass)


def _scaled(spec, k: float):
    """``spec`` with its masses, COMs, joint offsets and coupling
    parameters scaled by ``k`` (a subject's scaled model)."""
    import copy
    s = copy.deepcopy(spec)
    for b in s.bodies:
        b.mass *= k
        b.com = [c * k for c in b.com]
        b.inertia = [i * k ** 3 for i in b.inertia]
    for j in s.joints:
        j.translation = [c * k for c in j.translation]
        for c in j.couplings:
            if c['fn']['type'] == 'spline':
                c['fn']['y'] = [v * k for v in c['fn']['y']]
            elif c['fn']['type'] == 'linear':
                c['fn']['coeffs'] = [v * k for v in c['fn']['coeffs']]
    return s


@pytest.mark.parametrize('name', ['standard', 'knee_osim'])
def test_param_stack_rows_match_per_subject_skeletons(name):
    """Each frame's row of the per-subject stack gives what that subject's
    own skeleton gives (the port's own evaluation, held to JAX above)."""
    spec, _, _, cbi = SKELETONS[name]
    subjects = [_scaled(spec, k) for k in (1.0, 1.25, 0.8)]
    q, dq, ddq, w = (_t(a, torch.float64) for a in _inputs(name))
    sidx = torch.arange(N) % len(subjects)
    stack = tsk.skeleton_param_stack(subjects, dtype=torch.float64)
    assert stack['coupling_params'].shape[0] == len(subjects)
    rows = tsk.with_params(tsk.compile_skeleton(spec, dtype=torch.float64),
                           {k: v[sidx] for k, v in stack.items()})
    got = (rows.fk(q)[1], rows.com_acceleration(q, dq, ddq),
           rows.inverse_dynamics_from_predictions(q, dq, ddq, cbi, w))
    for s, sub in enumerate(subjects):
        own = tsk.compile_skeleton(sub, dtype=torch.float64)
        m = sidx == s
        want = (own.fk(q[m])[1], own.com_acceleration(q[m], dq[m], ddq[m]),
                own.inverse_dynamics_from_predictions(q[m], dq[m], ddq[m], cbi, w[m]))
        for g, wv in zip(got, want):
            np.testing.assert_allclose(g[m].numpy(), wv.numpy(), rtol=1e-12, atol=1e-12)


def test_param_stack_refuses_another_structure_in_jax_words():
    a, b = SKELETONS['standard'][:2], SKELETONS['osim'][:2]
    errors = []
    for mod, specs in ((tsk, [a[0], b[0]]), (jsk, [a[1], b[1]])):
        with pytest.raises(ValueError) as e:
            mod.skeleton_param_stack(specs)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_osim_fixtures_are_the_jax_suites_models():
    import test_osim
    assert (FIXTURES / 'knee_golden.osim').read_text() == test_osim.KNEE_OSIM
    assert (FIXTURES / 'subject_scaled.osim').read_text() == test_osim.OSIM
