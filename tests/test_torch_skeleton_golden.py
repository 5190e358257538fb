"""Textbook oracles for the port's rigid-body functions
(inferbiomechanics_tpu_torch/ops/skeleton.py), in float64.

The cases of tests/test_skeleton_golden.py, held to the same closed forms,
derived independently of the implementation: a single pendulum (COM, COM
acceleration, inverse dynamics, energies), the planar double pendulum's
equations of motion, and a free-root point mass (Newton, with and without an
external force). In float64 the closed forms hold to 1e-9.
"""

import numpy as np
import pytest
import torch

from inferbiomechanics_tpu_torch.data.b3d import BodySpec, JointSpec, SkeletonSpec
from inferbiomechanics_tpu_torch.ops.skeleton import GRAVITY, compile_skeleton

G = 9.81
TOL = 1e-9


def _t(*v):
    return torch.tensor(v, dtype=torch.float64)


def _skel(spec):
    return compile_skeleton(spec, dtype=torch.float64)


def pendulum_skeleton(m=2.0, L=0.5):
    """One revolute joint about +z at the world origin; a point mass at
    distance L 'below' the joint in the body frame."""
    return SkeletonSpec(
        joints=[JointSpec(name='hinge', type='revolute', parent_body=-1,
                          child_body=0, translation=[0.0, 0.0, 0.0],
                          axis=[0.0, 0.0, 1.0])],
        bodies=[BodySpec(name='rod', mass=m, com=[0.0, -L, 0.0], inertia=[0.0] * 6)])


def test_pendulum_com_position_and_acceleration():
    m, L = 2.0, 0.5
    sk = _skel(pendulum_skeleton(m, L))
    th, dth, ddth = 0.3, 0.7, 1.1
    q, dq, ddq = _t(th), _t(dth), _t(ddth)
    # com_world = R_z(th) @ [0,-L,0] = [L sin th, -L cos th, 0]
    np.testing.assert_allclose(sk.com(q).numpy(), [L * np.sin(th), -L * np.cos(th), 0.0],
                               atol=TOL)
    expect = [L * (np.cos(th) * ddth - np.sin(th) * dth ** 2),
              L * (np.sin(th) * ddth + np.cos(th) * dth ** 2), 0.0]
    np.testing.assert_allclose(sk.com_acceleration(q, dq, ddq).numpy(), expect, atol=TOL)


def test_pendulum_inverse_dynamics_textbook():
    """tau = m L^2 th'' + m g L sin(th)  (theta from straight-down), the
    four states as one batch of frames."""
    m, L = 2.0, 0.5
    sk = _skel(pendulum_skeleton(m, L))
    states = np.array([(0.0, 0.0, 0.0), (0.3, 0.7, 1.1), (-1.2, 2.0, -0.5),
                       (np.pi / 2, 0.0, 0.0)])
    q, dq, ddq = (torch.from_numpy(states[:, i:i + 1]) for i in range(3))
    tau = sk.inverse_dynamics(q, dq, ddq).numpy()[:, 0]
    th, ddth = states[:, 0], states[:, 2]
    np.testing.assert_allclose(tau, m * L ** 2 * ddth + m * G * L * np.sin(th), atol=TOL)


def test_pendulum_energy_golden():
    m, L = 2.0, 0.5
    sk = _skel(pendulum_skeleton(m, L))
    th, dth = 0.4, 1.3
    T = float(sk.kinetic_energy(_t(th), _t(dth)))
    V = float(sk.potential_energy(_t(th)))
    assert T == pytest.approx(0.5 * m * L ** 2 * dth ** 2, abs=TOL)
    # V = -m g . com ; with g=(0,-G,0): V = -m G L cos(th) (+0 at joint)
    assert V == pytest.approx(-m * G * L * np.cos(th), abs=TOL)


def double_pendulum_skeleton(m1, m2, l1, l2):
    """Two revolute z-joints: shoulder at the origin, elbow at the tip of
    link 1 (body-frame offset [0,-l1,0]); point masses at the link tips."""
    return SkeletonSpec(
        joints=[
            JointSpec(name='shoulder', type='revolute', parent_body=-1, child_body=0,
                      translation=[0.0, 0.0, 0.0], axis=[0.0, 0.0, 1.0]),
            JointSpec(name='elbow', type='revolute', parent_body=0, child_body=1,
                      translation=[0.0, -l1, 0.0], axis=[0.0, 0.0, 1.0]),
        ],
        bodies=[
            BodySpec(name='link1', mass=m1, com=[0.0, -l1, 0.0], inertia=[0.0] * 6),
            BodySpec(name='link2', mass=m2, com=[0.0, -l2, 0.0], inertia=[0.0] * 6),
        ])


def double_pendulum_tau(m1, m2, l1, l2, q, dq, ddq):
    """Classic point-mass double-pendulum EoM (absolute-angle derivation,
    e.g. Goldstein / standard robotics texts), angles from straight-down,
    q2 relative to link 1: an oracle independent of the autodiff ID."""
    t1, t2 = q
    dt1, dt2 = dq
    a1, a2 = ddq
    m11 = (m1 + m2) * l1 ** 2 + m2 * l2 ** 2 + 2 * m2 * l1 * l2 * np.cos(t2)
    m12 = m2 * l2 ** 2 + m2 * l1 * l2 * np.cos(t2)
    m22 = m2 * l2 ** 2
    h = m2 * l1 * l2 * np.sin(t2)
    c1 = -h * (2 * dt1 * dt2 + dt2 ** 2)
    c2 = h * dt1 ** 2
    g1 = (m1 + m2) * G * l1 * np.sin(t1) + m2 * G * l2 * np.sin(t1 + t2)
    g2 = m2 * G * l2 * np.sin(t1 + t2)
    return np.array([m11 * a1 + m12 * a2 + c1 + g1, m12 * a1 + m22 * a2 + c2 + g2])


def test_double_pendulum_inverse_dynamics_textbook():
    m1, m2, l1, l2 = 1.5, 0.8, 0.6, 0.4
    sk = _skel(double_pendulum_skeleton(m1, m2, l1, l2))
    rng = np.random.default_rng(0)
    q = rng.uniform(-1.5, 1.5, (5, 2))
    dq = rng.uniform(-2, 2, (5, 2))
    ddq = rng.uniform(-3, 3, (5, 2))
    tau = sk.inverse_dynamics(*(torch.from_numpy(a) for a in (q, dq, ddq))).numpy()
    for k in range(5):
        np.testing.assert_allclose(tau[k], double_pendulum_tau(m1, m2, l1, l2, q[k], dq[k],
                                                               ddq[k]), atol=TOL)


def free_root_skeleton(m=3.0):
    return SkeletonSpec(
        joints=[JointSpec(name='root', type='free', parent_body=-1, child_body=0,
                          translation=[0.0, 0.0, 0.0])],
        bodies=[BodySpec(name='pelvis', mass=m, com=[0.0, 0.0, 0.0],
                         inertia=[0.01, 0.01, 0.01, 0.0, 0.0, 0.0])])


def test_free_root_translation_newton():
    """Pure translation: tau_trans = m (a - g); rotational tau = 0."""
    m = 3.0
    sk = _skel(free_root_skeleton(m))
    q = _t(0.0, 0.0, 0.0, 0.2, 1.0, -0.3)
    dq = _t(0.0, 0.0, 0.0, 0.5, -0.2, 0.1)
    a = np.array([1.0, 2.0, -0.5])
    ddq = torch.cat([torch.zeros(3, dtype=torch.float64), torch.from_numpy(a)])
    tau = sk.inverse_dynamics(q, dq, ddq).numpy()
    g = np.asarray(GRAVITY)
    np.testing.assert_allclose(tau[:3], 0.0, atol=TOL)
    np.testing.assert_allclose(tau[3:], m * (a - g), atol=TOL)
    # the COM acceleration is the translational ddq
    np.testing.assert_allclose(sk.com_acceleration(q, dq, ddq).numpy(), a, atol=TOL)


def test_free_root_external_force_newton():
    """A world force F (no moment about the COM) applied to a floating
    point mass supplies F to the translational DOFs: tau = m(a-g) - F."""
    m = 3.0
    sk = _skel(free_root_skeleton(m))
    p = np.array([0.2, 1.0, -0.3])
    q = torch.cat([torch.zeros(3, dtype=torch.float64), torch.from_numpy(p)])
    dq = torch.zeros(6, dtype=torch.float64)
    a = np.array([0.5, -1.0, 2.0])
    ddq = torch.cat([torch.zeros(3, dtype=torch.float64), torch.from_numpy(a)])
    F = np.array([4.0, 5.0, -6.0])
    # a wrench about the WORLD origin: moment n = p x F puts the line of
    # action through the body COM (no induced torque)
    n = np.cross(p, F)
    tau = sk.inverse_dynamics(q, dq, ddq,
                              {0: torch.from_numpy(np.concatenate([n, F]))}).numpy()
    g = np.asarray(GRAVITY)
    np.testing.assert_allclose(tau[3:], m * (a - g) - F, atol=TOL)
    np.testing.assert_allclose(tau[:3], 0.0, atol=TOL)
