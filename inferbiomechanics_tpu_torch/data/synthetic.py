"""Synthetic subject generator: test fixture + benchmark data source.

The reference has no test fixtures at all (SURVEY.md §4); real
AddBiomechanics data is not redistributable and nimblephysics is not
available here, so this module generates gait-like subjects in the
B3D-TPU format. Signals are smooth, phase-coherent sinusoids with
alternating foot contact and GRF that tracks total-mass dynamics
(F ≈ m·(a_com − g) split across feet in stance), which is enough to
exercise every pipeline stage (window masking, featurization,
mass-normalization, loss semantics, training convergence).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from inferbiomechanics_tpu_torch.data.b3d import (
    BodySpec,
    JointSpec,
    MissingGRFReason,
    ProcessingPassType,
    SkeletonSpec,
    TrialData,
    layout_offsets,
    layout_total,
    pass_channel_layout,
    write_subject,
)

GRAVITY = np.array([0.0, -9.81, 0.0])

CONTACT_BODIES = ['calcn_r', 'calcn_l']


def standard_skeleton() -> SkeletonSpec:
    """A 23-DOF lower-body+torso humanoid in the standard layout.

    Mirrors the rajagopal_no_arms DOF structure the reference asserts on
    (AddBiomechanicsDataset.py:141-156: 23 DOFs identical across subjects):
    pelvis free root (6) + 2×(hip ball 3, knee 1, ankle 1, subtalar 1,
    mtp 1) + lumbar ball (3) = 23; 12 joint centers.
    """
    bodies = [
        BodySpec('pelvis', 11.8, [0.0, 0.0, 0.0], [0.10, 0.08, 0.10, 0, 0, 0]),
        BodySpec('femur_r', 9.3, [0.0, -0.17, 0.0], [0.13, 0.03, 0.13, 0, 0, 0]),
        BodySpec('tibia_r', 3.7, [0.0, -0.19, 0.0], [0.05, 0.005, 0.05, 0, 0, 0]),
        BodySpec('talus_r', 0.1, [0.0, 0.0, 0.0], [0.001, 0.001, 0.001, 0, 0, 0]),
        BodySpec('calcn_r', 1.25, [0.1, 0.03, 0.0], [0.0014, 0.0039, 0.0041, 0, 0, 0]),
        BodySpec('toes_r', 0.22, [0.035, 0.006, -0.018], [0.0001, 0.0002, 0.0001, 0, 0, 0]),
        BodySpec('femur_l', 9.3, [0.0, -0.17, 0.0], [0.13, 0.03, 0.13, 0, 0, 0]),
        BodySpec('tibia_l', 3.7, [0.0, -0.19, 0.0], [0.05, 0.005, 0.05, 0, 0, 0]),
        BodySpec('talus_l', 0.1, [0.0, 0.0, 0.0], [0.001, 0.001, 0.001, 0, 0, 0]),
        BodySpec('calcn_l', 1.25, [0.1, 0.03, 0.0], [0.0014, 0.0039, 0.0041, 0, 0, 0]),
        BodySpec('toes_l', 0.22, [0.035, 0.006, 0.018], [0.0001, 0.0002, 0.0001, 0, 0, 0]),
        BodySpec('torso', 34.2, [-0.03, 0.32, 0.0], [1.47, 0.76, 1.43, 0, 0, 0]),
    ]
    name_to_idx = {b.name: i for i, b in enumerate(bodies)}
    joints = [
        JointSpec('ground_pelvis', 'free', -1, name_to_idx['pelvis'], [0.0, 0.95, 0.0]),
        JointSpec('hip_r', 'ball', name_to_idx['pelvis'], name_to_idx['femur_r'], [-0.056, -0.07, 0.083]),
        JointSpec('walker_knee_r', 'revolute', name_to_idx['femur_r'], name_to_idx['tibia_r'], [0.0, -0.40, 0.0], [0.0, 0.0, 1.0]),
        JointSpec('ankle_r', 'revolute', name_to_idx['tibia_r'], name_to_idx['talus_r'], [0.0, -0.415, 0.0], [0.0, 0.0, 1.0]),
        JointSpec('subtalar_r', 'revolute', name_to_idx['talus_r'], name_to_idx['calcn_r'], [-0.045, -0.04, 0.008], [1.0, 0.0, 0.0]),
        JointSpec('mtp_r', 'revolute', name_to_idx['calcn_r'], name_to_idx['toes_r'], [0.17, -0.002, 0.001], [0.0, 0.0, 1.0]),
        JointSpec('hip_l', 'ball', name_to_idx['pelvis'], name_to_idx['femur_l'], [-0.056, -0.07, -0.083]),
        JointSpec('walker_knee_l', 'revolute', name_to_idx['femur_l'], name_to_idx['tibia_l'], [0.0, -0.40, 0.0], [0.0, 0.0, 1.0]),
        JointSpec('ankle_l', 'revolute', name_to_idx['tibia_l'], name_to_idx['talus_l'], [0.0, -0.415, 0.0], [0.0, 0.0, 1.0]),
        JointSpec('subtalar_l', 'revolute', name_to_idx['talus_l'], name_to_idx['calcn_l'], [-0.045, -0.04, -0.008], [1.0, 0.0, 0.0]),
        JointSpec('mtp_l', 'revolute', name_to_idx['calcn_l'], name_to_idx['toes_l'], [0.17, -0.002, -0.001], [0.0, 0.0, 1.0]),
        JointSpec('back', 'ball', name_to_idx['pelvis'], name_to_idx['torso'], [-0.09, 0.08, 0.0]),
    ]
    spec = SkeletonSpec(joints=joints, bodies=bodies)
    assert spec.num_dofs == 23
    assert len(spec.joints) == 12
    return spec


def synthetic_trial(name: str,
                    length: int,
                    *,
                    num_dofs: int = 23,
                    root_history_len: int = 10,
                    timestep: float = 0.01,
                    mass_kg: float = 70.0,
                    gait_hz: float = 1.0,
                    missing_frac: float = 0.0,
                    rng: Optional[np.random.Generator] = None) -> TrialData:
    """Generate one gait-like trial with KINEMATICS + DYNAMICS passes."""
    rng = rng or np.random.default_rng(0)
    nb = len(CONTACT_BODIES)
    layout = pass_channel_layout(num_dofs, nb, root_history_len)
    offs = layout_offsets(layout)
    C = layout_total(layout)
    T = length
    t = np.arange(T, dtype=np.float32)[:, None] * timestep

    def put(mat, field, val):
        o, w = offs[field]
        mat[:, o:o + w] = val

    # Joint kinematics: per-DOF sinusoids with distinct phases/frequencies.
    phase = rng.uniform(0, 2 * np.pi, size=num_dofs).astype(np.float32)
    amp = rng.uniform(0.1, 0.6, size=num_dofs).astype(np.float32)
    w0 = 2 * np.pi * gait_hz
    pos = amp * np.sin(w0 * t + phase)
    vel = amp * w0 * np.cos(w0 * t + phase)
    acc = -amp * w0 ** 2 * np.sin(w0 * t + phase)

    # COM: forward progression + vertical bounce at 2x gait frequency.
    com_acc = np.stack([
        0.3 * np.sin(2 * w0 * t[:, 0]),
        1.5 * np.cos(2 * w0 * t[:, 0]),
        0.1 * np.sin(w0 * t[:, 0]),
    ], axis=1).astype(np.float32)

    # Alternating stance: right foot in contact for the first half-cycle,
    # left for the second, with double support at transitions.
    cyc = (t[:, 0] * gait_hz) % 1.0
    contact_r = ((cyc < 0.55)).astype(np.float32)
    contact_l = ((cyc > 0.45) | (cyc < 0.05)).astype(np.float32)
    contact = np.stack([contact_r, contact_l], axis=1)
    n_contact = np.maximum(contact.sum(axis=1, keepdims=True), 1.0)

    # Total GRF tracks m*(a_com - g); split equally across stance feet.
    total_f = mass_kg * (com_acc - GRAVITY[None, :].astype(np.float32))
    per_foot = total_f[:, None, :] * (contact / n_contact)[:, :, None]  # [T,nb,3]

    # CoP near each calcn, moving fore-aft through stance.
    cop = np.zeros((T, nb, 3), np.float32)
    cop[:, 0] = np.stack([0.08 * cyc, np.zeros(T, np.float32), np.full(T, 0.1, np.float32)], axis=1)
    cop[:, 1] = np.stack([0.08 * ((cyc + 0.5) % 1.0), np.zeros(T, np.float32), np.full(T, -0.1, np.float32)], axis=1)
    cop *= contact[:, :, None]

    grf_torque = 0.05 * np.stack([contact * np.sin(w0 * t),
                                  contact * 0.0,
                                  contact * np.cos(w0 * t)], axis=2).astype(np.float32)
    # Wrench = [torque_about_origin, force] per contact body.
    torque_about_origin = np.cross(cop, per_foot) + grf_torque
    wrench = np.concatenate([torque_about_origin, per_foot], axis=2)  # [T,nb,6]

    def build_pass(noise_scale: float) -> np.ndarray:
        mat = np.zeros((T, C), np.float32)
        nz = lambda shape: rng.normal(0, noise_scale, size=shape).astype(np.float32)
        put(mat, 'pos', pos + nz(pos.shape))
        put(mat, 'vel', vel + nz(vel.shape))
        put(mat, 'acc', acc + nz(acc.shape))
        # Joint torques roughly proportional to acc (inertia-like scaling).
        tau = 0.0 * acc
        tau = acc * rng.uniform(0.5, 2.0, size=num_dofs).astype(np.float32)
        tau[:, :6] = 0.0  # root residual DOFs carry no actuation
        put(mat, 'tau', tau + nz(tau.shape))
        com_pos = np.stack([0.05 * np.sin(2 * w0 * t[:, 0]), 0.95 + 0.02 * np.cos(2 * w0 * t[:, 0]), 0 * t[:, 0]], axis=1)
        put(mat, 'comPos', com_pos)
        put(mat, 'comVel', np.gradient(com_pos, timestep, axis=0))
        put(mat, 'comAcc', com_acc + nz(com_acc.shape))
        put(mat, 'comAccInRootFrame', com_acc + nz(com_acc.shape))
        put(mat, 'residualWrenchInRootFrame', nz((T, 6)) * 0.1)
        # 12 joint centers swinging around plausible body locations.
        jc_base = rng.uniform(-0.5, 0.5, size=(1, 12, 3)).astype(np.float32)
        jc = jc_base + 0.1 * np.sin(w0 * t[:, :, None] + phase[:12][None, :, None])
        put(mat, 'jointCentersInRootFrame', jc.reshape(T, 36))
        put(mat, 'rootLinearVelInRootFrame', np.stack([1.2 + 0.1 * np.sin(w0 * t[:, 0]), 0.05 * np.cos(2 * w0 * t[:, 0]), 0 * t[:, 0]], axis=1))
        put(mat, 'rootAngularVelInRootFrame', 0.1 * np.stack([np.sin(w0 * t[:, 0]), np.cos(w0 * t[:, 0]), np.sin(2 * w0 * t[:, 0])], axis=1))
        put(mat, 'rootLinearAccInRootFrame', com_acc + nz(com_acc.shape))
        put(mat, 'rootAngularAccInRootFrame', 0.2 * np.stack([np.cos(w0 * t[:, 0]), np.sin(w0 * t[:, 0]), np.cos(2 * w0 * t[:, 0])], axis=1))
        hist = 0.01 * np.sin(w0 * t[:, :, None] + np.arange(root_history_len * 3)[None, None, :].astype(np.float32))
        put(mat, 'rootPosHistoryInRootFrame', hist.reshape(T, -1))
        put(mat, 'rootEulerHistoryInRootFrame', (hist * 0.5).reshape(T, -1))
        put(mat, 'rootPosInWorld', np.stack([1.2 * t[:, 0], 0.95 + 0.02 * np.cos(2 * w0 * t[:, 0]), 0 * t[:, 0]], axis=1))
        put(mat, 'rootEulerInWorld', 0.05 * np.stack([np.sin(w0 * t[:, 0]), np.cos(w0 * t[:, 0]), 0 * t[:, 0]], axis=1))
        put(mat, 'groundContactWrenchesInRootFrame', wrench.reshape(T, -1))
        put(mat, 'groundContactCenterOfPressureInRootFrame', cop.reshape(T, -1))
        put(mat, 'groundContactTorqueInRootFrame', grf_torque.reshape(T, -1))
        put(mat, 'groundContactForceInRootFrame', per_foot.reshape(T, -1))
        put(mat, 'groundContactWrenches', wrench.reshape(T, -1))
        put(mat, 'groundContactCenterOfPressure', cop.reshape(T, -1))
        put(mat, 'groundContactTorque', grf_torque.reshape(T, -1))
        put(mat, 'groundContactForce', per_foot.reshape(T, -1))
        put(mat, 'contact', contact)
        return mat

    kin = build_pass(noise_scale=0.01)   # kinematics pass: slightly noisy
    dyn = build_pass(noise_scale=0.0)    # dynamics pass: clean labels

    missing = np.zeros(T, np.int64)
    if missing_frac > 0:
        n_bad = int(T * missing_frac)
        bad = rng.choice(T, size=n_bad, replace=False)
        missing[bad] = int(MissingGRFReason.manualReview)

    return TrialData(
        name=name,
        timestep=timestep,
        passes=[kin, dyn],
        pass_types=[int(ProcessingPassType.KINEMATICS), int(ProcessingPassType.DYNAMICS)],
        missing_grf_reasons=missing.tolist(),
    )


def write_synthetic_legacy_subject(path: str,
                                   *,
                                   num_trials: int = 2,
                                   trial_length: int = 300,
                                   num_dofs: int = 23,
                                   root_history_len: int = 10,
                                   mass_kg: float = 70.0,
                                   missing_frac: float = 0.0,
                                   seed: int = 0) -> None:
    """Write the same synthetic subject in the LEGACY protobuf .b3d format
    (fixture generator for the no-nimble ingestion path, data/b3d_legacy.py)."""
    from inferbiomechanics_tpu_torch.data.b3d_legacy import write_legacy_subject
    rng = np.random.default_rng(seed)
    skel = standard_skeleton() if num_dofs == 23 else None
    trials = [
        synthetic_trial(f'trial_{i}', trial_length, num_dofs=num_dofs,
                        root_history_len=root_history_len, mass_kg=mass_kg,
                        gait_hz=0.8 + 0.2 * i, missing_frac=missing_frac, rng=rng)
        for i in range(num_trials)
    ]
    write_legacy_subject(
        path,
        num_dofs=num_dofs,
        ground_force_bodies=CONTACT_BODIES,
        root_history_len=root_history_len,
        trials=trials,
        skeleton=skel,
        mass_kg=mass_kg,
        height_m=1.75,
        age_years=30,
        biological_sex='male' if seed % 2 == 0 else 'female',
    )


def write_synthetic_subject(path: str,
                            *,
                            num_trials: int = 2,
                            trial_length: int = 300,
                            num_dofs: int = 23,
                            root_history_len: int = 10,
                            mass_kg: float = 70.0,
                            missing_frac: float = 0.0,
                            seed: int = 0) -> None:
    """Write a complete synthetic subject file to ``path``."""
    rng = np.random.default_rng(seed)
    skel = standard_skeleton() if num_dofs == 23 else None
    trials = [
        synthetic_trial(f'trial_{i}', trial_length, num_dofs=num_dofs,
                        root_history_len=root_history_len, mass_kg=mass_kg,
                        gait_hz=0.8 + 0.2 * i, missing_frac=missing_frac, rng=rng)
        for i in range(num_trials)
    ]
    write_subject(
        path,
        num_dofs=num_dofs,
        ground_force_bodies=CONTACT_BODIES,
        root_history_len=root_history_len,
        trials=trials,
        skeleton=skel,
        mass_kg=mass_kg,
        height_m=1.75,
        age_years=30,
        biological_sex='male' if seed % 2 == 0 else 'female',
    )
