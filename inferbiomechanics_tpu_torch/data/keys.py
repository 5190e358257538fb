"""Canonical feature / label key constants and channel-width tables.

Parity surface: reference ``src/data/AddBiomechanicsDataset.py:9-42``
(`InputDataKeys`, `OutputDataKeys`). Every model, loss, and data-layer
component communicates through dicts keyed by these constants, exactly
like the reference, so checkpoints/eval workflows carry over.
"""

from __future__ import annotations

from typing import Dict, List


class InputDataKeys:
    # Per-DOF joint kinematics (generalized coordinates).
    POS = 'pos'
    VEL = 'vel'
    ACC = 'acc'

    # Joint-center positions expressed in the root (pelvis) frame.
    JOINT_CENTERS_IN_ROOT_FRAME = 'jointCentersInRootFrame'

    # Root spatial velocity / acceleration, expressed in the root frame.
    ROOT_LINEAR_VEL_IN_ROOT_FRAME = 'rootLinearVelInRootFrame'
    ROOT_ANGULAR_VEL_IN_ROOT_FRAME = 'rootAngularVelInRootFrame'
    ROOT_LINEAR_ACC_IN_ROOT_FRAME = 'rootLinearAccInRootFrame'
    ROOT_ANGULAR_ACC_IN_ROOT_FRAME = 'rootAngularAccInRootFrame'

    # Recent history of root position / orientation, in the root frame.
    ROOT_POS_HISTORY_IN_ROOT_FRAME = 'rootPosHistoryInRootFrame'
    ROOT_EULER_HISTORY_IN_ROOT_FRAME = 'rootEulerHistoryInRootFrame'


class OutputDataKeys:
    TAU = 'tau'

    # Enough to run inverse dynamics.
    GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME = 'groundContactWrenchesInRootFrame'
    RESIDUAL_WRENCH_IN_ROOT_FRAME = 'residualWrenchInRootFrame'

    # Additional predictable quantities.
    CONTACT = 'contact'
    COM_ACC_IN_ROOT_FRAME = 'comAccInRootFrame'
    GROUND_CONTACT_COPS_IN_ROOT_FRAME = 'groundContactCenterOfPressureInRootFrame'
    GROUND_CONTACT_TORQUES_IN_ROOT_FRAME = 'groundContactTorqueInRootFrame'
    GROUND_CONTACT_FORCES_IN_ROOT_FRAME = 'groundContactForceInRootFrame'


# All input keys in the canonical concatenation order used by every model
# (reference FeedForwardRegressionBaseline.py:97-108, Groundlink.py:122-133).
INPUT_CONCAT_ORDER: List[str] = [
    InputDataKeys.POS,
    InputDataKeys.VEL,
    InputDataKeys.ACC,
    InputDataKeys.ROOT_LINEAR_VEL_IN_ROOT_FRAME,
    InputDataKeys.ROOT_ANGULAR_VEL_IN_ROOT_FRAME,
    InputDataKeys.ROOT_LINEAR_ACC_IN_ROOT_FRAME,
    InputDataKeys.ROOT_ANGULAR_ACC_IN_ROOT_FRAME,
    InputDataKeys.JOINT_CENTERS_IN_ROOT_FRAME,
    InputDataKeys.ROOT_POS_HISTORY_IN_ROOT_FRAME,
    InputDataKeys.ROOT_EULER_HISTORY_IN_ROOT_FRAME,
]

NUM_JOINT_CENTERS = 12  # reference hardcodes 12 joints x 3 coords


def input_channel_widths(num_dofs: int, root_history_len: int) -> Dict[str, int]:
    """Channel count (last-dim width) for each input stream."""
    return {
        InputDataKeys.POS: num_dofs,
        InputDataKeys.VEL: num_dofs,
        InputDataKeys.ACC: num_dofs,
        InputDataKeys.JOINT_CENTERS_IN_ROOT_FRAME: NUM_JOINT_CENTERS * 3,
        InputDataKeys.ROOT_LINEAR_VEL_IN_ROOT_FRAME: 3,
        InputDataKeys.ROOT_ANGULAR_VEL_IN_ROOT_FRAME: 3,
        InputDataKeys.ROOT_LINEAR_ACC_IN_ROOT_FRAME: 3,
        InputDataKeys.ROOT_ANGULAR_ACC_IN_ROOT_FRAME: 3,
        InputDataKeys.ROOT_POS_HISTORY_IN_ROOT_FRAME: root_history_len * 3,
        InputDataKeys.ROOT_EULER_HISTORY_IN_ROOT_FRAME: root_history_len * 3,
    }


def label_channel_widths(num_dofs: int, num_contact_bodies: int) -> Dict[str, int]:
    """Channel count (last-dim width) for each label stream."""
    return {
        OutputDataKeys.TAU: num_dofs,
        OutputDataKeys.GROUND_CONTACT_WRENCHES_IN_ROOT_FRAME: 6 * num_contact_bodies,
        OutputDataKeys.RESIDUAL_WRENCH_IN_ROOT_FRAME: 6,
        OutputDataKeys.CONTACT: num_contact_bodies,
        OutputDataKeys.COM_ACC_IN_ROOT_FRAME: 3,
        OutputDataKeys.GROUND_CONTACT_COPS_IN_ROOT_FRAME: 3 * num_contact_bodies,
        OutputDataKeys.GROUND_CONTACT_TORQUES_IN_ROOT_FRAME: 3 * num_contact_bodies,
        OutputDataKeys.GROUND_CONTACT_FORCES_IN_ROOT_FRAME: 3 * num_contact_bodies,
    }


def total_input_width(num_dofs: int, root_history_len: int) -> int:
    return sum(input_channel_widths(num_dofs, root_history_len).values())
