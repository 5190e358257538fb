from inferbiomechanics_tpu_torch.data.keys import (
    InputDataKeys,
    OutputDataKeys,
    INPUT_CONCAT_ORDER,
    NUM_JOINT_CENTERS,
    input_channel_widths,
    label_channel_widths,
    total_input_width,
)

__all__ = [
    'InputDataKeys',
    'OutputDataKeys',
    'INPUT_CONCAT_ORDER',
    'NUM_JOINT_CENTERS',
    'input_channel_widths',
    'label_channel_widths',
    'total_input_width',
]
