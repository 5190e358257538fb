"""Trial-name motion classes.

The port's copy of ``MOTION_CLASSES`` and ``classify_motion`` from
``inferbiomechanics_tpu/cli/make_plots_cmd.py`` (the generic keyword
fallback of make-plots), held to the original by
``tests/test_torch_data.py``. ``analyze --group-by activity`` groups its
rows by these classes.
"""

from __future__ import annotations

MOTION_CLASSES = {
    'walking': ('walk', 'gait', 'tread'),
    'running': ('run', 'jog', 'sprint'),
    'stairs': ('stair', 'step'),
    'jump': ('jump', 'hop', 'land'),
    'squat': ('squat', 'sts', 'sit'),
    'other': (),
}


def classify_motion(trial_name: str) -> str:
    name = trial_name.lower()
    for cls, keywords in MOTION_CLASSES.items():
        if any(k in name for k in keywords):
            return cls
    return 'other'
