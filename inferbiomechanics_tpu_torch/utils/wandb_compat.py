"""Weights & Biases logging with an offline fallback.

Capability parity: the reference logs every batch to wandb (project
``addbiomechanics-baseline``, run groups for DDP — train.py:117-132).
This environment has zero egress, so the logger tries real wandb in
offline mode and otherwise falls back to JSONL under the log dir; the
metric-key schema (loss/evaluator.py) is identical either way.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class MetricLogger:
    """wandb-shaped logger: ``init`` → ``log(dict)`` → ``finish``.

    ``backend`` reports where metrics actually went: 'wandb', 'jsonl',
    or 'disabled'. A fall-back to JSONL is never silent — the reason is
    logged as a WARNING and recorded in the run config ('logger' key),
    so a misconfigured real-wandb run is distinguishable from an
    intended offline one.
    """

    def __init__(self, project: str = 'addbiomechanics-baseline',
                 config: Optional[dict] = None,
                 group: Optional[str] = None,
                 enabled: bool = True,
                 log_dir: str = 'outputs/logs'):
        self.enabled = enabled
        self._wandb = None
        self._file = None
        self.backend = 'disabled'
        if not enabled:
            return
        try:
            import wandb  # type: ignore
            mode = 'online' if os.environ.get('WANDB_API_KEY') else 'offline'
            self._wandb = wandb
            wandb.init(project=project,
                       config=dict(config or {}, logger='wandb'),
                       group=group, mode=mode)
            self.backend = 'wandb'
        except Exception as e:
            self._wandb = None
            logger.warning(
                'wandb unavailable (%s: %s) — metrics fall back to JSONL '
                'under %s', type(e).__name__, e, log_dir)
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f'metrics_{int(time.time())}.jsonl')
            self._file = open(path, 'a')
            self.backend = 'jsonl'
            self._file.write(json.dumps(
                {'_config': _jsonable(dict(config or {}, logger='jsonl'))})
                + '\n')

    def log(self, metrics: Dict[str, float]) -> None:
        if not self.enabled:
            return
        if self._wandb is not None:
            self._wandb.log(metrics)
        elif self._file is not None:
            self._file.write(json.dumps(_jsonable(metrics)) + '\n')
            self._file.flush()

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._file is not None:
            self._file.close()


def _jsonable(d: dict) -> dict:
    out = {}
    for k, v in d.items():
        try:
            json.dumps(v)
            out[k] = v
        except TypeError:
            out[k] = str(v)
    return out
