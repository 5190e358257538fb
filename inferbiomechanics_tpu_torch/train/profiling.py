"""``--profile``: a ``torch.profiler`` trace of the first epoch of training.

PyTorch counterpart of the JAX loops' ``jax.profiler.start_trace`` /
``stop_trace`` (``inferbiomechanics_tpu/train/loop.py``,
``diffusion_loop.py``), for both of the port's loops: the trace opens before
the first epoch's dev evaluation and closes after that epoch's last step,
once the device has finished it; it also closes when no epoch ran, after a
SIGTERM and on an exception (:meth:`FirstEpochTrace.close` in the loops'
``finally``). It records the CPU's activity and, on a CUDA device, the
card's, the kernels of CUDA-graph replays one by one, and is written as a
Chrome trace into ``--profile-dir``, one file per rank:
``rank{r}.{ms since 1970}.pt.trace.json``.

A profiler trace was seen to lose the first kernels of its window
(``ops/tune.py::traced_kernels``), so on a CUDA device the window opens with
``PRE_ROLL`` launches of a one-element kernel and the device idles
``TRACE_MARGIN_S`` before the epoch's work and after it: the trace holds
every launch of the epoch, and those of its own at its start.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Optional

import torch

from inferbiomechanics_tpu_torch.ops.tune import PRE_ROLL, TRACE_MARGIN_S
from inferbiomechanics_tpu_torch.parallel import dist

logger = logging.getLogger(__name__)


class FirstEpochTrace:
    """Opened at construction when ``enabled`` (``--profile``); :meth:`close`
    (idempotent) waits for ``device``, closes the window and writes the
    trace to :attr:`path`."""

    def __init__(self, enabled: bool, profile_dir: str, device):
        self.path: Optional[str] = None
        self.device = torch.device(device)
        self._prof = None
        if not enabled:
            return
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(profile_dir, exist_ok=True)
        self.path = os.path.join(os.path.abspath(profile_dir),
                                 f'rank{dist.rank()}.{int(time.time() * 1e3)}.pt.trace.json')
        on_card = self.device.type == 'cuda'
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        self._prof = profile(activities=activities)
        self._prof.start()
        if on_card:
            one = torch.zeros(1, device=self.device)
            for _ in range(PRE_ROLL):
                one.add_(1.0)
            torch.cuda.synchronize(self.device)
            time.sleep(TRACE_MARGIN_S)
        logger.info('torch profiler trace -> %s', profile_dir)

    def close(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        try:
            if self.device.type == 'cuda':
                torch.cuda.synchronize(self.device)
                time.sleep(TRACE_MARGIN_S)
        finally:
            prof.stop()
            prof.export_chrome_trace(self.path)
            logger.info('profiler trace written to %s', self.path)
