"""Profiling hooks (counterpart of ``pixelssl_tpu/utils/profiler.py``).

The reference has no profiler, only wall-clock ``batch_time`` meters. The
port traces training windows with ``torch.profiler``: set ``--profile-dir``
(or call ``trace`` directly) to write a Chrome trace (``chrome://tracing``,
Perfetto) of the host's operators and, on the card, the CUDA kernels,
copies and graph launches with their device times. Each profiled train
step (or dispatch) is a ``ProfilerStep#<n>`` range of the trace.
"""

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity

from . import logger


def _activities(device):
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == 'cuda':
        activities.append(ProfilerActivity.CUDA)
    return activities


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def _start(log_dir, device):
    os.makedirs(log_dir, exist_ok=True)
    # a schedule that records every step: ``step()`` then marks the steps
    prof = torch.profiler.profile(
        activities=_activities(device),
        schedule=lambda step: torch.profiler.ProfilerAction.RECORD)
    prof.start()
    return prof


def _stop(prof, log_dir):
    prof.stop()
    path = os.path.join(log_dir, 'trace_{0}_{1}.json'.format(
        os.getpid(), int(time.time() * 1000)))
    prof.export_chrome_trace(path)
    logger.log_info('profiler: trace saved to {0}'.format(path))
    return path


@contextlib.contextmanager
def trace(log_dir, enabled=True, device='cpu'):
    """Trace the enclosed block into ``log_dir`` (the device synchronised
    at both edges); yields the profiler, or None when disabled."""
    if not enabled or not log_dir:
        yield None
        return
    _sync(device)
    prof = _start(log_dir, device)
    logger.log_info('profiler: tracing to {0}'.format(log_dir))
    try:
        yield prof
    finally:
        _sync(device)
        _stop(prof, log_dir)


class ProfileWindow(object):
    """Traces a window of training steps when ``--profile-dir`` is set.

    Skips the first step/dispatch (cuDNN's autotuning, a graph's capture),
    then captures ``--profile-steps`` steps of epoch 0 and stops.
    ``tick(idx)`` is called with the step (or dispatch) index before each
    one; ``close`` finishes the trace at the epoch's end. The device is
    synchronised at the window's edges, so that the window holds its
    steps' kernels and no others. ``path`` is the trace written."""

    def __init__(self, args, epoch, device='cpu'):
        self.dir = getattr(args, 'profile_dir', '') or ''
        self.n = max(1, getattr(args, 'profile_steps', 10) or 10)
        self.enabled = bool(self.dir) and epoch == 0
        self.device = device
        self.prof = None
        self.path = None

    def tick(self, idx):
        if not self.enabled:
            return
        if self.prof is None and idx == 1:
            _sync(self.device)
            self.prof = _start(self.dir, self.device)
            logger.log_info('profiler: tracing steps [1, {0}] to {1}'.format(
                self.n, self.dir))
        elif self.prof is not None:
            if idx == 1 + self.n:
                self._stop()
            else:
                self.prof.step()

    def close(self):
        if self.prof is not None:
            self._stop()

    def _stop(self):
        _sync(self.device)
        self.path = _stop(self.prof, self.dir)
        self.prof = None
        self.enabled = False


class StepTimer(object):
    """Measures step wall time apart from host input time.

    Call ``host_done()`` when the batch is ready, ``step_done(n)`` after
    the step (or a dispatch of ``n`` steps) was queued, or after waiting
    for its result. Keeps running sums for logging; ``reset`` starts anew.
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self._t = time.perf_counter()
        self.data_time = 0.0
        self.step_time = 0.0
        self.count = 0

    def host_done(self):
        now = time.perf_counter()
        self.data_time += now - self._t
        self._t = now

    def step_done(self, n=1):
        now = time.perf_counter()
        self.step_time += now - self._t
        self._t = now
        self.count += n

    @property
    def mean_step(self):
        return self.step_time / max(1, self.count)

    @property
    def mean_data(self):
        return self.data_time / max(1, self.count)
