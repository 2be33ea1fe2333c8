"""Console/file logging plus running-average meters.

Re-design of the reference logging layer
(reference: pixelssl/utils/logger.py:14-131). Differences from the
reference: ``log_err`` raises ``SystemExit`` via an exception instead of
calling ``exit()`` bare, so library users / tests can catch it; meters
accept numpy arrays (used to accumulate confusion matrices device-free).
"""

import logging
import sys

import numpy as np

_LOGGER_NAME = 'pixelssl_tpu_torch'
_logger = logging.getLogger(_LOGGER_NAME)
_logger.setLevel(logging.INFO)
_logger.propagate = False

_console_handler = None
_file_handler = None


class FatalError(SystemExit):
    """Raised by log_err — fatal, mirrors the reference's exit() policy."""


def _ensure_console():
    global _console_handler
    if _console_handler is None:
        _console_handler = logging.StreamHandler(sys.stdout)
        _console_handler.setFormatter(logging.Formatter('%(message)s'))
        _logger.addHandler(_console_handler)


def log_mode(debug=False):
    _ensure_console()
    _logger.setLevel(logging.DEBUG if debug else logging.INFO)


def log_file(path):
    """Attach (or switch) the per-run log file (reference logger.py:30-41)."""
    global _file_handler
    _ensure_console()
    if _file_handler is not None:
        _logger.removeHandler(_file_handler)
        _file_handler.close()
    _file_handler = logging.FileHandler(path)
    _file_handler.setFormatter(
        logging.Formatter('%(asctime)s %(message)s', datefmt='%Y-%m-%d %H:%M:%S'))
    _logger.addHandler(_file_handler)


def log_info(*msgs):
    _ensure_console()
    _logger.info(' '.join(str(m) for m in msgs))


def log_debug(*msgs):
    _ensure_console()
    _logger.debug(' '.join(str(m) for m in msgs))


def log_warn(*msgs):
    _ensure_console()
    _logger.warning('[WARN] ' + ' '.join(str(m) for m in msgs))


def log_err(*msgs):
    """Log an error banner and abort (reference logger.py:58-67)."""
    _ensure_console()
    text = ' '.join(str(m) for m in msgs)
    _logger.error('=' * 72)
    _logger.error('[ERROR] ' + text)
    _logger.error('=' * 72)
    raise FatalError(text)


class AvgMeter(object):
    """Running average meter (reference: utils/logger.py:70-91).

    Values may be python scalars or numpy arrays (summed elementwise) —
    array support is what lets the sseg confusion matrix ride the same
    meter machinery as scalar losses (reference task/sseg/func.py:48,64).
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        val = np.asarray(val) if not np.isscalar(val) else val
        self.val = val
        self.sum = self.sum + val * n
        self.count += n
        self.avg = self.sum / self.count

    def __format__(self, fmt):
        return '{self.val:{fmt}} ({self.avg:{fmt}})'.format(self=self, fmt=fmt)


class AvgMeterSet(object):
    """Named collection of AvgMeters (reference: utils/logger.py:94-131)."""

    def __init__(self):
        self.meters = {}

    def __getitem__(self, key):
        return self.meters[key]

    def __contains__(self, key):
        return key in self.meters

    def has_key(self, key):
        """Reference-API alias (reference logger.py usage in
        task/sseg/func.py:55-63)."""
        return key in self.meters

    def update(self, name, value, n=1):
        if name not in self.meters:
            self.meters[name] = AvgMeter()
        self.meters[name].update(value, n)

    def update_dict(self, values, n=1):
        for name, value in values.items():
            self.update(name, value, n)

    def reset(self, *names):
        if names:
            for name in names:
                if name in self.meters:
                    self.meters[name].reset()
        else:
            for meter in self.meters.values():
                meter.reset()

    def values(self, postfix=''):
        return {name + postfix: meter.val for name, meter in self.meters.items()}

    def averages(self, postfix='/avg'):
        return {name + postfix: meter.avg for name, meter in self.meters.items()}

    def sums(self, postfix='/sum'):
        return {name + postfix: meter.sum for name, meter in self.meters.items()}

    def counts(self, postfix='/count'):
        return {name + postfix: meter.count for name, meter in self.meters.items()}

    def keys(self):
        return self.meters.keys()

    def items(self):
        return self.meters.items()
