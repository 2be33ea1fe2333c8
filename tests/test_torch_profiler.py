"""``--profile-dir`` in the port (``utils/profiler.py``, the counterpart of
``pixelssl_tpu/utils/profiler.py``), on the CPU: a SupOnly run of two
epochs of 4 iterations through ``run_script`` writes one Chrome trace
whose ``ProfilerStep#`` ranges are the window's steps, [1, 1 +
``--profile-steps``] of epoch 0, or its dispatches with
``--steps-per-dispatch``; no trace when the flag is unset, and none for a
window that opens past epoch 0.
"""

import collections
import glob
import json
import os
import types

import pytest

import pixelssl_tpu_torch
from pixelssl_tpu_torch.tasks import sseg
from pixelssl_tpu_torch.utils import profiler

from test_torch_mt import one_torch_thread  # noqa: F401


def _run(tmp_path, **overrides):
    config = collections.OrderedDict([
        ('exp_id', 'prof'), ('out_path', str(tmp_path / 'out')),
        ('ssl_algorithm', 'ssl_null'),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', 8), ('batch_size', 2),
        ('unlabeled_batch_size', 0), ('backbone', 'resnet10'),
        ('models', {'model': 'deeplabv2'}), ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('im_size', 32), ('num_classes', 3), ('epochs', 2),
        ('log_freq', 100), ('val_freq', 100), ('checkpoint_freq', 100),
        ('bf16', False), ('lr', 1e-5), ('momentum', 0.9),
        ('num_workers', 0), ('seed', 1),
    ])
    config.update(overrides)
    return pixelssl_tpu_torch.run_script(
        config, sseg, sseg.SemanticSegmentationProxy, device='cpu',
        cli_override=False)


def _profiled_steps(path):
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return sorted({e['name'] for e in events
                   if e.get('name', '').startswith('ProfilerStep#')})


@pytest.mark.parametrize('steps_per_dispatch,profile_steps,expected', [
    (1, 2, 2),   # steps 1 and 2 of epoch 0
    (1, 10, 3),  # steps 1-3: the window closes with the epoch
    (2, 1, 1),   # dispatch 1 of the two of epoch 0
])
def test_profile_dir_traces_the_window(tmp_path, steps_per_dispatch,
                                       profile_steps, expected):
    prof_dir = tmp_path / 'prof'
    _run(tmp_path, profile_dir=str(prof_dir), profile_steps=profile_steps,
         steps_per_dispatch=steps_per_dispatch)
    traces = glob.glob(str(prof_dir / '*.json'))
    assert len(traces) == 1
    steps = _profiled_steps(traces[0])
    assert len(steps) == expected, steps
    # the window's own operators, not only its step markers
    with open(traces[0]) as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert any(n and n.startswith('aten::convolution') for n in names)


def test_no_trace_without_profile_dir(tmp_path):
    _run(tmp_path)
    assert not glob.glob(str(tmp_path / '**' / '*.json'), recursive=True)


def test_no_trace_past_epoch_0(tmp_path):
    """The window opens at epoch 0 only: a window of a later epoch does
    nothing, and ``trace`` does nothing without a directory."""
    prof_dir = str(tmp_path / 'prof')
    window = profiler.ProfileWindow(types.SimpleNamespace(
        profile_dir=prof_dir, profile_steps=2), epoch=1)
    for idx in range(5):
        window.tick(idx)
    window.close()
    with profiler.trace('') as prof:
        assert prof is None
    assert window.path is None and not os.path.exists(prof_dir)


def test_step_timer_splits_input_from_step_time(monkeypatch):
    """``StepTimer``, the epoch loop's clock: input time up to
    ``host_done``, step time up to ``step_done(n)``, means over the n steps
    of a dispatch; ``reset`` starts anew."""
    now = [10.0]
    monkeypatch.setattr(profiler.time, 'perf_counter', lambda: now[0])
    timer = profiler.StepTimer()
    now[0] = 11.0
    timer.host_done()
    now[0] = 14.0
    timer.step_done(2)
    assert (timer.count, timer.mean_data, timer.mean_step) == (2, 0.5, 1.5)
    now[0] = 15.0
    timer.reset()
    assert (timer.count, timer.data_time, timer.step_time) == (0, 0.0, 0.0)
    now[0] = 16.0
    timer.host_done()
    assert timer.mean_data == 1.0
