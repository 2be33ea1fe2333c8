"""Weights carried across from the JAX package (the inverse of
``pixelssl_tpu/models/convert.py``).

``from_jax(variables)`` maps the JAX package's flax variables, given as
nested dicts of numpy arrays (``{'params': ..., 'batch_stats': ...}``), onto
the ``state_dict`` of this package's module of the same structure:
DeepLab-v2 and PSPNet (bare, or under the sseg task model's ``net``), the
flaw detector, the FC discriminator (``conv1``..``conv4``, ``classifier``),
S4L's wrapped model (the task model under ``task``, the rotation head
under ``rc``), CCT's auxiliary decoders and its wrapped model (JAX
``{'params': {'main': <task model>, 'ads': {'ad_<i>': <decoder>}},
'batch_stats': <the task model's>}``: the statistics go under ``main``).

* conv kernels HWIO -> OIHW, dense kernels [in, out] -> [out, in],
  ``kernel`` -> ``weight``;
* BN ``scale``/``bias`` -> ``weight``/``bias``, ``mean``/``var`` ->
  ``running_mean``/``running_var``, plus a zero ``num_batches_tracked``;
* module names: ``backbone_net`` -> ``backbone``, ``layerX_Y`` ->
  ``layerX.Y``, ``downsample_conv``/``downsample_bn`` ->
  ``downsample.0``/``downsample.1``, ``conv2d_list_I`` -> ``conv2d_list.I``;
  PSPNet's ``stages_I_conv``/``stages_I_bn`` -> ``stages.I.conv``/
  ``stages.I.bn`` and ``shuffle_I`` -> ``shuffle.I`` (``bottleneck_conv``,
  ``bottleneck_bn``, ``conv1x1`` and a shuffle block's ``conv`` keep their
  names).
"""

import re

import numpy as np
import torch

_RENAMES = (
    (re.compile(r'^backbone_net$'), 'backbone'),
    (re.compile(r'^(layer\d)_(\d+)$'), r'\1.\2'),
    (re.compile(r'^downsample_conv$'), 'downsample.0'),
    (re.compile(r'^downsample_bn$'), 'downsample.1'),
    (re.compile(r'^(conv2d_list)_(\d+)$'), r'\1.\2'),
    (re.compile(r'^stages_(\d+)_(conv|bn)$'), r'stages.\1.\2'),
    (re.compile(r'^(shuffle)_(\d+)$'), r'\1.\2'),
)

_PARAM_LEAVES = {'kernel': 'weight', 'scale': 'weight', 'bias': 'bias'}
_STAT_LEAVES = {'mean': 'running_mean', 'var': 'running_var'}


def _module_name(name):
    for pattern, repl in _RENAMES:
        if pattern.match(name):
            return pattern.sub(repl, name)
    return name


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, 'items'):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _torch_key(path, leaf_map):
    module = '.'.join(_module_name(p) for p in path[:-1])
    leaf = leaf_map[path[-1]]
    return module + '.' + leaf if module else leaf


def from_jax(variables):
    """flax variables (numpy leaves) -> torch ``state_dict``."""
    state = {}
    params = variables['params']
    # CCT's wrapped model: the batch statistics are the task model's
    stats_prefix = ('main',) if set(params) == {'main', 'ads'} else ()
    for path, value in _flatten(params):
        value = np.asarray(value)
        if path[-1] == 'kernel' and value.ndim == 4:
            value = value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif path[-1] == 'kernel' and value.ndim == 2:
            value = value.T  # Dense [in, out] -> Linear [out, in]
        state[_torch_key(path, _PARAM_LEAVES)] = torch.tensor(
            value, dtype=torch.float32)
    for path, value in _flatten(variables.get('batch_stats', {}),
                                stats_prefix):
        key = _torch_key(path, _STAT_LEAVES)
        state[key] = torch.tensor(np.asarray(value), dtype=torch.float32)
        if path[-1] == 'mean':
            state[key[:-len('running_mean')] + 'num_batches_tracked'] = \
                torch.zeros((), dtype=torch.long)
    return state
