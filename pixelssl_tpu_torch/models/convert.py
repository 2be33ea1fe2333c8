"""Weights carried into the port: from the JAX package's flax variables
(``from_jax``, the inverse of ``pixelssl_tpu/models/convert.py``), and from
torch checkpoints of the reference's models (``--pretrained-path``; the
torch side of the same file).

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
  names); ``unet_lite``'s automatic names ``_ConvBNRelu_I`` ->
  ``blocks.I``, with ``Conv_0`` -> ``conv`` and ``SyncBatchNorm_0`` ->
  ``bn`` inside.

The torch side copies a checkpoint's tensors into a module's
``state_dict`` where the key and the shape match, and skips the rest, as
the JAX package's converters do (their convert.py:28-316): a bare torch
ResNet (``conv1``/``bn1``/``layerX.Y``) into the backbone, and the
reference's full DeepLab-v2 and PSPNet checkpoints (keys under
``backbone.``, optionally under ``model.``). The port's module names are
the reference's, so the backbone and DeepLab-v2's classifier map one to
one; PSPNet's PSP module and decoder are renamed. BN's
``num_batches_tracked`` is not copied: the JAX package has none.
"""

import re

import numpy as np
import torch

from ..utils import logger

_RENAMES = (
    (re.compile(r'^backbone_net$'), 'backbone'),
    (re.compile(r'^(layer\d)_(\d+)$'), r'\1.\2'),
    (re.compile(r'^downsample_conv$'), 'downsample.0'),
    (re.compile(r'^downsample_bn$'), 'downsample.1'),
    (re.compile(r'^(conv2d_list)_(\d+)$'), r'\1.\2'),
    (re.compile(r'^stages_(\d+)_(conv|bn)$'), r'stages.\1.\2'),
    (re.compile(r'^(shuffle)_(\d+)$'), r'\1.\2'),
    (re.compile(r'^_ConvBNRelu_(\d+)$'), r'blocks.\1'),
    (re.compile(r'^Conv_0$'), 'conv'),
    (re.compile(r'^SyncBatchNorm_0$'), 'bn'),
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
    """flax variables (numpy leaves) -> torch ``state_dict``, float32 (a bf16
    leaf, as ``--bf16-ema`` stores the teacher, exactly so)."""
    state = {}
    params = variables['params']
    # CCT's wrapped model: the batch statistics are the task model's
    stats_prefix = ('main',) if set(params) == {'main', 'ads'} else ()
    for path, value in _flatten(params):
        value = np.asarray(value, dtype=np.float32)
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


# ---------------------------------------------------------------------------
# torch checkpoints (--pretrained-path)
# ---------------------------------------------------------------------------

_BN_LEAF = r'(weight|bias|running_mean|running_var)'
# the keys of a torch ResNet that the JAX package's _torch_key_to_flax maps
_RESNET_KEY = re.compile(
    r'^(conv1\.weight|bn1\.{0}|layer\d\.\d+\.(conv\d+\.weight|bn\d+\.{0}|'
    r'downsample\.0\.weight|downsample\.1\.{0}))$'.format(_BN_LEAF))


def load_torch_state_dict(path):
    """A ``.pth``/``.ckpt`` file as ``{name: tensor}`` on the CPU: a
    ``'state_dict'`` entry unwrapped, the ``module.`` prefix stripped,
    non-tensors dropped. Read with ``weights_only``: tensors and plain
    containers only."""
    state = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(state, dict) and 'state_dict' in state:
        state = state['state_dict']
    out = {}
    for key, value in state.items():
        key = key[len('module.'):] if key.startswith('module.') else key
        if torch.is_tensor(value):
            out[key] = value.detach()
    return out


def _strip_prefix(state, prefix):
    return {k[len(prefix):]: v for k, v in state.items()
            if k.startswith(prefix)}


def _copy(target, key, value, counts):
    """``value`` into ``target[key]`` (a module's ``state_dict``, whose
    tensors share the parameters' storage) when the key is there with the
    same shape; ``counts`` is [copied, skipped]."""
    dst = target.get(key)
    if dst is not None and tuple(dst.shape) == tuple(value.shape):
        with torch.no_grad():
            dst.copy_(value.to(dst.dtype))
        counts[0] += 1
    else:
        counts[1] += 1


def copy_resnet_backbone(target, torch_state, prefix, counts=None):
    """A torch ResNet state dict into the backbone of ``target`` under
    ``prefix``; returns [copied, skipped]."""
    counts = [0, 0] if counts is None else counts
    for key, value in torch_state.items():
        if _RESNET_KEY.match(key):
            _copy(target, prefix + key, value, counts)
        else:
            counts[1] += 1
    return counts


def load_pretrained_backbone(module, torch_state, prefix='net.backbone.'):
    """A bare torch ResNet state dict (``load_torch_state_dict``) into
    ``module``'s backbone (the sseg task models keep it at
    ``net.backbone``); warns when nothing matched. Returns the tensors
    copied."""
    copied, skipped = copy_resnet_backbone(module.state_dict(), torch_state,
                                           prefix)
    logger.log_info('load_pretrained_backbone: copied {0} tensors, skipped '
                    '{1}'.format(copied, skipped))
    if copied == 0:
        logger.log_warn('load_pretrained_backbone: no tensors matched — '
                        'wrong checkpoint or backbone path?')
    return copied


def _full_model_state(torch_state):
    if any(k.startswith('model.') for k in torch_state):
        torch_state = _strip_prefix(torch_state, 'model.')
    return torch_state


def convert_deeplab_v2(torch_state, target, prefix='net.'):
    """The reference's DeepLab-v2 state dict (``backbone.*`` and
    ``classifier.conv2d_list.{i}.*``) into ``target`` under ``prefix``;
    returns [copied, skipped]."""
    torch_state = _full_model_state(torch_state)
    counts = copy_resnet_backbone(
        target, _strip_prefix(torch_state, 'backbone.'), prefix + 'backbone.')
    for key, value in _strip_prefix(torch_state, 'classifier.').items():
        if re.match(r'conv2d_list\.\d+\.(weight|bias)$', key):
            _copy(target, prefix + 'classifier.' + key, value, counts)
        else:
            counts[1] += 1
    logger.log_info('convert_deeplab_v2: copied {0}, skipped {1}'.format(
        *counts))
    return counts


# the reference's PSPNet module and decoder keys -> the port's
_PSPNET_KEYS = (
    (re.compile(r'^psp\.stages\.(\d+)\.1\.weight$'), r'psp.stages.\1.conv.weight'),
    (re.compile(r'^psp\.stages\.(\d+)\.2\.{0}$'.format(_BN_LEAF)),
     r'psp.stages.\1.bn.\2'),
    (re.compile(r'^psp\.bottleneck\.0\.weight$'), 'psp.bottleneck_conv.weight'),
    (re.compile(r'^psp\.bottleneck\.1\.{0}$'.format(_BN_LEAF)),
     r'psp.bottleneck_bn.\1'),
    (re.compile(r'^decoder\.0\.weight$'), 'decoder.conv1x1.weight'),
)
_PSP_SHUFFLE = re.compile(r'^decoder\.([123])\.conv\.(weight|bias)$')


def convert_pspnet(torch_state, target, prefix='net.'):
    """The reference's PSPNet state dict (``backbone.*``,
    ``psp.stages.{i}.{1,2}.*``, ``psp.bottleneck.{0,1}.*``,
    ``decoder.{0|k.conv}.*``) into ``target`` under ``prefix``; returns
    [copied, skipped]."""
    torch_state = _full_model_state(torch_state)
    counts = copy_resnet_backbone(
        target, _strip_prefix(torch_state, 'backbone.'), prefix + 'backbone.')
    for key, value in torch_state.items():
        if key.startswith('backbone.'):
            continue
        shuffle = _PSP_SHUFFLE.match(key)
        if shuffle:
            ours = 'decoder.shuffle.{0}.conv.{1}'.format(
                int(shuffle.group(1)) - 1, shuffle.group(2))
        else:
            ours = next((pattern.sub(repl, key)
                         for pattern, repl in _PSPNET_KEYS
                         if pattern.match(key)), None)
        if ours is None:
            counts[1] += 1
        else:
            _copy(target, prefix + ours, value, counts)
    logger.log_info('convert_pspnet: copied {0}, skipped {1}'.format(*counts))
    return counts
