"""Programmatic experiment harness (counterpart of
``pixelssl_tpu/harness.py``): build an algorithm and synthetic batches
without the proxy, the CLI or data on disk.

    args = harness.default_args('ssl_mt', backbone='resnet101', ...)
    algo = harness.build_algorithm(args)            # on the card
    metrics = algo.train_step(harness.synthetic_batch(args))
    scores = algo.validate(harness.synthetic_val_batches(args, 2), epoch=0)
    algo.save_checkpoint(epoch=0, path='mt.pth')

Every algorithm of ``ssl_algorithm.SSL_ALGORITHMS`` builds this way, each
with its own flags as overrides (``harness.default_args('ssl_adv',
adv_for_labeled=True, ...)``). Every entry point runs on the card unless
the caller passes ``device='cpu'``.

With ``spatial_train=N`` in ``args`` and a process group of W ranks (formed
by the caller), ``build_algorithm`` builds on the (W/N x N) grid and
``synthetic_batch`` gives this rank its samples and rows of the global
batch, with ``batch['height']`` (``parallel.spatial``).
"""

import numpy as np
import torch

from . import runner
from .nn import loader as nnloader
from .parallel import spatial
from .utils import device as device_util

_TASK_DEFAULTS = {
    'sseg': {'model': 'deeplabv2', 'criterion': 'sseg_criterion'},
    'sreg': {'model': 'unet_lite', 'criterion': 'sreg_criterion'},
}


def _task_module(task):
    if task == 'sseg':
        from .tasks import sseg
        return sseg
    if task == 'sreg':
        from .tasks import sreg
        return sreg
    raise ValueError('Unknown task: {0!r}'.format(task))


def default_args(ssl_algorithm='ssl_null', task='sseg', **overrides):
    """Full-default args namespace for the given task + algorithm."""
    parser = runner.create_parser(ssl_algorithm)
    _task_module(task).add_parser_arguments(parser)
    args = parser.parse_args([])
    args.ssl_algorithm = ssl_algorithm
    args.task = task
    for k, v in overrides.items():
        setattr(args, k.replace('-', '_'), v)
    # the task's defaults for what the overrides leave unset, so that
    # ``models={'model': 'pspnet'}`` alone picks PSPNet
    defaults = _TASK_DEFAULTS[task]
    if not args.models:
        args.models = {'model': defaults['model']}
    for key, value in (('optimizers', 'sgd'), ('lrers', 'polynomiallr'),
                       ('criterions', defaults['criterion'])):
        if not getattr(args, key):
            setattr(args, key, {name: value for name in args.models})
    args.labeled_batch_size = args.batch_size - args.unlabeled_batch_size
    return args


def build_algorithm(args, device='cuda', iters_per_epoch=10):
    """Build the algorithm on ``device`` (mirrors the JAX harness), through
    the builder the task proxy uses."""
    from . import ssl_algorithm as ssl_registry

    task = _task_module(getattr(args, 'task', 'sseg') or 'sseg')
    return ssl_registry.build_algorithm(
        args, task.model, task.criterion, task.func,
        device_util.resolve(device), iters_per_epoch)


def synthetic_batch(args, device='cuda', seed=0):
    """One synthetic two-stream train batch, labeled first: the numpy draws
    of the JAX harness's ``synthetic_batch``, as NCHW images and, for
    ``sseg``, [N,H,W] int64 labels (-1 on the unlabeled rows), for
    ``sreg`` [N,1,H,W] float32 maps in [0, 1) (0 on the unlabeled rows).
    Under ``spatial_train`` this rank's samples and rows of it."""
    device = device_util.resolve(device)
    rng = np.random.default_rng(seed)
    b, s = args.batch_size, args.im_size
    img = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    if getattr(args, 'task', 'sseg') == 'sreg':
        gt = rng.uniform(0.0, 1.0, (b, s, s, 1)).astype(np.float32)
        if args.unlabeled_batch_size > 0:
            gt[args.labeled_batch_size:] = 0.0
    else:
        gt = rng.integers(0, args.num_classes, (b, s, s)).astype(np.int32)
        if args.unlabeled_batch_size > 0:
            gt[args.labeled_batch_size:] = -1
    n_spatial = int(getattr(args, 'spatial_train', 0) or 0)
    if n_spatial > 1:
        (img, gt), height = spatial.shard_train_batch(
            (img, gt), args.labeled_batch_size, args.unlabeled_batch_size,
            spatial.grid_position(n_spatial), spatial.pairs_unlabeled(args))
        return dict(_to_batch(img, gt, device), height=height)
    return _to_batch(img, gt, device)


def synthetic_val_batches(args, n, device='cuda', seed=0):
    """``n`` labeled eval batches of ``labeled_batch_size`` samples for
    ``validate``, drawn with numpy as ``synthetic_batch`` draws: NCHW
    images and [N,H,W] int64 labels in [0, num_classes) (``sseg``) or
    [N,1,H,W] float32 maps in [0, 1) (``sreg``)."""
    device = device_util.resolve(device)
    rng = np.random.default_rng(seed)
    b, s = args.labeled_batch_size, args.im_size
    batches = []
    for _ in range(n):
        img = rng.standard_normal((b, s, s, 3)).astype(np.float32)
        if getattr(args, 'task', 'sseg') == 'sreg':
            gt = rng.uniform(0.0, 1.0, (b, s, s, 1)).astype(np.float32)
        else:
            gt = rng.integers(0, args.num_classes, (b, s, s)).astype(
                np.int32)
        batches.append(_to_batch(img, gt, device))
    return batches


def _to_batch(img, gt, device):
    """NHWC float32 images and [N,H,W] labels or [N,H,W,1] float maps
    (numpy) -> a batch as the loader gives it (``nn.loader.to_device``)."""
    return nnloader.to_device((torch.from_numpy(img),),
                              (torch.from_numpy(gt),), device)
