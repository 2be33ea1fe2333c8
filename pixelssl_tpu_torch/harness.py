"""Programmatic experiment harness (counterpart of
``pixelssl_tpu/harness.py``): build an algorithm and synthetic batches
without the proxy, the CLI or data on disk.

    args = harness.default_args('ssl_mt', backbone='resnet101', ...)
    algo = harness.build_algorithm(args)            # on the card
    metrics = algo.train_step(harness.synthetic_batch(args))
    scores = algo.validate(harness.synthetic_val_batches(args, 2), epoch=0)
    algo.save_checkpoint(epoch=0, path='mt.pth')

Every entry point runs on the card unless the caller passes
``device='cpu'``.
"""

import numpy as np
import torch

from . import runner
from .nn import lrer as nnlrer
from .nn import optimizer as nnoptimizer
from .utils import device as device_util

_TASK_DEFAULTS = {
    'sseg': {'model': 'deeplabv2', 'criterion': 'sseg_criterion'},
}


def _task_module(task):
    if task == 'sseg':
        from .tasks import sseg
        return sseg
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
    if not args.models:
        defaults = _TASK_DEFAULTS[task]
        args.models = {'model': defaults['model']}
        args.optimizers = {'model': 'sgd'}
        args.lrers = {'model': 'polynomiallr'}
        args.criterions = {'model': defaults['criterion']}
    args.labeled_batch_size = args.batch_size - args.unlabeled_batch_size
    return args


def build_algorithm(args, device='cuda', iters_per_epoch=10):
    """Resolve the component dicts and build the algorithm on ``device``
    (mirrors the JAX harness, reference proxy.py:421-441)."""
    from . import ssl_algorithm as ssl_registry

    device = device_util.resolve(device)
    task = _task_module(getattr(args, 'task', 'sseg') or 'sseg')
    model_dict, criterion_dict, optimizer_dict, lrer_dict = {}, {}, {}, {}
    for cname in args.models.keys():
        model_dict[cname] = getattr(task.model, args.models[cname])()
        criterion_dict[cname] = getattr(
            task.criterion, args.criterions[cname])()(args)
        lrer_dict[cname] = getattr(nnlrer, args.lrers[cname])(args)
        optimizer_dict[cname] = getattr(nnoptimizer,
                                        args.optimizers[cname])(args)
    task_func = task.func.task_func()(args)

    builder = ssl_registry.get_builder(args.ssl_algorithm)
    algo = builder(args, model_dict, optimizer_dict, lrer_dict,
                   criterion_dict, task_func, device=device,
                   lbs=args.labeled_batch_size,
                   ubs=args.unlabeled_batch_size,
                   iters_per_epoch=iters_per_epoch)
    algo.build()
    return algo


def synthetic_batch(args, device='cuda', seed=0):
    """One synthetic two-stream train batch, labeled first: the numpy draws
    of the JAX harness's ``synthetic_batch``, as NCHW images and [N,H,W]
    int64 labels (-1 on the unlabeled rows)."""
    device = device_util.resolve(device)
    rng = np.random.default_rng(seed)
    b, s = args.batch_size, args.im_size
    img = rng.standard_normal((b, s, s, 3)).astype(np.float32)
    gt = rng.integers(0, args.num_classes, (b, s, s)).astype(np.int32)
    if args.unlabeled_batch_size > 0:
        gt[args.labeled_batch_size:] = -1
    return _to_batch(img, gt, device)


def synthetic_val_batches(args, n, device='cuda', seed=0):
    """``n`` labeled eval batches of ``labeled_batch_size`` samples for
    ``validate``, drawn with numpy as ``synthetic_batch`` draws: NCHW
    images and [N,H,W] int64 labels in [0, num_classes)."""
    device = device_util.resolve(device)
    rng = np.random.default_rng(seed)
    b, s = args.labeled_batch_size, args.im_size
    batches = []
    for _ in range(n):
        img = rng.standard_normal((b, s, s, 3)).astype(np.float32)
        gt = rng.integers(0, args.num_classes, (b, s, s)).astype(np.int32)
        batches.append(_to_batch(img, gt, device))
    return batches


def _to_batch(img, gt, device):
    """NHWC float32 images and [N,H,W] labels (numpy) -> a batch of NCHW
    images and int64 labels on ``device``."""
    img = torch.from_numpy(img).permute(0, 3, 1, 2).contiguous().to(device)
    gt = torch.from_numpy(gt).long().to(device)
    return {'inp': (img,), 'gt': (gt,)}
