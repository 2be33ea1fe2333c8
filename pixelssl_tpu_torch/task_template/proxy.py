"""Task proxy: experiment orchestration (counterpart of
``pixelssl_tpu/task_template/proxy.py``; reference
pixelssl/task_template/proxy.py:18-457).

The reference's pipeline: argument checks -> output directories -> dataset
wiring (``SplitUnlabeledWrapper``/``JointDatasetsWrapper`` and the
two-stream sampler) -> the algorithm's build -> the epoch loop with its
validation and checkpoint frequencies. The port runs on the ``device``
argument (the card unless the caller asks for the CPU).

``--distributed`` (under ``torchrun``) forms the process group first
(``parallel.multihost.initialize``); each rank then runs on
``cuda:<LOCAL_RANK>`` (the CPU when asked). As the JAX proxy scales by its
mesh (proxy.py:258-272), the config's batch sizes and lr are per rank and
are multiplied by the number of ranks; each rank loads its own slice of
every global batch (``ProcessShardedSampler``) with ``--num-workers``
workers of its own, so that the workers of all ranks are as many as the
JAX package's, and validates its share of the samples (``_ValLoader``).

``--visualize`` makes ``visualization/{debug,train,val}`` under the
experiment's folder and points ``--visual-*-path`` there.

``--spatial-train N`` (with ``--distributed``, N dividing the ranks)
arranges the ranks as a (W/N x N) grid (``parallel.make_mesh_2d``): the
batch and lr scale by the data axis W/N, each rank loads the samples of
its data coordinate and keeps its rows of them on the host before the
copy, and validation scores whole samples in batches of the data axis.
``--spatial-val`` validates one sample at a time, padded to the bucket and
its H to a multiple of the ranks, its rows over every rank
(``_ValLoader``). Both take every algorithm on DeepLab-v2 and PSPNet and
the ``sreg`` task, with ``--visualize`` (rank 0 writes the PNGs of the
rows its spatial group gathers); the two flags together stop, as
``--spatial-train`` without ``--distributed`` does. ``--steps-per-dispatch``
shapes the algorithm's loop (``SSLBase.train``: chunks of a dispatch),
``--eager-ingest`` the train loader (``nn.loader``: the copy on a side
stream); ``--profile-dir`` and ``--profile-steps`` the loop's profiler
window (``utils.profiler``).
"""

import copy
import os
import re
import time

import numpy as np
import torch

from .. import parallel
from ..nn import data as nndata
from ..nn import loader as nnloader
from ..nn import lrer as nnlrer
from ..utils import cmd, logger
from ..utils import device as device_util

_CHECKPOINT_RE = re.compile(r'^checkpoint_(\d+)\.pth$')


def add_parser_arguments(parser):
    """The proxy's flags: names and defaults of the JAX package's
    (reference proxy.py:20-71)."""
    # experiment
    parser.add_argument('--exp-id', type=str, default='', metavar='', help='exp - unique id of experiment')
    parser.add_argument('--resume', type=str, default='', metavar='', help='exp - checkpoint to resume')
    parser.add_argument('--validation', type=cmd.str2bool, default=False, metavar='', help='exp - validation only')
    parser.add_argument('--out-path', type=str, default='', metavar='', help='exp - output root path')
    parser.add_argument('--visualize', type=cmd.str2bool, default=False, metavar='', help='exp - save visualization images')
    parser.add_argument('--debug', type=cmd.str2bool, default=False, metavar='', help='exp - debug mode')
    parser.add_argument('--val-freq', type=int, default=1, metavar='', help='exp - validation frequency [epoch]')
    parser.add_argument('--log-freq', type=int, default=100, metavar='', help='exp - logging frequency [iteration]')
    parser.add_argument('--visual-freq', type=int, default=100, metavar='', help='exp - visualization frequency [iteration]')
    parser.add_argument('--checkpoint-freq', type=int, default=1, metavar='', help='exp - checkpoint frequency [epoch]')
    parser.add_argument('--seed', type=int, default=0, metavar='', help='exp - global random seed')
    parser.add_argument('--steps-per-dispatch', type=int, default=1, metavar='', help='exp - train steps a dispatch: on the card one CUDA graph of the step, replayed once a step')
    parser.add_argument('--eager-ingest', type=cmd.str2bool, default=False, metavar='', help='exp - copy each train batch to the card in a loader thread, on a side stream')
    parser.add_argument('--spatial-val', type=cmd.str2bool, default=False, metavar='', help='exp - validate each image with its rows split over every rank')
    parser.add_argument('--spatial-train', type=int, default=0, metavar='', help='exp - split each train image\'s rows over N ranks of a (W/N x N) grid (with --distributed)')
    parser.add_argument('--profile-dir', type=str, default='', metavar='', help='exp - trace train steps [1, 1 + profile-steps] of epoch 0 into this directory (torch.profiler, Chrome trace)')
    parser.add_argument('--profile-steps', type=int, default=10, metavar='', help='exp - steps (or dispatches) traced by --profile-dir')
    parser.add_argument('--exact-val', type=cmd.str2bool, default=False, metavar='',
                        help='exp - the reference validation protocol: batch 1, '
                             'the image unpadded (reference proxy.py:402-403)')
    parser.add_argument('--auto-resume', type=cmd.str2bool, default=False, metavar='',
                        help='exp - resume from the newest checkpoint_<epoch>.pth '
                             'of the experiment, if there is one')
    parser.add_argument('--distributed', type=cmd.str2bool, default=False, metavar='', help='exp - data parallel over processes, one card a process (launch with torchrun)')

    # dataset / data loader
    parser.add_argument('--trainset', type=cmd.strdict, default={}, metavar='', help='data - {dataset_type: [paths]}')
    parser.add_argument('--valset', type=cmd.strdict, default={}, metavar='', help='data - {dataset_type: [paths]}')
    parser.add_argument('--num-workers', type=int, default=1, metavar='', help='data - loader worker processes a rank')
    parser.add_argument('--im-size', type=int, default=None, metavar='', help='data - target input image size')
    parser.add_argument('--unlabeledset', type=cmd.strdict, default={}, metavar='', help='data - extra unlabeled sets')
    parser.add_argument('--sublabeled-path', type=str, default='', metavar='', help='data - labeled-subset prefix file')
    parser.add_argument('--ignore-unlabeled', type=cmd.str2bool, default=True, metavar='', help='data - skip unlabeled samples')

    # SSL algorithm
    parser.add_argument('--ssl-algorithm', type=str, default='', metavar='', help='ssl - algorithm name')
    parser.add_argument('--models', type=cmd.strdict, default={}, metavar='', help='ssl - {component: task_model}')
    parser.add_argument('--optimizers', type=cmd.strdict, default={}, metavar='', help='ssl - {component: optimizer}')
    parser.add_argument('--lrers', type=cmd.strdict, default={}, metavar='', help='ssl - {component: lrer}')
    parser.add_argument('--criterions', type=cmd.strdict, default={}, metavar='', help='ssl - {component: criterion}')

    # training
    parser.add_argument('--epochs', type=int, default=1, metavar='', help='train - total epochs')
    parser.add_argument('--batch-size', type=int, default=16, metavar='', help='train - batch size a rank')
    parser.add_argument('--unlabeled-batch-size', type=int, default=0, metavar='', help='train - unlabeled samples a rank\'s batch')

    # autoset
    parser.add_argument('--n-devices', type=int, default=0, metavar='', help='autoset - ranks')
    parser.add_argument('--task', type=str, default='', metavar='', help='autoset - task name')
    parser.add_argument('--labeled-batch-size', type=int, default=None, metavar='', help='autoset - labeled samples a batch')
    parser.add_argument('--checkpoint-path', type=str, default='', metavar='', help='autoset - checkpoint dir')
    parser.add_argument('--visual-debug-path', type=str, default='', metavar='', help='autoset')
    parser.add_argument('--visual-train-path', type=str, default='', metavar='', help='autoset')
    parser.add_argument('--visual-val-path', type=str, default='', metavar='', help='autoset')
    parser.add_argument('--is-epoch-lrer', type=cmd.str2bool, default=None, metavar='', help='autoset - epoch-wise lr stepping')
    parser.add_argument('--iters-per-epoch', type=int, default=None, metavar='', help='autoset')


def _latest_checkpoint(ckpt_dir):
    """The ``checkpoint_<epoch>.pth`` under ``ckpt_dir`` with the largest
    epoch; None if there is none."""
    if not ckpt_dir or not os.path.isdir(ckpt_dir):
        return None
    best, best_epoch = None, -1
    for name in os.listdir(ckpt_dir):
        match = _CHECKPOINT_RE.match(name)
        if match and int(match.group(1)) > best_epoch:
            best = os.path.join(ckpt_dir, name)
            best_epoch = int(match.group(1))
    return best


class TaskProxy(object):
    NAME = 'task'
    TASK_TYPE = None

    def __init__(self, args, func, data, model, criterion, device='cuda'):
        self.args = args
        self.func = func
        self.data = data
        self.model = model
        self.criterion = criterion
        self._check_spatial(args)
        # the process group forms before any CUDA work of the run
        self.device = parallel.multihost.initialize(
            args, device_util.resolve(device))
        self.mesh = parallel.make_mesh(self.device)
        if args.spatial_train > 1:
            self.mesh = parallel.make_mesh_2d(args.spatial_train, self.mesh)
        # --spatial-val: every rank holds rows of the same sample
        self.val_mesh = (parallel.make_mesh_2d(self.mesh.world_size,
                                               self.mesh)
                         if args.spatial_val else None)

        self.train_loader = None
        self.val_loader = None
        self.ssl_algorithm = None

        self._init()

    # ------------------------------------------------------------------

    def _check_spatial(self, args):
        """The refusals of ``--spatial-train`` and ``--spatial-val`` (JAX
        proxy.py:160-174), before the process group forms."""
        if args.spatial_train > 1:
            if args.spatial_val:
                logger.log_err('--spatial-train and --spatial-val are '
                               'mutually exclusive (use --exact-val or the '
                               'bucketed default for validation)')
            if not args.distributed:
                logger.log_err('--spatial-train {0} splits each image over '
                               'ranks: launch with torchrun and '
                               '--distributed true'.format(
                                   args.spatial_train))

    def _init(self):
        self._preprocess_arguments()
        self._create_dataloader()
        self._build_ssl_algorithm()

    def run(self):
        args = self.args
        start_epoch = 0
        if args.auto_resume and not args.resume:
            latest = _latest_checkpoint(args.checkpoint_path)
            if latest is not None:
                logger.log_info('--auto-resume: found {0}'.format(latest))
                args.resume = latest
        if args.resume:
            if not os.path.exists(args.resume):
                logger.log_err(
                    'Cannot find checkpoint to resume: {0}\nOverride '
                    "('validation', False), ('resume', '') to train from "
                    'scratch.'.format(args.resume))
            start_epoch = self.ssl_algorithm.load_checkpoint(args.resume)

        if args.validation:
            self.ssl_algorithm.validate(self.val_loader, start_epoch)
            return

        for epoch in range(start_epoch, args.epochs):
            t0 = time.time()
            self.ssl_algorithm.train(self.train_loader, epoch)
            self.ssl_algorithm.log_epoch_summary(
                epoch, time.time() - t0, len(self.train_loader))
            if self.val_loader is not None and (epoch + 1) % args.val_freq == 0:
                self.ssl_algorithm.validate(self.val_loader, epoch)
            if (epoch + 1) % args.checkpoint_freq == 0:
                self.ssl_algorithm.save_checkpoint(epoch + 1)

    # ------------------------------------------------------------------

    def _preprocess_arguments(self):
        args = self.args
        logger.log_mode(args.debug)
        args.task = self.NAME

        # component dicts and the kind of their lr schedules (reference
        # proxy.py:198-237, JAX proxy.py:241-257)
        dicts = [args.models, args.optimizers, args.lrers, args.criterions]
        if len(set(len(d) for d in dicts)) != 1:
            logger.log_err('models/optimizers/lrers/criterions dicts must '
                           'have the same keys')
        for d in dicts[1:]:
            if set(d.keys()) != set(args.models.keys()):
                logger.log_err('models/optimizers/lrers/criterions dicts must '
                               'have the same keys')
        if len(set(name in nnlrer.EPOCH_LRERS
                   for name in args.lrers.values())) > 1:
            logger.log_err('All lrers must be of the same kind '
                           '(epoch-wise or iter-wise), reference '
                           'proxy.py:218-237')
        if args.lrers:
            args.is_epoch_lrer = (list(args.lrers.values())[0] in
                                  nnlrer.EPOCH_LRERS)

        # batch and lr per rank, scaled by the ranks of the data axis as the
        # JAX proxy scales by its mesh; the workers are a rank's own
        n_dev = parallel.data_axis_size(self.mesh)
        args.n_devices = n_dev
        if n_dev > 1:
            if getattr(args, 'lr', None) not in (None, -1):
                args.lr = args.lr * n_dev
            args.batch_size = args.batch_size * n_dev
            args.unlabeled_batch_size = args.unlabeled_batch_size * n_dev
        args.labeled_batch_size = args.batch_size - args.unlabeled_batch_size
        if args.labeled_batch_size <= 0:
            logger.log_err('labeled_batch_size = batch_size - '
                           'unlabeled_batch_size must be > 0')

        # output directories (reference proxy.py:179-249)
        if args.out_path:
            exp_dir = os.path.join(args.out_path, args.exp_id or 'exp')
            args.checkpoint_path = os.path.join(exp_dir, 'ckpt')
            os.makedirs(args.checkpoint_path, exist_ok=True)
            if args.visualize:
                for sub in ('debug', 'train', 'val'):
                    path = os.path.join(exp_dir, 'visualization', sub)
                    os.makedirs(path, exist_ok=True)
                    setattr(args, 'visual_{0}_path'.format(sub), path)
            if self.mesh.rank == 0:
                logger.log_file(os.path.join(
                    exp_dir, 'val.log' if args.validation else 'train.log'))

    # ------------------------------------------------------------------

    def _load_dataset(self, dataset_name, dataset_dir, is_train=True):
        """One dataset through the task data module's export function
        (reference proxy.py:443-457)."""
        if not hasattr(self.data, dataset_name):
            logger.log_err('Unknown dataset type: {0}'.format(dataset_name))
        dataset_args = copy.deepcopy(self.args)
        if is_train:
            dataset_args.trainset = {dataset_name: dataset_dir}
        else:
            dataset_args.valset = {dataset_name: dataset_dir}
        return getattr(self.data, dataset_name)()(dataset_args, is_train)

    def _create_dataloader(self):
        args = self.args
        with_unlabeled = (not args.ignore_unlabeled) and args.unlabeled_batch_size != 0
        without_unlabeled = args.ignore_unlabeled and args.unlabeled_batch_size == 0

        labeled_train_samples = unlabeled_train_samples = 0
        trainset = None
        if not args.validation:
            if args.ignore_unlabeled and args.unlabeled_batch_size != 0:
                logger.log_err('ignore_unlabeled == True requires unlabeled_batch_size == 0')
            if not args.ignore_unlabeled and args.unlabeled_batch_size == 0:
                logger.log_err('ignore_unlabeled == False requires unlabeled_batch_size != 0')

            trainset_num = sum(len(v) for v in args.trainset.values())
            unlabeledset_num = sum(len(v) for v in args.unlabeledset.values())

            if trainset_num == 1 and unlabeledset_num == 0:
                name = list(args.trainset.keys())[0]
                trainset = self._load_dataset(name, list(args.trainset.values())[0][0])
                labeled_train_samples = len(trainset.idxs)

                sublabeled_prefix = None
                if args.sublabeled_path:
                    if not os.path.exists(args.sublabeled_path):
                        logger.log_err('Cannot find labeled file: {0}'.format(args.sublabeled_path))
                    with open(args.sublabeled_path) as f:
                        sublabeled_prefix = [l.strip() for l in f.read().splitlines() if l.strip()]
                    sublabeled_prefix = sublabeled_prefix or None

                if sublabeled_prefix is not None:
                    trainset = nndata.SplitUnlabeledWrapper(
                        trainset, sublabeled_prefix,
                        ignore_unlabeled=args.ignore_unlabeled)
                    labeled_train_samples = len(trainset.labeled_idxs)
                    unlabeled_train_samples = len(trainset.unlabeled_idxs)
                elif with_unlabeled:
                    logger.log_err('Unlabeled samples requested without an SSL dataset wrapper')
            elif trainset_num > 1 or unlabeledset_num > 0:
                if args.sublabeled_path:
                    logger.log_err('Multiple training sets: sublabeled_path is not allowed')
                labeled_sets = [self._load_dataset(n, d)
                                for n, dirs in args.trainset.items() for d in dirs]
                unlabeled_sets = [self._load_dataset(n, d)
                                  for n, dirs in args.unlabeledset.items() for d in dirs]
                if not unlabeled_sets and with_unlabeled:
                    logger.log_err('Unlabeled samples requested but no unlabeledset given')
                trainset = nndata.JointDatasetsWrapper(
                    labeled_sets, unlabeled_sets,
                    ignore_unlabeled=args.ignore_unlabeled)
                labeled_train_samples = len(trainset.labeled_idxs)
                unlabeled_train_samples = len(trainset.unlabeled_idxs)

            if trainset is not None:
                if without_unlabeled:
                    idxs = (trainset.labeled_idxs
                            if getattr(trainset, 'labeled_idxs', None)
                            else list(range(len(trainset))))
                    sampler = nndata.OneStreamBatchSampler(
                        idxs, args.batch_size, seed=args.seed)
                    lbs, ubs = args.batch_size, 0
                else:
                    sampler = nndata.TwoStreamBatchSampler(
                        trainset.labeled_idxs, trainset.unlabeled_idxs,
                        args.labeled_batch_size, args.unlabeled_batch_size,
                        seed=args.seed)
                    lbs, ubs = args.labeled_batch_size, args.unlabeled_batch_size
                if self.mesh.spatial:
                    # the samples of its data coordinate, the halves of
                    # the unlabeled block dealt alike where the algorithm
                    # pairs them (parallel/spatial.py)
                    sampler = parallel.spatial.GridSampler(
                        sampler, lbs, ubs, self.mesh,
                        parallel.spatial.pairs_unlabeled(args))
                elif self.mesh.world_size > 1:
                    # every rank walks the same seeded global sequence and
                    # loads only its own slice (parallel/multihost.py): the
                    # samples of its data coordinate
                    sampler = parallel.multihost.ProcessShardedSampler(
                        sampler, lbs, ubs,
                        parallel.multihost.local_device_positions(self.mesh),
                        parallel.data_axis_size(self.mesh))
                self.train_loader = nnloader.DataLoader(
                    trainset, sampler, self.device,
                    num_workers=args.num_workers,
                    eager_ingest=args.eager_ingest,
                    rows_of=self.mesh if self.mesh.spatial else None)

        valset_num = sum(len(v) for v in args.valset.values())
        valset = None
        if valset_num == 1:
            name = list(args.valset.keys())[0]
            valset = self._load_dataset(name, list(args.valset.values())[0][0],
                                        is_train=False)
        elif valset_num > 1:
            valsets = [self._load_dataset(n, d, is_train=False)
                       for n, dirs in args.valset.items() for d in dirs]
            valset = nndata.JointDatasetsWrapper(valsets, [], ignore_unlabeled=True)
        if valset is not None:
            self.val_loader = _ValLoader(
                valset, self.device, getattr(args, 'ignore_index', 255),
                exact=args.exact_val, mesh=self.mesh,
                spatial_mesh=self.val_mesh)

        if self.train_loader is None and not args.validation:
            logger.log_err('Train data loader is required unless validation mode')
        if self.val_loader is None and args.validation:
            logger.log_err('Validation data loader is required in validation mode')
        if self.val_loader is None:
            logger.log_warn('No validation loader: skipping validation during training')

        args.iters_per_epoch = len(self.train_loader) if self.train_loader is not None else -1

        logger.log_info('Dataset: train labeled={0} unlabeled={1} val={2}'.format(
            labeled_train_samples, unlabeled_train_samples,
            len(valset) if valset is not None else 0))

    # ------------------------------------------------------------------

    def _build_ssl_algorithm(self):
        from .. import ssl_algorithm as ssl_registry
        args = self.args
        # the lr schedule and the ramp-ups count this run's iterations
        self.ssl_algorithm = ssl_registry.build_algorithm(
            args, self.model, self.criterion, self.func, self.device,
            args.iters_per_epoch, task_type=self.TASK_TYPE, mesh=self.mesh)
        logger.log_info('SSL algorithm: {0}'.format(args.ssl_algorithm))


class _ValLoader(object):
    """Validation batches of one sample, in order. By default each sample
    is padded up to a multiple of ``BUCKET`` in its two leading dims, the
    input with 0 and the label with ``ignore_index`` (ignored by the loss
    and the metrics), with a ``valid`` mask of 1: the JAX package's bucketed
    mode on one device, whose padding reaches the border pixels' logits.
    ``exact`` gives the sample unpadded and no mask (reference
    proxy.py:402-403), the same samples on every rank.

    Across W ranks of the data axis (``mesh``, bucketed mode) batch ``b``
    of data rank ``r`` is sample ``b*W + r``, the JAX loader's batches of W
    samples, one a device; past the last sample a rank gets a copy of the
    last one with an all-ignore label and ``valid`` 0. Under
    ``--spatial-train`` the ranks of one data coordinate score the same
    samples whole. ``sharded`` tells ``validate`` to sum its counts over
    the ranks of ``group`` (the data axis).

    ``spatial_mesh`` (``--spatial-val``): every rank takes every sample,
    bucketed, its H padded further to a multiple of the ranks (0 for
    inputs, ``ignore_index`` for labels, JAX proxy.py:604-624), and keeps
    its rows of it; ``batch['height']`` is the padded height."""

    BUCKET = 32

    def __init__(self, dataset, device, ignore_index=255, exact=False,
                 mesh=None, spatial_mesh=None):
        self.dataset = dataset
        self.device = device
        self.ignore_index = ignore_index
        self.exact = exact
        self.spatial_mesh = None if exact else spatial_mesh
        self.rank = mesh.data_rank if mesh is not None else 0
        self.world = parallel.data_axis_size(mesh) if mesh is not None else 1
        if self.spatial_mesh is not None:
            self.rank, self.world = 0, 1
        self.sharded = (not exact and mesh is not None and
                        mesh.distributed)
        self.group = mesh.data_group if self.sharded and \
            self.spatial_mesh is None else None

    def _pad(self, arr, fill):
        arr = np.asarray(arr)
        pads = [(0, 0)] * arr.ndim
        for d in range(min(2, arr.ndim)):
            pads[d] = (0, -arr.shape[d] % self.BUCKET)
        if not any(p[1] for p in pads):
            return arr
        return np.pad(arr, pads, mode='constant', constant_values=fill)

    def _rows(self, arr, fill):
        """A sample's rows on this rank (``--spatial-val``), its H padded to
        a multiple of the ranks first."""
        mesh = self.spatial_mesh
        arr, _ = parallel.pad_height_to(mesh, np.asarray(arr)[None],
                                        fill=fill)
        lo, hi = parallel.spatial.local_rows(arr.shape[1], mesh)
        return arr[0, lo:hi], arr.shape[1]

    def __len__(self):
        n = len(self.dataset)
        return n if self.exact else -(-n // self.world)

    def __iter__(self):
        n = len(self.dataset)
        for b in range(len(self)):
            i = b if self.exact else b * self.world + self.rank
            inp, gt = self.dataset[min(i, n - 1)]
            valid = height = None
            if not self.exact:
                if i >= n:
                    gt = tuple(np.full_like(np.asarray(g), self.ignore_index)
                               for g in gt)
                inp = tuple(self._pad(a, 0.0) for a in inp)
                gt = tuple(self._pad(g, self.ignore_index) for g in gt)
                valid = torch.full((1,), 1.0 if i < n else 0.0)
            if self.spatial_mesh is not None:
                rows = [self._rows(a, 0) for a in inp]
                inp, height = tuple(r for r, _ in rows), rows[0][1]
                gt = tuple(self._rows(g, self.ignore_index)[0] for g in gt)
            inp = tuple(torch.from_numpy(np.ascontiguousarray(a)[None])
                        for a in inp)
            gt = tuple(torch.from_numpy(np.ascontiguousarray(g)[None])
                       for g in gt)
            batch = nnloader.to_device(inp, gt, self.device, valid)
            if height is not None:
                batch['height'] = height
            yield batch
