"""One rank of a spatially partitioned run of the port on the CPU (gloo),
for ``tests/test_torch_spatial.py``:

    python tests/_torch_spatial_worker.py JOB RANK OUT

``JOB`` is a ``torch.save``d dict: ``kind`` ('layers', 'steps', 'script'
or 'many': a list of those in ``jobs``, run in turn in one process group),
``world``, ``port`` and the kind's inputs (see ``run_*``); the rank writes
what it saw to ``OUT``. The layer cases live here (``layer_case``,
``run_layer``) so that the test computes the one-process reference with
the same code. Imports the port only.
"""

import contextlib
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pixelssl_tpu_torch import harness, parallel  # noqa: E402
from pixelssl_tpu_torch.models import cct_decoders as cct  # noqa: E402
from pixelssl_tpu_torch.models import layers  # noqa: E402
from pixelssl_tpu_torch.models.deeplab_v2 import DeepLabV2  # noqa: E402
from pixelssl_tpu_torch.models.discriminator import (  # noqa: E402
    FCDiscriminator)
from pixelssl_tpu_torch.models.flaw_detector import (  # noqa: E402
    FlawDetector, IBNorm)
from pixelssl_tpu_torch.models.pspnet import (  # noqa: E402
    PSPModule, UpsampleDecoder)
from pixelssl_tpu_torch.models.rotation import (  # noqa: E402
    RotationClassifier)
from pixelssl_tpu_torch.ops import blur  # noqa: E402
from pixelssl_tpu_torch.parallel import spatial  # noqa: E402
from pixelssl_tpu_torch.ssl_algorithm import ssl_base  # noqa: E402
from pixelssl_tpu_torch.ssl_algorithm import ssl_gct, ssl_s4l  # noqa: E402
from pixelssl_tpu_torch.tasks.sreg.model import ConvBNRelu  # noqa: E402

N, C, W = 2, 3, 10

# name -> (what, arguments): each case at every height of LAYER_HEIGHTS
LAYER_KINDS = {
    'conv3_s1': ('conv', dict(k=3, s=1, p=1, d=1)),
    'conv3_s2': ('conv', dict(k=3, s=2, p=1, d=1)),
    'conv3_d2': ('conv', dict(k=3, s=1, p=2, d=2)),
    'conv3_d24': ('conv', dict(k=3, s=1, p=24, d=24)),
    'conv1_s2': ('conv', dict(k=1, s=2, p=0, d=1)),
    'conv7_s2': ('conv', dict(k=7, s=2, p=3, d=1)),
    'fd_conv4_s2': ('conv', dict(k=4, s=2, p=1, d=1)),
    'fd_conv4_s1': ('conv', dict(k=4, s=1, p=1, d=1)),
    'max_pool': ('pool', {}),
    'resize_up': ('resize', dict(scale=2.0)),
    'resize_down': ('resize', dict(scale=0.3)),
    'sync_bn': ('bn', {}),
    'ibnorm': ('ibn', {}),
    'blur_k5': ('blur', dict(k=5)),
    'blur_k21': ('blur', dict(k=21)),
    'blur_k_over_h': ('blur', dict(k=81)),
    'dilate3x3': ('dilate', {}),
}
# cases at heights of their own
LAYER_KINDS_ELSEWHERE = {'flaw_detector': ('fd', {}),
                         'discriminator': ('d', {}),
                         'rotation_head': ('rc', {}),
                         'whole_rows': ('whole', {}),
                         'rotate': ('rotate', {})}
LAYER_HEIGHTS = (33, 65)
# the dilation 24 of ASPP on the 21-row map of OS 16 at 321 px; the flaw
# detector's classifier on a 3-row map, whose one output row leaves rank 1
# none; the whole flaw detector, whose classifier gives one row at 64 and
# 65 px; AdvSSL's discriminator, whose 4x4/2 chain runs 33 -> 1 row (rank 1
# none) and 65 -> 2 before its resize back (at 21 rows its classifier's
# window outgrows the padded 1-row map, in one process too); S4L's
# rotation head (its
# logits whole on every rank); the gather of a whole map; the rotation of
# a row-sharded square map by 90 and 270 degrees
EXTRA_LAYER_CASES = (('conv3_d24', 21), ('fd_conv4_s2', 3),
                     ('flaw_detector', 64), ('flaw_detector', 65),
                     ('discriminator', 33), ('discriminator', 65),
                     ('rotation_head', 33), ('whole_rows', 33),
                     ('rotate', 33))


# the layers of PSPNet, CCT's decoders and ``unet_lite``, each at heights
# of its own: the half-pixel resize up (33 -> 65) and down (65 -> 17), the
# pyramid's bins (1, 2, 3, 6) over 5 and 3 rows (more bins than rows), the
# x2 shuffle at odd heights (its rows dealt anew), the nearest resize (its
# source rows across the boundary), the PSP module and the decoder (x4) in
# training, the 'SAME' stride-2 ConvBNRelu at an even and an odd height,
# the guided cutout on masks whose components cross the boundary (the
# spiral's turns among them), the masking decoders' nearest mask, VAT's
# perturbation through a decoder and the feature drop
MODEL_LAYER_KINDS = {
    'resize_half_up': ('half', dict(out=65)),
    'resize_half_down': ('half', dict(out=17)),
    'adaptive_pool': ('bins', {}),
    'pixel_shuffle': ('shuffle', {}),
    'resize_nearest': ('nearest', dict(out=50)),
    'psp_module': ('psp', {}),
    'upsample_decoder': ('decoder', {}),
    'same_conv_bn': ('same', {}),
    'cutout_spiral': ('cut', {}),
    'cutout_blobs': ('cut', {}),
    'guided_masking': ('masking', {}),
    'vat': ('vat', {}),
    'feature_dropout': ('fdrop', {}),
}
MODEL_LAYER_CASES = (
    ('resize_half_up', 33), ('resize_half_down', 65), ('adaptive_pool', 5),
    ('adaptive_pool', 3), ('pixel_shuffle', 5), ('pixel_shuffle', 33),
    ('resize_nearest', 33), ('psp_module', 5), ('psp_module', 3),
    ('upsample_decoder', 5), ('same_conv_bn', 32), ('same_conv_bn', 33),
    ('cutout_spiral', 41), ('cutout_blobs', 40), ('guided_masking', 33),
    ('vat', 5), ('feature_dropout', 33))
# the foreground masks of the cutout cases ([B,H,W] bool), set by the job
CUT_MASKS = {}


def layer_cases():
    return [(name, h) for name in sorted(LAYER_KINDS)
            for h in LAYER_HEIGHTS] + list(EXTRA_LAYER_CASES)


def _model_layer_case(what, kw, name, h, rng):
    """``layer_case`` of ``MODEL_LAYER_KINDS``."""
    gen = torch.Generator().manual_seed(h)
    nchw = rng.standard_normal((N, C, h, W)).astype(np.float32)
    if what == 'half':
        size = (kw['out'], 19 if kw['out'] > h else 7)
        return None, (lambda x, hh: layers.resize_bilinear(
            x, size, align_corners=False, h=hh)), nchw, 2, kw['out']
    if what == 'bins':
        return None, (lambda x, hh: torch.cat(
            [layers.adaptive_avg_pool(x, b, hh).flatten(2)
             for b in (1, 2, 3, 6)], 2)), nchw, 2, None
    if what == 'shuffle':
        x = rng.standard_normal((N, 8, h, W)).astype(np.float32)
        return None, (lambda x, hh: layers.pixel_shuffle(x, 2, hh)), x, 2, \
            2 * h
    if what == 'nearest':
        return None, (lambda x, hh: layers.resize_nearest(
            x, (kw['out'], 13), hh)), nchw, 2, kw['out']
    if what in ('psp', 'decoder'):
        module = PSPModule(8) if what == 'psp' else UpsampleDecoder(
            8, C, upscale=4)
        module.init_weights(gen)
        x = rng.standard_normal((N, 8, h, W)).astype(np.float32)
        return module, (lambda x, hh: module(x, hh)), x, 2, \
            h if what == 'psp' else 4 * h
    if what == 'same':
        module = ConvBNRelu(C, 4, stride=2)
        for m in module.modules():
            if isinstance(m, torch.nn.Conv2d):
                torch.nn.init.normal_(m.weight, generator=gen)
        return module, (lambda x, hh: module(x, hh)), nchw, 2, \
            module.out_height(h)
    if what == 'cut':
        mask = CUT_MASKS[name]
        logits = np.stack([~mask, mask], 1).astype(np.float32)
        u = torch.from_numpy(rng.uniform(size=(2, mask.shape[0], 2)).astype(
            np.float32))
        size = (h // 2 + 1, mask.shape[2] // 2 + 1)
        return None, (lambda x, hh: cct.guided_cutout_mask(
            x, u[0], u[1], 0.4, size)), logits, 2, size[0]
    if what == 'masking':
        latent = torch.from_numpy(rng.standard_normal(
            (N, C, 17, W)).astype(np.float32))
        return None, (lambda x, hh: cct.guided_masking(
            spatial.own_rows(latent, 17), x, False, 17)), nchw, 2, 17
    if what == 'vat':
        dec = UpsampleDecoder(C, 2, upscale=2)
        dec.init_weights(gen)
        d = torch.from_numpy(rng.uniform(-0.5, 0.5, (N, C, h, W)).astype(
            np.float32))

        def vat(x, hh):
            def decode(z):
                return dec(z, hh)
            return decode(x + cct.vat_perturbation(
                decode, x, spatial.own_rows(d, hh), 0.1, 2.0))
        return dec, vat, nchw, 2, 2 * h
    u = torch.tensor([0.8, 0.75]).reshape(N, 1, 1, 1)
    return None, (lambda x, hh: cct.feature_dropout(x, u)), nchw, 2, h


def _rng(name, h):
    return np.random.default_rng([h] + [ord(c) for c in name])


def layer_case(name, h):
    """(module or None, fn(x, h) -> out, the global input, the axis of H,
    the global output height, None where every rank gives the whole
    output) of a case; the same on every rank."""
    what, kw = (LAYER_KINDS.get(name) or LAYER_KINDS_ELSEWHERE.get(name) or
                MODEL_LAYER_KINDS[name])
    rng = _rng(name, h)
    torch.manual_seed(h)
    if name in MODEL_LAYER_KINDS:
        return _model_layer_case(what, kw, name, h, rng)
    if what == 'fd':
        # the whole flaw detector (ndf 8) in training: its classifier's one
        # output row at these heights leaves rank 1 none
        fd = FlawDetector(C, ndf=8)
        fd.init_weights(torch.Generator().manual_seed(h))
        x = rng.standard_normal((N, C, h, 64)).astype(np.float32)
        return fd, (lambda x, hh: fd((x[:, :1],), x[:, 1:])), x, 2, h
    if what in ('d', 'rc'):
        # D (ndf 8) on 40 columns, the rotation head on 16
        module = FCDiscriminator(C, ndf=8) if what == 'd' else \
            RotationClassifier(C)
        module.init_weights(torch.Generator().manual_seed(h))
        x = rng.standard_normal((N, C, h, 40 if what == 'd' else 16))
        return module, (lambda x, hh: module(x)), x.astype(np.float32), 2, \
            h if what == 'd' else None
    nchw = rng.standard_normal((N, C, h, W)).astype(np.float32)
    if what == 'whole':
        return None, (lambda x, hh: spatial.whole_rows(x, 2)), nchw, 2, None
    if what == 'rotate':
        square = rng.standard_normal((N, C, h, h)).astype(np.float32)
        angles = torch.tensor([1, 3])
        return None, (lambda x, hh: ssl_s4l.rotate_rows(x, angles, 2)), \
            square, 2, h
    if what == 'conv':
        conv = layers.Conv2d(C, 4, kw['k'], stride=kw['s'], padding=kw['p'],
                             dilation=kw['d'], bias=True)
        with torch.no_grad():
            conv.weight.copy_(torch.from_numpy(rng.standard_normal(
                tuple(conv.weight.shape)).astype(np.float32)))
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(4).astype(
                np.float32)))
        return conv, (lambda x, hh: conv(x, hh)), nchw, 2, \
            conv.out_height(h)
    if what == 'pool':
        return None, (lambda x, hh: layers.max_pool2d(x, 3, 2, 1, hh)), \
            nchw, 2, spatial.conv_out(h, 3, 2, 1)
    if what == 'resize':
        h_out = max(2, int(round(h * kw['scale'])))
        size = (h_out, int(round(W * kw['scale'])) + 1)
        return None, (lambda x, hh: layers.resize_bilinear(
            x, size, align_corners=True, h=hh)), nchw, 2, h_out
    if what in ('bn', 'ibn'):
        module = layers.SyncBatchNorm(C) if what == 'bn' else IBNorm(C)
        for m in module.modules():
            if isinstance(m, layers.SyncBatchNorm):
                with torch.no_grad():
                    m.weight.copy_(torch.from_numpy(
                        rng.uniform(0.5, 1.5, m.num_features).astype(
                            np.float32)))
                    m.bias.copy_(torch.from_numpy(
                        rng.standard_normal(m.num_features).astype(
                            np.float32)))
        return module, (lambda x, hh: module(x)), nchw * 3 + 1, 2, h
    nhwc = np.ascontiguousarray(nchw[:, :1].transpose(0, 2, 3, 1))
    if what == 'blur':
        return None, (lambda x, hh: blur.gaussian_blur_fused(x, kw['k'])), \
            nhwc, 1, h
    return None, (lambda x, hh: ssl_gct._dilate3x3(x)), nhwc, 1, h


def run_layer(name, h, mesh=None):
    """The case's output, input gradient and parameter gradients (of the
    sum of the output times a fixed random map, a share on spatial rank 0
    only where every rank gives the whole output: ``spatial.whole_share``)
    and buffers: of the whole map without ``mesh``, of this rank's rows
    with it (the parameter gradients this rank's part of them)."""
    module, fn, x_full, h_dim, h_out = layer_case(name, h)
    x = torch.from_numpy(x_full)
    if module is not None:
        module.train()
        if mesh is not None:
            for m in module.modules():
                if isinstance(m, layers.SyncBatchNorm):
                    m.sync = mesh
    context = contextlib.nullcontext()
    if mesh is not None:
        lo, hi = spatial.local_rows(h, mesh)
        x = x.narrow(h_dim, lo, hi - lo)
        context = spatial.sharded(mesh, h)
    x = x.clone().requires_grad_(True)
    with context:
        out = fn(x, h)
        shape = list(out.shape)
        if h_out is not None:
            shape[h_dim] = h_out
        # gradients about 1 whatever the map's size
        weight = torch.from_numpy((_rng(name + 'w', h).standard_normal(
            shape) / np.sqrt(np.prod(shape))).astype(np.float32))
        if mesh is not None and h_out is not None:
            lo, hi = spatial.local_rows(h_out, mesh)
            weight = weight.narrow(h_dim, lo, hi - lo)
        loss = (out * weight).sum()
        if h_out is None:
            loss = spatial.whole_share(loss)
    if out.requires_grad:  # a mask has no gradient
        loss.backward()
    params = {} if module is None else {
        k: p.grad.detach().clone() for k, p in module.named_parameters()
        if p.grad is not None}
    buffers = {} if module is None else {
        k: b.detach().clone() for k, b in module.named_buffers()}
    grad = x.grad if x.grad is not None else torch.zeros_like(x)
    return {'out': out.detach(), 'grad': grad.detach(), 'params': params,
            'buffers': buffers, 'h_dim': h_dim,
            'out_dim': None if h_out is None else h_dim}


def model_input(h, w, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (1, h, w, 3)).astype(np.float32)


def run_model(job, mesh):
    """DeepLab-v2 eval forwards of this rank's rows of ``job['model']``'s
    inputs (NHWC), from ``job['model']['state']``."""
    spec = job['model']
    net = DeepLabV2(backbone='resnet10', output_stride=16,
                    num_classes=spec['num_classes'])
    net.load_state_dict(spec['state'])
    net.eval()
    outs = []
    for x in spec['inputs']:
        x = torch.from_numpy(x).permute(0, 3, 1, 2)
        lo, hi = spatial.local_rows(x.shape[2], mesh)
        with torch.no_grad(), spatial.sharded(mesh, x.shape[2]):
            outs.append(net(x[:, :, lo:hi].contiguous())[0])
    return outs


def run_layers(job, rank):
    CUT_MASKS.update(job.get('masks', {}))
    mesh = parallel.make_mesh_2d(job['world'])
    out = {case: run_layer(case[0], case[1], mesh) for case in job['cases']}
    return {'layers': out,
            'model': run_model(job, mesh) if 'model' in job else None}


def run_steps(job, rank):
    """``job['steps']`` train steps of each of ``job['runs']`` under
    ``--spatial-train job['n_spatial']`` on this rank's samples and rows of
    the run's global batch, from its states; counts the blurs of each
    step and the strip heights they ran on. With ``job['states_dir']``
    each rank checks that its final states equal rank 0's, and rank 0
    alone writes them there (``<run>.pt``), one run at a time (PSPNet's
    are 160 MB a model), in place of returning every rank's."""
    shapes = []
    local = blur._blur_local

    def counted(x, kernel_size):
        shapes.append((tuple(x.shape), int(kernel_size)))
        return local(x, kernel_size)

    blur._blur_local = counted
    results = {}
    for name, run in job['runs'].items():
        args = harness.default_args(run['algorithm'], **dict(
            run['args'], spatial_train=job['n_spatial']))
        algo = harness.build_algorithm(args, device='cpu',
                                       iters_per_epoch=job['iters_per_epoch'])
        for key, state in run.get('states', {}).items():
            algo.modules[key].load_state_dict(state)
        (img, gt), height = spatial.shard_train_batch(
            (run['images'], run['labels']), args.labeled_batch_size,
            args.unlabeled_batch_size, algo.mesh,
            spatial.pairs_unlabeled(args))
        batch = dict(harness._to_batch(img, gt, 'cpu'), height=height)
        metrics, blurs = [], []
        for _ in range(job['steps']):
            del shapes[:]
            metrics.append({k: float(v) for k, v in
                            algo.train_step(batch).items()})
            blurs.append(list(shapes))
        results[name] = {
            'metrics': metrics, 'blurs': blurs,
            'lbs': algo.ctx.lbs, 'ubs': algo.ctx.ubs, 'n_dev': algo.ctx.n_dev,
            'grid': (algo.mesh.data_rank, algo.mesh.spatial_rank,
                     algo.mesh.data_size, algo.mesh.n_spatial),
            'rows': spatial.local_rows(height, algo.mesh), 'height': height,
            'states': {k: m.state_dict() for k, m in algo.modules.items()}}
        if job.get('states_dir'):
            states = results[name].pop('states')
            flat = torch.cat([t.float().reshape(-1) for state in
                              states.values() for t in state.values()])
            rank0 = flat.clone()
            dist.broadcast(rank0, src=0)
            results[name]['equal_to_rank0'] = bool(torch.equal(rank0, flat))
            if rank == 0:
                torch.save(states, os.path.join(job['states_dir'],
                                                name + '.pt'))
            del algo, states, flat, rank0
    blur._blur_local = local
    return results


def counting_visual_blurs():
    """Count the blur calls of each train-side visualization
    (``SSLBase._visualize``): returns the list that each visualization
    appends its calls' (input shape, k) to, and a function that undoes the
    counting."""
    visual, calls = [], []
    local, visualize = blur._blur_local, ssl_base.SSLBase._visualize

    def counted(x, kernel_size):
        calls.append((tuple(x.shape), int(kernel_size)))
        return local(x, kernel_size)

    def visualized(self, batch, name):
        del calls[:]
        visualize(self, batch, name)
        visual.append(list(calls))

    blur._blur_local = counted
    ssl_base.SSLBase._visualize = visualized

    def undo():
        blur._blur_local = local
        ssl_base.SSLBase._visualize = visualize
    return visual, undo


def run_script(job, rank):
    """``run_script`` of ``job['config']`` from the environment ``torchrun``
    would set; this rank's view of the run, with the blur calls of each
    train-side visualization."""
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sreg, sseg

    task, proxy_class = ((sreg, sreg.PixelRegressionProxy)
                         if job.get('task') == 'sreg' else
                         (sseg, sseg.SemanticSegmentationProxy))
    visual, undo = counting_visual_blurs()
    try:
        proxy = pixelssl_tpu_torch.run_script(
            dict(job['config']), task, proxy_class, device='cpu',
            cli_override=False)
    finally:
        undo()
    algo = proxy.ssl_algorithm
    return {'step': algo.state.step, 'batch_size': proxy.args.batch_size,
            'visual_blurs': visual,
            'lbs': algo.ctx.lbs, 'ubs': algo.ctx.ubs,
            'n_devices': proxy.args.n_devices, 'lr': proxy.args.lr,
            'val_len': len(proxy.val_loader),
            'meters': {k: m.avg for k, m in algo.meters.items()
                       if 'metric' in k or k.endswith('_loss')},
            'sums': {k: m.sum for k, m in algo.meters.items()
                     if k.endswith('_err_sums')},
            'states': {k: m.state_dict() for k, m in algo.modules.items()}
            if job.get('return_states', True) else None}


KINDS = {'layers': run_layers, 'steps': run_steps, 'script': run_script}


def run_many(job, rank):
    """Each job of ``job['jobs']`` in turn, in this process group (a
    script's ``run_script`` takes the group as it finds it)."""
    return [KINDS[sub['kind']](dict(sub, world=job['world']), rank)
            for sub in job['jobs']]


def main(job_path, rank, out_path):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    rank = int(rank)
    if job['kind'] == 'script':
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                          WORLD_SIZE=str(job['world']),
                          MASTER_ADDR='127.0.0.1',
                          MASTER_PORT=str(job['port']))
    else:
        dist.init_process_group(
            'gloo', init_method='tcp://127.0.0.1:{0}'.format(job['port']),
            rank=rank, world_size=job['world'])
    result = dict(KINDS, many=run_many)[job['kind']](job, rank)
    torch.save(result, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(*sys.argv[1:])
