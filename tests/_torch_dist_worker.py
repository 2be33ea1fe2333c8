"""One rank of a ``torch.distributed`` run of the port on the CPU (gloo),
for ``tests/test_torch_parallel.py``:

    python tests/_torch_dist_worker.py JOB RANK OUT

``JOB`` is a ``torch.save``d dict: ``kind`` ('steps', 'validate' or
'script'), ``world``, ``port`` and the kind's inputs (see ``run_*``); the
rank writes what it saw to ``OUT``. Imports the port only.
"""

import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pixelssl_tpu_torch import harness, parallel  # noqa: E402
from pixelssl_tpu_torch.task_template.proxy import _ValLoader  # noqa: E402


def local_batch(job, images, labels, rank):
    """Rank ``rank``'s labeled-first slice of a global NHWC batch."""
    lbs, ubs, world = job['lbs'], job['ubs'], job['world']
    n = (lbs + ubs) // world
    if ubs > 0:
        images = parallel.reorder_two_stream(images, lbs, ubs, world)
        labels = parallel.reorder_two_stream(labels, lbs, ubs, world)
    images = images[rank * n:(rank + 1) * n]
    labels = labels[rank * n:(rank + 1) * n]
    return harness._to_batch(images, labels, 'cpu')


def run_steps(job, rank):
    """``job['steps']`` train steps of ``job['algorithm']`` on this rank's
    slice of ``job['images']``/``job['labels']``, from ``job['states']``."""
    args = harness.default_args(job['algorithm'], **job['args'])
    algo = harness.build_algorithm(args, device='cpu',
                                   iters_per_epoch=job['iters_per_epoch'])
    for key, state in job['states'].items():
        algo.modules[key].load_state_dict(state)
    batch = local_batch(job, job['images'], job['labels'], rank)
    metrics = []
    for _ in range(job['steps']):
        metrics.append({k: float(v) for k, v in
                        algo.train_step(batch).items()})
    return {'metrics': metrics, 'lbs': algo.ctx.lbs, 'ubs': algo.ctx.ubs,
            'n_dev': algo.ctx.n_dev,
            'states': {k: m.state_dict() for k, m in algo.modules.items()}}


class ListDataset(object):
    def __init__(self, samples):
        self.samples = samples

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]


def run_validate(job, rank):
    """``validate`` of ``job['algorithm']`` on this rank's share of
    ``job['samples']`` (bucketed and ``exact``)."""
    args = harness.default_args(job['algorithm'], **job['args'])
    algo = harness.build_algorithm(args, device='cpu')
    for key, state in job['states'].items():
        algo.modules[key].load_state_dict(state)
    mesh = parallel.make_mesh('cpu')
    out = {}
    for exact in (False, True):
        loader = _ValLoader(ListDataset(job['samples']), 'cpu',
                            exact=exact, mesh=mesh)
        results = algo.validate(loader, 0)
        losses = {k: m.avg for k, m in algo.meters.items()
                  if k.endswith('_loss')}
        out['exact' if exact else 'bucketed'] = dict(results, **losses)
    return out


def run_script(job, rank):
    """``run_script`` of ``job['config']`` with ``--distributed``, from the
    environment ``torchrun`` would set, and again resumed from its last
    checkpoint; counts this rank's ``torch.save`` calls."""
    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sseg

    saves = []
    save = torch.save

    def counted_save(obj, path, *a, **k):
        saves.append(str(path))
        return save(obj, path, *a, **k)

    torch.save = counted_save
    proxy = pixelssl_tpu_torch.run_script(
        dict(job['config']), sseg, sseg.SemanticSegmentationProxy,
        device='cpu', cli_override=False)
    torch.save = save
    algo = proxy.ssl_algorithm
    ckpt = os.path.join(proxy.args.checkpoint_path, 'checkpoint_{0}.pth'
                        .format(job['config']['epochs']))
    resumed = pixelssl_tpu_torch.run_script(
        dict(job['config'], resume=ckpt, validation=True), sseg,
        sseg.SemanticSegmentationProxy, device='cpu', cli_override=False)
    saved = torch.load(ckpt, weights_only=True)['modules']
    equal = {'saved': True, 'trained': True}
    for key, module in resumed.ssl_algorithm.modules.items():
        trained = algo.modules[key].state_dict()
        for name, value in module.state_dict().items():
            equal['saved'] &= torch.equal(value, saved[key][name])
            equal['trained'] &= torch.equal(value, trained[name])
    return {'saves': saves, 'step': algo.state.step,
            'batch_size': proxy.args.batch_size,
            'lbs': algo.ctx.lbs, 'ubs': algo.ctx.ubs,
            'n_devices': proxy.args.n_devices, 'lr': proxy.args.lr,
            'val_len': len(proxy.val_loader),
            'resumed_step': resumed.ssl_algorithm.state.step,
            'resumed_equal': equal}


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
    result = {'steps': run_steps, 'validate': run_validate,
              'script': run_script}[job['kind']](job, rank)
    torch.save(result, out_path)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == '__main__':
    main(*sys.argv[1:])
