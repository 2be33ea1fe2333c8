"""Rescore a reference (torch) checkpoint with the port (counterpart of
``scripts/rescore.py``).

    python pixelssl_tpu_torch/scripts/rescore.py deeplabv2_pascalvoc_1-8_suponly \\
        --torch-ckpt /path/to/deeplabv2_pascalvoc_1-8_suponly.ckpt \\
        [--voc-root dataset/PascalVOC/VOCdevkit/VOC2012] [--no-save] [--cpu]

The mIoU fidelity gate, end to end (reference task/sseg/README.md:18-40:
the published checkpoints are validated by the benchmark scripts as they
are). It

1. loads the named script's config (one of the port's scripts beside this
   file) and forces validation with the exact reference protocol (batch 1,
   the image at its own size, unpadded; reference proxy.py:402-403);
2. copies every task-model component of the torch checkpoint (the
   reference's per-algorithm layouts, ``COMPONENT_MAP``) into the port's
   modules with ``models/convert.py``'s ``convert_deeplab_v2`` or
   ``convert_pspnet``;
3. saves the result as ``pretrained/<exp_id>.pth`` in the port's
   checkpoint format (``--no-save`` skips it), which the port's scripts
   resume by default (``scripts/_common.py``), so that the script then
   rescores natively;
4. validates and prints the mIoU.

It runs on the card unless ``--cpu`` (``device='cpu'``) is given.
"""

import argparse
import os
import runpy
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

# the torch checkpoint's model keys -> the port's modules, per algorithm
# (the reference's _save_checkpoint layouts: ssl_null.py:194-201,
# ssl_mt.py:296-303, ssl_adv.py:357-367, ssl_s4l.py:257-264,
# ssl_gct.py:363-376, ssl_cct.py:353-360, ssl_cutmix.py:334-342). Only the
# task models that validation scores are mapped; the auxiliary nets (the
# discriminator, the flaw detector, CCT's decoders, S4L's rotation head)
# keep their fresh initialisation: they add nothing to the val mIoU.
COMPONENT_MAP = {
    'ssl_null': {'model': 'model'},
    'ssl_mt': {'s_model': 'model', 't_model': 'teacher'},
    'ssl_adv': {'model': 'model'},
    'ssl_s4l': {'model': 'model'},
    'ssl_cct': {'model': 'model'},
    'ssl_cutmix': {'s_model': 'model', 't_model': 'teacher'},
    'ssl_gct': {'l_model': 'l_model', 'r_model': 'r_model'},
}

# where a module keeps its task net: bare, inside S4L's or CCT's wrapper
_NET_PREFIXES = ('net.', 'task.net.', 'main.net.')
_SCRIPTS = os.path.dirname(os.path.abspath(__file__))


def _strip_module(sub):
    return {(k[len('module.'):] if k.startswith('module.') else k): v
            for k, v in sub.items()}


def rescore(script_name, torch_ckpt, voc_root=None, save=True,
            overrides=None, device='cuda'):
    """Rescore ``torch_ckpt`` with the config of the port's script
    ``script_name`` (a name, or a path to one of the scripts); returns
    ``{mIoU key: value}``."""
    import torch

    from pixelssl_tpu_torch import runner
    from pixelssl_tpu_torch.models import convert
    from pixelssl_tpu_torch.tasks import sseg
    from pixelssl_tpu_torch.utils import cmd

    script_name = os.path.basename(script_name)
    if script_name.endswith('.py'):
        script_name = script_name[:-3]
    config = dict(runpy.run_path(os.path.join(
        _SCRIPTS, script_name + '.py'))['config'])

    algo_name = config['ssl_algorithm']
    if algo_name not in COMPONENT_MAP:
        raise SystemExit('Unknown algorithm: {0}'.format(algo_name))
    if voc_root:
        config['trainset'] = {list(config['trainset'])[0]: [voc_root]}
        config['valset'] = {list(config['valset'])[0]: [voc_root]}
    config['validation'] = True
    config['exact_val'] = True
    config['resume'] = ''  # the weights come from the torch checkpoint
    config.update(overrides or {})

    parser = runner.create_parser(algo_name)
    sseg.add_parser_arguments(parser)
    args = cmd.parse_args(parser, config, cli_override=False)
    cmd.print_args(args)

    proxy = sseg.SemanticSegmentationProxy(args, device=device)
    algo = proxy.ssl_algorithm

    raw = torch.load(torch_ckpt, map_location='cpu', weights_only=True)
    epoch = int(raw.get('epoch', 0))
    converter = {'deeplabv2': convert.convert_deeplab_v2,
                 'pspnet': convert.convert_pspnet}[
                     list(args.models.values())[0]]
    for ckpt_key, component in COMPONENT_MAP[algo_name].items():
        if ckpt_key not in raw:
            print('WARNING: checkpoint has no `{0}`: `{1}` keeps its fresh '
                  'initialisation'.format(ckpt_key, component))
            continue
        target = algo.modules[component].state_dict()
        prefix = next(p for p in _NET_PREFIXES
                      if any(k.startswith(p) for k in target))
        state = {k: v for k, v in _strip_module(raw[ckpt_key]).items()
                 if torch.is_tensor(v)}
        copied, skipped = converter(state, target, prefix=prefix)
        print('converted `{0}` -> `{1}` ({2} tensors, {3} skipped)'.format(
            ckpt_key, component, copied, skipped))

    if save:
        os.makedirs('pretrained', exist_ok=True)
        algo.save_checkpoint(epoch, path=os.path.join(
            'pretrained', '{0}.pth'.format(args.exp_id)))

    algo.validate(proxy.val_loader, epoch)
    return {k: float(m.avg) for k, m in algo.meters.items() if 'mIoU' in k}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('script', help='the port\'s script name, e.g. '
                                   'deeplabv2_pascalvoc_1-8_suponly')
    ap.add_argument('--torch-ckpt', required=True,
                    help='a reference checkpoint (.ckpt, torch)')
    ap.add_argument('--voc-root', default=None,
                    help='another VOC2012 root directory')
    ap.add_argument('--no-save', action='store_true',
                    help='skip writing pretrained/<exp_id>.pth')
    ap.add_argument('--cpu', action='store_true', help='run on the CPU')
    opts = ap.parse_args()
    results = rescore(opts.script, opts.torch_ckpt, voc_root=opts.voc_root,
                      save=not opts.no_save,
                      device='cpu' if opts.cpu else 'cuda')
    for k, v in sorted(results.items()):
        print('{0} = {1:.5f}'.format(k, v))


if __name__ == '__main__':
    main()
