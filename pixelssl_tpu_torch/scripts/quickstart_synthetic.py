"""Quickstart: train Mean Teacher on the synthetic dataset with the port
(counterpart of ``scripts/quickstart_synthetic.py``).

No downloads and no checkpoints: the whole pipeline (two-stream
labeled/unlabeled batching, loader worker processes, train steps,
validation of student and teacher, checkpoints, rescoring) in a minute on
the card. Any config key can be overridden on the command line
(``--epochs 3``, ``--out-path runs``)::

    python pixelssl_tpu_torch/scripts/quickstart_synthetic.py
    python pixelssl_tpu_torch/scripts/quickstart_synthetic.py --cpu
    python pixelssl_tpu_torch/scripts/quickstart_synthetic.py \\
        --rescore result/quickstart_mt/ckpt/checkpoint_2.pth
"""

import argparse
import collections
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU instead of the card')
    ap.add_argument('--rescore', default='',
                    help='checkpoint path: skip training, validate only')
    opts, rest = ap.parse_known_args()
    # the rest of the command line overrides config keys in run_script
    sys.argv = sys.argv[:1] + rest

    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sseg

    config = collections.OrderedDict([
        ('exp_id', 'quickstart_mt'),
        ('out_path', 'result'),
        ('ssl_algorithm', 'ssl_mt'),
        ('trainset', {'synthetic_sseg': ['synthetic']}),
        ('valset', {'synthetic_sseg': ['synthetic']}),
        ('synthetic_samples', 64),
        ('ignore_unlabeled', False),
        ('models', {'model': 'deeplabv2'}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('backbone', 'resnet10'),
        ('im_size', 64), ('num_classes', 5),
        ('batch_size', 4),
        ('unlabeled_batch_size', 2),
        ('epochs', 2),
        ('log_freq', 4), ('val_freq', 1), ('checkpoint_freq', 1),
        # random weights on random labels: float32 and a small lr keep the
        # short run tame (the ResNet-10 toy diverges at the recipe's 2.5e-4)
        ('bf16', False),
        ('lr', 5e-5), ('momentum', 0.9), ('weight_decay', 0.0005),
        ('cons_for_labeled', False), ('cons_scale', 1.0),
        ('cons_rampup_epochs', 1), ('ema_decay', 0.99),
        ('num_workers', 2),
    ])
    if opts.rescore:
        config['validation'] = True
        config['resume'] = opts.rescore
    # half of the synthetic samples are labeled; the other half go through
    # the unlabeled stream as a real sublabeled split's would
    with tempfile.TemporaryDirectory() as tmp:
        config['sublabeled_path'] = os.path.join(tmp, 'sublabeled.txt')
        with open(config['sublabeled_path'], 'w') as f:
            for i in range(0, config['synthetic_samples'], 2):
                f.write('synthetic_{0:05d}\n'.format(i))
        pixelssl_tpu_torch.run_script(
            config, sseg, sseg.SemanticSegmentationProxy,
            device='cpu' if opts.cpu else 'cuda')


if __name__ == '__main__':
    main()
