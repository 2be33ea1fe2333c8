"""Quickstart: train Mean Teacher on the synthetic dataset with the port
(counterpart of ``scripts/quickstart_synthetic.py``).

No downloads and no checkpoints: the whole pipeline (two-stream
labeled/unlabeled batching, train steps, validation of student and
teacher, checkpoints, rescoring) in a minute on the card, with the JAX
quickstart's config: DeepLab-v2 on ResNet-10 at 32 px, 4 classes, batch 2
(1 labeled + 1 unlabeled), frozen BatchNorm, bf16 autocast. Any config key
can be overridden on the command line (``--epochs 3``,
``--out-path runs``)::

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

    # the JAX quickstart's config (scripts/quickstart_synthetic.py:61-83),
    # key for key; the dataset roots are only hashed into the synthetic
    # draws, never read
    config = collections.OrderedDict([
        ('exp_id', 'quickstart_mt'),
        ('out_path', 'result'),
        ('ssl_algorithm', 'ssl_mt'),
        ('trainset', {'synthetic_sseg': ['/tmp']}),
        ('valset', {'synthetic_sseg': ['/tmp']}),
        ('ignore_unlabeled', False),
        ('models', {'model': 'deeplabv2'}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),
        ('backbone', 'resnet10'),
        ('im_size', 32), ('num_classes', 4),
        ('batch_size', 2),
        ('unlabeled_batch_size', 1),
        ('epochs', 2),
        ('log_freq', 1), ('val_freq', 1), ('checkpoint_freq', 1),
        # random weights on random labels: frozen BN and a small lr keep
        # the short run tame
        ('freeze_bn', True),
        ('lr', 0.0003), ('momentum', 0.9), ('weight_decay', 0.0005),
        ('cons_scale', 0.1), ('cons_rampup_epochs', 2), ('ema_decay', 0.99),
        ('num_workers', 0),
    ])
    if opts.rescore:
        config['validation'] = True
        config['resume'] = opts.rescore
    # half of the 64 synthetic samples are labeled; the other half go
    # through the unlabeled stream as a real sublabeled split's would. The
    # list is a temporary file where the JAX script writes it under its
    # --out: the port's command line may override out_path after this
    # config is made
    with tempfile.TemporaryDirectory() as tmp:
        config['sublabeled_path'] = os.path.join(tmp, 'sublabeled.txt')
        with open(config['sublabeled_path'], 'w') as f:
            for i in range(0, 64, 2):
                f.write('synthetic_{0:05d}\n'.format(i))
        return pixelssl_tpu_torch.run_script(
            config, sseg, sseg.SemanticSegmentationProxy,
            device='cpu' if opts.cpu else 'cuda')


if __name__ == '__main__':
    main()
