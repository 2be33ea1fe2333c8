"""Demo: an SSL algorithm on the pixel-wise regression task with the port
(counterpart of ``scripts/sreg_synthetic_sslmt.py``).

The synthetic matting-style dataset of ``tasks/sreg`` (no downloads, no
checkpoints), ``unet_lite`` at base 32 and 64 px, Adam at lr 1e-3 with the
gradients clipped to norm 5 and the poly schedule, batch 1 labeled + 1
unlabeled (2 labeled for SupOnly), 4 epochs of 64 iterations, validation
(MSE, MAE, PSNR) after each and a checkpoint at the end::

    python pixelssl_tpu_torch/scripts/sreg_synthetic_sslmt.py
    python pixelssl_tpu_torch/scripts/sreg_synthetic_sslmt.py --algorithm ssl_gct
    python pixelssl_tpu_torch/scripts/sreg_synthetic_sslmt.py --cpu --epochs 1
    python pixelssl_tpu_torch/scripts/sreg_synthetic_sslmt.py \\
        --rescore result/sreg_demo/ckpt/checkpoint_4.pth

It runs on the card unless ``--cpu`` is given. ``--algorithm`` takes the
five algorithms that support REGRESSION (``ssl_null``, ``ssl_mt``,
``ssl_adv``, ``ssl_gct``, ``ssl_s4l``); CCT and CutMix support
CLASSIFICATION only.
"""

import argparse
import collections
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

# each algorithm's flags, as the JAX script sets them
ALGO_FLAGS = {
    'ssl_null': {},
    'ssl_mt': {'cons_scale': 1.0, 'cons_rampup_epochs': 2,
               'ema_decay': 0.99, 'gaussian_noise_std': 0.05},
    'ssl_adv': {'adv_for_labeled': True, 'labeled_adv_scale': 0.01,
                'unlabeled_adv_scale': 0.001,
                'unlabeled_for_discriminator': True},
    'ssl_gct': {'ssl_mode': 'gct', 'fc_ssl_scale': 1.0, 'dc_ssl_scale': 1.0,
                'dc_threshold': 0.4, 'dc_rampup_epochs': 2, 'mu': 0.5,
                'nu': 1, 'fd_scale': 1.0},
    'ssl_s4l': {'rotated_sup_scale': 0.5, 'rotation_scale': 1.0},
}


def make_config(algorithm='ssl_mt', out='result', epochs=4, rescore=''):
    """The JAX script's config for ``algorithm``. The dataset roots are
    only hashed into the synthetic draws, never read; they are the JAX
    script's, so that the samples are its samples."""
    config = collections.OrderedDict([
        ('exp_id', 'sreg_demo'),
        ('out_path', out),
        ('ssl_algorithm', algorithm),
        ('trainset', {'synthetic_sreg': ['/tmp']}),
        ('valset', {'synthetic_sreg': ['/tmp']}),
        ('num_workers', 0),
        ('im_size', 64),
        ('synthetic_samples', 64),
        ('models', {'model': 'unet_lite'}),
        ('optimizers', {'model': 'adam'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sreg_criterion'}),
        ('base_channels', 32),
        ('batch_size', 2),
        ('unlabeled_batch_size', 0),
        ('epochs', epochs),
        ('lr', 0.001), ('weight_decay', 0.0),
        ('clip_grad_norm', 5.0),
        ('log_freq', 4), ('val_freq', 1), ('checkpoint_freq', epochs),
    ])
    if algorithm != 'ssl_null':
        config['unlabeledset'] = {'synthetic_sreg': ['/tmp/u']}
        config['unlabeled_batch_size'] = 1
        config['ignore_unlabeled'] = False
    config.update(ALGO_FLAGS[algorithm])
    if rescore:
        config['validation'] = True
        config['resume'] = rescore
    return config


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU instead of the card')
    ap.add_argument('--algorithm', default='ssl_mt',
                    choices=sorted(ALGO_FLAGS))
    ap.add_argument('--out', default='result')
    ap.add_argument('--epochs', type=int, default=4)
    ap.add_argument('--rescore', default='',
                    help='checkpoint path: skip training, validate only')
    opts = ap.parse_args(argv)

    import pixelssl_tpu_torch
    from pixelssl_tpu_torch.tasks import sreg

    return pixelssl_tpu_torch.run_script(
        make_config(opts.algorithm, opts.out, opts.epochs, opts.rescore),
        sreg, sreg.PixelRegressionProxy,
        device='cpu' if opts.cpu else 'cuda', cli_override=False)


if __name__ == '__main__':
    main()
