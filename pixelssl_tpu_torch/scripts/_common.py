"""Shared base config of the port's experiment scripts (counterpart of
``scripts/_common.py``).

Each script states only its deltas from this base: the reference's
benchmark configurations (task/sseg/script/*.py). Like the reference, a
script rescores a pretrained checkpoint by default,
``pretrained/<exp_id>.pth`` (script/*.py:24-25); override
``('validation', False), ('resume', '')`` to train from scratch. The
scripts read the PASCAL VOC tree at ``VOC`` (not in the repository: the
reference's ``dataset/PascalVOC`` download); on another tree, override
``trainset`` and ``valset``, e.g. ``--trainset "{pascal_voc_aug: [tree]}"``.
``tests/data/voc_fixture/VOC2012`` is a small tree of that format, and
``quickstart_synthetic.py`` runs on synthetic data.
"""

import collections
import os

import pixelssl_tpu_torch as pixelssl
from pixelssl_tpu_torch.tasks import sseg

VOC = 'dataset/PascalVOC/VOCdevkit/VOC2012'


def base_config(script_file, model, ssl_algorithm, epochs,
                sublabeled_ratio=None, deltas=()):
    exp_id = os.path.basename(script_file).split('.')[0]
    cfg = collections.OrderedDict([
        ('exp_id', exp_id),
        ('ssl_algorithm', ssl_algorithm),

        # exp: rescore a pretrained checkpoint, as the reference does
        ('resume', 'pretrained/{0}.pth'.format(exp_id)),
        ('validation', True),
        ('exact_val', True),
        ('out_path', 'result'),
        ('visualize', False),
        ('debug', False),
        ('val_freq', 1),
        ('log_freq', 50),
        ('visual_freq', 50),
        ('checkpoint_freq', 10),

        # data
        ('trainset', {'pascal_voc_aug': [VOC]}),
        ('valset', {'pascal_voc_aug': [VOC]}),
        ('num_workers', 2),

        # components
        ('models', {'model': model}),
        ('optimizers', {'model': 'sgd'}),
        ('lrers', {'model': 'polynomiallr'}),
        ('criterions', {'model': 'sseg_criterion'}),

        # optimizer / schedule (all reference benchmarks share these)
        ('lr', 0.00025),
        ('momentum', 0.9),
        ('weight_decay', 0.0005),

        # model
        ('output_stride', 16),
        ('backbone', 'resnet101-coco'),

        ('epochs', epochs),
        ('batch_size', 4),
        ('unlabeled_batch_size', 0 if ssl_algorithm == 'ssl_null' else 2),
        ('ignore_unlabeled', ssl_algorithm == 'ssl_null'),
    ])
    if model == 'deeplabv2':
        cfg.update([('im_size', 321), ('train_base_size', 400),
                    ('val_rescaling', True)])
    else:  # pspnet
        cfg.update([('im_size', 513), ('train_base_size', 513),
                    ('val_rescaling', False)])
    if sublabeled_ratio:
        cfg['sublabeled_path'] = (
            'dataset/PascalVOC/sublabeled_prefix/{0}/0.txt'.format(
                sublabeled_ratio))
    cfg.update(collections.OrderedDict(deltas))
    return cfg


def run(config, device='cuda'):
    return pixelssl.run_script(config, sseg, sseg.SemanticSegmentationProxy,
                               device=device)
