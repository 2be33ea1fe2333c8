"""PSPNet / PASCAL VOC 1-8 / ssl_cutmix (reference config: task/sseg/script/pspnet_pascalvoc_1-8_sslcutmix.py).

The port's copy of ``scripts/pspnet_pascalvoc_1-8_sslcutmix.py``; run it as
``python pixelssl_tpu_torch/scripts/pspnet_pascalvoc_1-8_sslcutmix.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='pspnet', ssl_algorithm='ssl_cutmix', epochs=45,
    sublabeled_ratio='1-8',
    deltas=[('cons_type', 'mse'), ('cons_scale', 20.0),
    ('cons_rampup_epochs', 0), ('cons_threshold', 0.97), ('ema_decay', 0.99),
    ('mask_prop_range', (0.5, 0.5)), ('batch_size', 6),
    ('unlabeled_batch_size', 4),
    ('checkpoint_freq', 5)],
)

if __name__ == '__main__':
    run(config)
