"""PSPNet / PASCAL VOC 1-8 / ssl_adv (reference config: task/sseg/script/pspnet_pascalvoc_1-8_ssladv.py).

The port's copy of ``scripts/pspnet_pascalvoc_1-8_ssladv.py``; run it as
``python pixelssl_tpu_torch/scripts/pspnet_pascalvoc_1-8_ssladv.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='pspnet', ssl_algorithm='ssl_adv', epochs=45,
    sublabeled_ratio='1-8',
    deltas=[('adv_for_labeled', True), ('labeled_adv_scale', 0.001),
    ('unlabeled_adv_scale', 0.0001), ('discriminator_lr', 0.0001),
    ('unlabeled_for_discriminator', True),
    ('checkpoint_freq', 5)],
)

if __name__ == '__main__':
    run(config)
