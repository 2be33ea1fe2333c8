"""PSPNet / PASCAL VOC 1-8 / ssl_mt (reference config: task/sseg/script/pspnet_pascalvoc_1-8_sslmt.py).

The port's copy of ``scripts/pspnet_pascalvoc_1-8_sslmt.py``; run it as
``python pixelssl_tpu_torch/scripts/pspnet_pascalvoc_1-8_sslmt.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='pspnet', ssl_algorithm='ssl_mt', epochs=45,
    sublabeled_ratio='1-8',
    deltas=[('cons_for_labeled', False), ('cons_scale', 1.0),
    ('cons_rampup_epochs', 5), ('ema_decay', 0.99),
    ('checkpoint_freq', 5)],
)

if __name__ == '__main__':
    run(config)
