"""PSPNet / PASCAL VOC 1-8 / ssl_gct (reference config: task/sseg/script/pspnet_pascalvoc_1-8_sslgct.py).

The port's copy of ``scripts/pspnet_pascalvoc_1-8_sslgct.py``; run it as
``python pixelssl_tpu_torch/scripts/pspnet_pascalvoc_1-8_sslgct.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='pspnet', ssl_algorithm='ssl_gct', epochs=45,
    sublabeled_ratio='1-8',
    deltas=[('ssl_mode', 'gct'), ('fc_ssl_scale', 1.0), ('dc_ssl_scale', 100.0),
    ('dc_threshold', 0.6), ('dc_rampup_epochs', 5), ('fd_lr', 0.0001),
    ('fd_scale', 10.0), ('mu', 0.5), ('nu', 1)],
)

if __name__ == '__main__':
    run(config)
