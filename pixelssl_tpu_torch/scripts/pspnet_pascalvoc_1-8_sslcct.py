"""PSPNet / PASCAL VOC 1-8 / ssl_cct (reference config: task/sseg/script/pspnet_pascalvoc_1-8_sslcct.py).

The port's copy of ``scripts/pspnet_pascalvoc_1-8_sslcct.py``; run it as
``python pixelssl_tpu_torch/scripts/pspnet_pascalvoc_1-8_sslcct.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='pspnet', ssl_algorithm='ssl_cct', epochs=45,
    sublabeled_ratio='1-8',
    deltas=[('cons_scale', 30.0), ('cons_rampup_epochs', 5),
    ('ad_lr_scale', 10.0), ('vat_dec_num', 1), ('drop_dec_num', 2),
    ('cut_dec_num', 2), ('context_dec_num', 1), ('object_dec_num', 1),
    ('fn_dec_num', 2), ('fd_dec_num', 2),
    ('checkpoint_freq', 5)],
)

if __name__ == '__main__':
    run(config)
