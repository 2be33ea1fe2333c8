"""PSPNet / PASCAL VOC 1-8 / ssl_s4l (reference config: task/sseg/script/pspnet_pascalvoc_1-8_ssls4l.py).

The port's copy of ``scripts/pspnet_pascalvoc_1-8_ssls4l.py``; run it as
``python pixelssl_tpu_torch/scripts/pspnet_pascalvoc_1-8_ssls4l.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='pspnet', ssl_algorithm='ssl_s4l', epochs=45,
    sublabeled_ratio='1-8',
    # reference ships no pretrained ckpt for this config — TRAINING mode
    deltas=[('rotated_sup_scale', 0.1), ('rotation_scale', 0.1),
    ('resume', ''), ('validation', False)],
)

if __name__ == '__main__':
    run(config)
