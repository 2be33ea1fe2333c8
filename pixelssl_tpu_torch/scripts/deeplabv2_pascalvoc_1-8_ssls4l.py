"""DeepLab-v2 / PASCAL VOC 1-8 / ssl_s4l (reference config: task/sseg/script/deeplabv2_pascalvoc_1-8_ssls4l.py).

The port's copy of ``scripts/deeplabv2_pascalvoc_1-8_ssls4l.py``; run it as
``python pixelssl_tpu_torch/scripts/deeplabv2_pascalvoc_1-8_ssls4l.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='deeplabv2', ssl_algorithm='ssl_s4l', epochs=20,
    sublabeled_ratio='1-8',
    deltas=[('rotated_sup_scale', 0.1), ('rotation_scale', 0.1)],
)

if __name__ == '__main__':
    run(config)
