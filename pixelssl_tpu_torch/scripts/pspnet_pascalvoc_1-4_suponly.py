"""PSPNet / PASCAL VOC 1-4 / ssl_null (reference config: task/sseg/script/pspnet_pascalvoc_1-4_suponly.py).

The port's copy of ``scripts/pspnet_pascalvoc_1-4_suponly.py``; run it as
``python pixelssl_tpu_torch/scripts/pspnet_pascalvoc_1-4_suponly.py``.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                '..', '..'))

from pixelssl_tpu_torch.scripts._common import base_config, run  # noqa: E402

config = base_config(
    __file__, model='pspnet', ssl_algorithm='ssl_null', epochs=80,
    sublabeled_ratio='1-4',
    # reference: ImageNet backbone (not COCO) and no published checkpoint —
    # out-of-box TRAINING mode (resume/validation commented out upstream)
    deltas=[('backbone', 'resnet101'), ('resume', ''), ('validation', False)],
)

if __name__ == '__main__':
    run(config)
