"""Pixel-regression task hooks (counterpart of
``pixelssl_tpu/tasks/sreg/func.py``): the REGRESSION instance of the hooks
that ``tasks/sseg/func.py`` gives CLASSIFICATION, each one-hot encoding
of sseg the identity on the dense float map.

* ``metrics`` sums ``(squared error, absolute error, valid pixels)`` of a
  batch on the device into one meter, and publishes the exact MSE, MAE and
  PSNR (peak 1) of everything summed so far; GT pixels at
  ``--ignore-index`` (validation padding) are left out;
* AdvSSL: the discriminator sees the [N,1,H,W] map, prediction or GT,
  against a plain real/fake target;
* GCT: the flaw detector's GT compares the sigmoid prediction with the
  float GT (NHWC, as ``sslgct_prepare_task_gt_for_fdgt`` gives it for
  sseg); the detector reads the map and the RGB input;
* S4L: the rotation head reads the latent, 4 x ``--base-channels``.

``visualize`` and ``visualize_pseudo_gt`` (JAX func.py:75-91,122-130)
write the input clipped to [0, 1] and the maps as 8-bit gray PNGs
(``(clip(x, 0, 1) * 255).astype(uint8)``). CCT supports CLASSIFICATION
only and has no hooks here.
"""

import math

import numpy as np
import torch

from ...nn import imageio
from ...task_template import func_template


def task_func():
    return PixelRegressionFunc


class PixelRegressionFunc(func_template.TaskFunc):
    def metrics(self, pred, gt, inp, meters, id_str='', reduce=None):
        if len(pred) != 1 or len(gt) != 1:
            raise ValueError('sreg metrics take one prediction and one gt')
        p, g = pred[0].float(), gt[0].float()
        valid = (g != float(self.args.ignore_index)).float()
        diff = (p - g) * valid
        sums = torch.stack([diff.square().sum(), diff.abs().sum(),
                            valid.sum()])
        if reduce is not None:
            sums = reduce(sums)
        sums = sums.cpu().numpy()

        sums_key = '{0}_err_sums'.format(id_str)
        meters.update(sums_key, sums)
        sq, ab, count = (float(v) for v in meters[sums_key].sum)
        count = max(count, 1.0)
        mse = sq / count
        scores = {'mse': mse, 'mae': ab / count,
                  'psnr': 10.0 * math.log10(1.0 / max(mse, 1e-12))}
        for name, value in scores.items():
            key = '{0}_{1}_{2}'.format(id_str, self.METRIC_STR, name)
            meters.reset(key)
            meters.update(key, value)

    def visualize(self, out_path, id_str='', inp=None, pred=None, gt=None):
        """Input RGB and gray prediction/GT PNGs of the first sample: NCHW
        tensors (a batch of 1) or unbatched arrays."""
        def gray(x):
            x = np.clip(func_template.host_sample(x)[0], 0.0, 1.0)
            return (x * 255).astype('uint8')

        if inp is not None:
            im = func_template.host_sample(inp[0]).transpose(1, 2, 0)
            im = np.clip(im, 0.0, 1.0)
            imageio.write_png(out_path + '_{0}1-inp.png'.format(id_str),
                              (im * 255).astype('uint8'))
        if pred is not None:
            imageio.write_png(out_path + '_{0}2-pred.png'.format(id_str),
                              gray(pred[0]))
        if gt is not None:
            imageio.write_png(out_path + '_{0}3-gt.png'.format(id_str),
                              gray(gt[0]))

    def visualize_pseudo_gt(self, pseudo_gt, out_path, id_str=''):
        """A GCT pseudo-GT [1,H,W,1] (NHWC) as a gray PNG."""
        p = np.clip(func_template.host_sample(pseudo_gt)[..., 0], 0.0, 1.0)
        imageio.write_png(out_path + '_{0}-pseudo-gt.png'.format(id_str),
                          (p * 255).astype('uint8'))

    def ssladv_fcd_in_channels(self):
        return 1

    def ssladv_preprocess_fcd_criterion(self, fcd_pred, task_gt, is_real):
        """No ignore regions in training: the plain real/fake target."""
        return fcd_pred, torch.full_like(fcd_pred, 1.0 if is_real else 0.0)

    def ssladv_convert_task_gt_to_fcd_input(self, task_gt):
        return task_gt.float()

    def sslgct_fd_in_channels(self):
        return 1 + 3

    def sslgct_prepare_task_gt_for_fdgt(self, task_gt):
        """[N,1,H,W] -> [N,H,W,1] float32."""
        return task_gt.float().permute(0, 2, 3, 1)

    def ssls4l_rc_in_channels(self):
        return 4 * self.args.base_channels
