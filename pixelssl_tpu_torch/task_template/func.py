"""Task function hooks (counterpart of
``pixelssl_tpu/task_template/func.py``; reference
pixelssl/task_template/func.py:20-259), as far as the ported algorithms
use them.
"""

import numpy as np
import torch

from ..utils import logger

METRIC_STR = 'metric'


def host_sample(x):
    """A tensor or array on the host as numpy, without a leading batch dim
    of 1 ([1,C,H,W] -> [C,H,W], [1,H,W] labels -> [H,W])."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    if x.ndim == 4 or (x.ndim == 3 and x.shape[0] == 1):
        return x[0]
    return x


class TaskFunc(object):
    METRIC_STR = METRIC_STR

    def __init__(self, args=None):
        self.args = args

    def device_prep(self, batch):
        """Map a batch to the dtypes the task math expects before a train or
        eval step (JAX func.py:29-38). Identity: the port's input path
        hands over float32 images and int64 labels."""
        return batch

    def metrics(self, pred, gt, inp, meters, id_str='', reduce=None):
        """Accumulate task metrics into ``meters`` (reference
        func.py:42-56); ``validate`` reports every key holding
        ``METRIC_STR``. ``reduce``, where given, sums a tensor of counts
        over the ranks before it reaches the meters."""
        raise NotImplementedError

    def visualize(self, out_path, id_str='', inp=None, pred=None, gt=None):
        """Save the first sample's input, prediction and GT as PNGs
        (reference func.py:59-77)."""
        logger.log_err('Task does not implement visualize')

    # hooks for ssl_adv (reference func.py:80-145)

    def ssladv_fcd_in_channels(self):
        """Input channels of the FC discriminator."""
        logger.log_err('Task does not implement ssladv_fcd_in_channels — '
                       'required by the ssl_adv algorithm')

    def ssladv_preprocess_fcd_criterion(self, fcd_pred, task_gt, is_real):
        """(pred, gt) for the discriminator BCE, real or fake."""
        logger.log_err('Task does not implement ssladv_preprocess_fcd_criterion')

    def ssladv_convert_task_gt_to_fcd_input(self, task_gt):
        """The GT encoding fed to the discriminator as its real sample."""
        logger.log_err('Task does not implement ssladv_convert_task_gt_to_fcd_input')

    # hooks for ssl_gct (reference func.py:148-183)

    def sslgct_fd_in_channels(self):
        """Input channels of the flaw detector (task inp ch + pred ch)."""
        logger.log_err('Task does not implement sslgct_fd_in_channels')

    def sslgct_prepare_task_gt_for_fdgt(self, task_gt):
        """Encode GT for the flaw-detector GT generator."""
        logger.log_err('Task does not implement sslgct_prepare_task_gt_for_fdgt')

    # hooks for ssl_s4l (reference func.py:186-202)

    def ssls4l_rc_in_channels(self):
        """Input channels of the rotation classifier."""
        logger.log_err('Task does not implement ssls4l_rc_in_channels')

    # hooks for ssl_cct (reference func.py:216-253)

    def sslcct_activate_ad_preds(self, ad_preds):
        """Activate the auxiliary decoders' predictions."""
        logger.log_err('Task does not implement sslcct_activate_ad_preds')

    def sslcct_ad_in_channels(self):
        logger.log_err('Task does not implement sslcct_ad_in_channels')

    def sslcct_ad_out_channels(self):
        logger.log_err('Task does not implement sslcct_ad_out_channels')

    def sslcct_ad_upsample_scale(self):
        logger.log_err('Task does not implement sslcct_ad_upsample_scale')
