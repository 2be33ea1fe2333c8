"""Task function hooks (counterpart of
``pixelssl_tpu/task_template/func.py``; reference
pixelssl/task_template/func.py:20-259), as far as the ported algorithms
use them.
"""

from ..utils import logger

METRIC_STR = 'metric'


class TaskFunc(object):
    METRIC_STR = METRIC_STR

    def __init__(self, args=None):
        self.args = args

    def device_prep(self, batch):
        """Map a batch to the dtypes the task math expects before a train or
        eval step (JAX func.py:29-38). Identity: the port's input path
        hands over float32 images and int64 labels."""
        return batch

    def metrics(self, pred, gt, inp, meters, id_str=''):
        """Accumulate task metrics into ``meters`` (reference
        func.py:42-56); ``validate`` reports every key holding
        ``METRIC_STR``."""
        raise NotImplementedError

    # hooks for ssl_gct (reference func.py:148-183)

    def sslgct_fd_in_channels(self):
        """Input channels of the flaw detector (task inp ch + pred ch)."""
        logger.log_err('Task does not implement sslgct_fd_in_channels')

    def sslgct_prepare_task_gt_for_fdgt(self, task_gt):
        """Encode GT for the flaw-detector GT generator."""
        logger.log_err('Task does not implement sslgct_prepare_task_gt_for_fdgt')
