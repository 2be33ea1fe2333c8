"""Task function hooks (counterpart of
``pixelssl_tpu/task_template/func.py``; reference
pixelssl/task_template/func.py:20-259), as far as GCT uses them.
"""

from ..utils import logger

METRIC_STR = 'metric'


class TaskFunc(object):
    METRIC_STR = METRIC_STR

    def __init__(self, args=None):
        self.args = args

    # hooks for ssl_gct (reference func.py:148-183)

    def sslgct_fd_in_channels(self):
        """Input channels of the flaw detector (task inp ch + pred ch)."""
        logger.log_err('Task does not implement sslgct_fd_in_channels')

    def sslgct_prepare_task_gt_for_fdgt(self, task_gt):
        """Encode GT for the flaw-detector GT generator."""
        logger.log_err('Task does not implement sslgct_prepare_task_gt_for_fdgt')
