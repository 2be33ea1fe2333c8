"""Semantic-segmentation task hooks (counterpart of
``pixelssl_tpu/tasks/sseg/func.py``): the validation metrics (reference
task/sseg/func.py:36-80) and the AdvSSL, GCT, S4L and CCT hooks (JAX
func.py:126-152,180-207). The maps are NCHW: a one-hot GT is [N,C,H,W] and
a discriminator's confidence map [N,1,H,W], where the JAX hooks take and
give NHWC.

``metrics`` builds the confusion matrix on the device; only the C x C
counts cross to the host. ``device_prep`` normalises ``--u8-transfer``
batches on the card. ``visualize`` and ``visualize_pseudo_gt`` (JAX
func.py:89-120,165-174) write PNGs through ``nn.imageio.write_png`` with
the JAX arithmetic: the image ``im * std + mean`` (a uint8 one / 255),
clipped, ``(x * 255).astype(uint8)``, which truncates; the prediction's
and the GT's classes coloured by ``VOCColorize``. The JAX package writes
the GT of a [1,H,W] label batch as a 1 x H image of its first column
(ROADMAP F12); the port writes the whole [H,W] map.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ...nn import imageio
from ...ops.confusion import confusion_matrix, scores_from_confusion
from ...task_template import func_template
from ...utils import logger
from . import data


def task_func():
    return SemanticSegmentationFunc


@functools.lru_cache(maxsize=None)
def _mean_std(device):
    """``data.VOC_MEAN`` and ``VOC_STD`` as [3,1,1] float32 tensors on
    ``device``, copied there once: a captured step copies nothing from the
    host."""
    return tuple(torch.tensor(v, dtype=torch.float32, device=device)[:, None,
                                                                      None]
                 for v in (data.VOC_MEAN, data.VOC_STD))


class SemanticSegmentationFunc(func_template.TaskFunc):
    def __init__(self, args=None):
        super(SemanticSegmentationFunc, self).__init__(args)
        self._colorize = VOCColorize(
            (args.num_classes if args is not None else 21) + 1)

    def device_prep(self, batch):
        """The ``--u8-transfer`` batch made what the algorithms take (JAX
        func.py:48-65): uint8 images normalised on the device with the host
        path's mean and std (``data.normalize_image``), uint8/int8/int16
        labels widened to int64. Other batches pass through unchanged."""
        inp, gt = batch['inp'], batch['gt']
        x = inp[0]
        if x.dtype == torch.uint8:
            mean, std = _mean_std(x.device)
            inp = ((x.float() / 255.0 - mean) / std,) + tuple(inp[1:])
        g = gt[0]
        if g.dtype in (torch.uint8, torch.int8, torch.int16):
            gt = (g.long(),) + tuple(gt[1:])
        if inp is batch['inp'] and gt is batch['gt']:
            return batch
        return dict(batch, inp=inp, gt=gt)

    def metrics(self, pred, gt, inp, meters, id_str='', reduce=None):
        """Add this batch's confusion matrix (summed over the ranks by
        ``reduce`` where given) to the meter ``{id}_confusion_matrix``;
        the ``{id}_metric_*`` meters then hold the scores of the summed
        matrix (reference func.py:36-80)."""
        if len(pred) != 1 or len(gt) != 1:
            raise ValueError('sseg metrics take one prediction and one gt')
        gt0 = gt[0]
        if gt0.dim() == 4:
            gt0 = gt0[:, 0]
        cm = confusion_matrix(pred[0].argmax(dim=1), gt0,
                              self.args.num_classes, self.args.ignore_index)
        if reduce is not None:
            cm = reduce(cm)

        cm_key = '{0}_confusion_matrix'.format(id_str)
        meters.update(cm_key, cm.cpu().numpy())
        scores = scores_from_confusion(meters[cm_key].sum)
        for name in ('acc', 'acc_class', 'mIoU', 'fwIoU'):
            key = '{0}_{1}_{2}'.format(id_str, self.METRIC_STR, name)
            meters.reset(key)
            meters.update(key, scores[name])

    def visualize(self, out_path, id_str='', inp=None, pred=None, gt=None):
        """``<out_path>_<id>1-inp.png``, ``2-pred`` and ``3-gt`` of the
        first sample: NCHW tensors (a batch of 1) or unbatched arrays
        (reference func.py:82-131)."""
        if inp is not None:
            im = func_template.host_sample(inp[0]).transpose(1, 2, 0)
            if im.dtype == np.uint8:  # --u8-transfer: raw RGB
                im = im / 255.0
            else:
                im = im * np.array([0.229, 0.224, 0.225]) + np.array(
                    [0.485, 0.456, 0.406])
            im = np.clip(im, 0, 1)
            imageio.write_png(out_path + '_{0}1-inp.png'.format(id_str),
                              (im * 255).astype('uint8'))
        if pred is not None:
            p = np.argmax(func_template.host_sample(pred[0]), axis=0)
            imageio.write_png(out_path + '_{0}2-pred.png'.format(id_str),
                              self._colorize(p))
        if gt is not None:
            g = func_template.host_sample(gt[0])
            if g.ndim == 3:  # [1,H,W]
                g = g[0]
            imageio.write_png(out_path + '_{0}3-gt.png'.format(id_str),
                              self._colorize(g))

    def visualize_pseudo_gt(self, pseudo_gt, out_path, id_str=''):
        """The coloured argmax of a GCT dynamic-consistency pseudo-GT,
        [1,H,W,C] (the GCT pipeline's NHWC), as
        ``<out_path>_<id>-pseudo-gt.png`` (reference func.py:196-202)."""
        p = func_template.host_sample(pseudo_gt)
        imageio.write_png(out_path + '_{0}-pseudo-gt.png'.format(id_str),
                          self._colorize(np.argmax(p, axis=-1)))

    def ssladv_fcd_in_channels(self):
        return self.args.num_classes

    def ssladv_preprocess_fcd_criterion(self, fcd_pred, task_gt, is_real):
        """(masked logits, target) for the discriminator's BCE:
        ``fcd_pred`` [N,1,H,W], ``task_gt`` [N,H,W] labels or None. Both
        are zero on ``ignore_index`` pixels, so the BCE counts each of them
        as log 2, as the JAX hook does."""
        if task_gt is None:
            mask = torch.ones_like(fcd_pred)
        else:
            mask = (task_gt != self.args.ignore_index)[:, None].to(
                fcd_pred.dtype)
        fcd_gt = torch.full_like(fcd_pred, 1.0 if is_real else 0.0) * mask
        return fcd_pred * mask, fcd_gt

    def ssladv_convert_task_gt_to_fcd_input(self, task_gt):
        """[N,H,W] labels -> [N,C,H,W] float32 one-hot, the
        discriminator's real sample. A label outside [0, C), such as
        ``ignore_index``, gives an all-zero pixel, as ``jax.nn.one_hot``
        does (``F.one_hot`` would raise on it)."""
        return self._one_hot(task_gt).permute(0, 3, 1, 2)

    def _one_hot(self, task_gt, keep=None):
        """[N,H,W] labels -> [N,H,W,C] float32 one-hot, zero where the
        label is outside [0, C) or ``keep`` is False."""
        num_classes = self.args.num_classes
        valid = (task_gt >= 0) & (task_gt < num_classes)
        if keep is not None:
            valid = valid & keep
        safe = torch.where(valid, task_gt, torch.zeros_like(task_gt)).long()
        return F.one_hot(safe, num_classes).float() * valid[..., None].float()

    def sslgct_fd_in_channels(self):
        return self.args.num_classes + 3

    def sslgct_prepare_task_gt_for_fdgt(self, task_gt):
        """[N,H,W] labels -> [N,H,W,C] float32 one-hot (NHWC, as the JAX
        hook returns it). Rows at ``ignore_index``, and any label outside
        [0, C), are all zero."""
        return self._one_hot(task_gt, task_gt != self.args.ignore_index)

    def ssls4l_rc_in_channels(self):
        return self.args.num_classes

    def sslcct_activate_ad_preds(self, ad_preds):
        return [torch.softmax(p, dim=1) for p in ad_preds]

    def sslcct_ad_in_channels(self):
        """The latent's channels: PSPNet's PSP output, DeepLab-v2's
        backbone feature."""
        arch = self.args.models['model']
        if arch == 'pspnet':
            return 512
        if arch == 'deeplabv2':
            return 2048
        logger.log_err('sslcct_ad_in_channels does not support model '
                       '`{0}`'.format(arch))

    def sslcct_ad_out_channels(self):
        return self.args.num_classes

    def sslcct_ad_upsample_scale(self):
        arch = self.args.models['model']
        if arch in ('pspnet', 'deeplabv2'):
            return 8
        logger.log_err('sslcct_ad_upsample_scale does not support model '
                       '`{0}`'.format(arch))


# ---------------------------------------------------------------------------
# VOC colormap (reference func.py:306-345, JAX func.py:243-276)
# ---------------------------------------------------------------------------

def color_map(N=256, normalized=False):
    def bitget(byteval, idx):
        return (byteval & (1 << idx)) != 0

    dtype = 'float32' if normalized else 'uint8'
    cmap = np.zeros((N, 3), dtype=dtype)
    for i in range(N):
        r = g = b = 0
        c = i
        for j in range(8):
            r = r | (bitget(c, 0) << (7 - j))
            g = g | (bitget(c, 1) << (7 - j))
            b = b | (bitget(c, 2) << (7 - j))
            c = c >> 3
        cmap[i] = np.array([r, g, b])
    return cmap / 255 if normalized else cmap


class VOCColorize(object):
    def __init__(self, n=22):
        self.cmap = color_map(256)[:n]

    def __call__(self, gray_image):
        """int [H,W] -> uint8 [H,W,3]; 255 (void) renders white."""
        gray = np.asarray(gray_image).astype(np.int32)
        out = np.zeros(gray.shape + (3,), dtype=np.uint8)
        for label in range(len(self.cmap)):
            out[gray == label] = self.cmap[label]
        out[gray == 255] = 255
        return out
