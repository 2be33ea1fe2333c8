"""Confusion matrix on the device and segmentation scores on the host
(counterpart of ``pixelssl_tpu/ops/confusion.py``; reference
task/sseg/func.py:36-80).

The matrix is one ``torch.bincount`` over ``gt * C + pred`` on the tensor's
device; only the C x C counts cross to the host, where the scores are
computed in float64 numpy.
"""

import numpy as np
import torch


def confusion_matrix(pred, gt, num_classes, ignore_index=255):
    """[C, C] int64 counts, rows = gt, cols = pred, from integer class maps
    of one shape. Pixels whose gt lies outside [0, C) or equals
    ``ignore_index`` are dropped (reference mask ``(gt >= 0) & (gt < C)``,
    func.py:41-44)."""
    pred = pred.reshape(-1).long()
    gt = gt.reshape(-1).long()
    valid = (gt >= 0) & (gt < num_classes) & (gt != ignore_index)
    n_bins = num_classes * num_classes
    idx = torch.where(valid, gt * num_classes +
                      pred.clamp(0, num_classes - 1), n_bins)
    counts = torch.bincount(idx, minlength=n_bins + 1)
    return counts[:n_bins].reshape(num_classes, num_classes)


def scores_from_confusion(cm):
    """acc / acc_class / mIoU / fwIoU of a summed confusion matrix
    (reference func.py:45-80); classes absent from gt and pred are left out
    of the means."""
    cm = np.asarray(cm, dtype=np.float64)
    eps = 1e-12
    total = cm.sum()
    acc = np.diag(cm).sum() / (total + eps)
    with np.errstate(divide='ignore', invalid='ignore'):
        acc_cls = np.diag(cm) / cm.sum(axis=1)
        iou = np.diag(cm) / (cm.sum(axis=1) + cm.sum(axis=0) - np.diag(cm))
    freq = cm.sum(axis=1) / (total + eps)
    return {
        'acc': float(acc),
        'acc_class': float(np.nanmean(acc_cls)),
        'mIoU': float(np.nanmean(iou)),
        'fwIoU': float((freq[freq > 0] * iou[freq > 0]).sum()),
    }
