"""Metric extensions (port of ``ku/metrics_ext/metrics.py``).

``MeanIoUExt``: mean IoU over one-hot predictions (argmax first), truth
one-hot or integer, accumulated over updates unless ``accum_enable`` is
False. The confusion matrix is a ``torch.bincount`` over ``truth · n +
prediction``; the running total is a float64 numpy array, as in ``ku``.
"""

from __future__ import annotations

import numpy as np
import torch


def _confusion_matrix(y_true, y_pred, num_classes: int, weights=None):
    idx = y_true * num_classes + y_pred
    cm = torch.bincount(idx, weights=weights, minlength=num_classes * num_classes)
    return cm.reshape(num_classes, num_classes)


class MeanIoUExt:
    """Mean IoU over one-hot truth / prediction tensors."""

    def __init__(self, num_classes: int, accum_enable: bool = True,
                 name=None, dtype=None):
        self.num_classes = num_classes
        self.accum_enable = accum_enable
        self.name = name or "mean_iou_ext"
        self.reset_state()

    def reset_state(self):
        self.total_cm = np.zeros((self.num_classes, self.num_classes), np.float64)

    def update_state(self, y_true, y_pred, sample_weight=None):
        """y_true: one-hot or integer labels; y_pred: one-hot vectors."""
        y_pred = torch.as_tensor(y_pred).argmax(dim=-1).reshape(-1)
        y_true = torch.as_tensor(y_true, device=y_pred.device)
        if y_true.dim() > 1 and y_true.shape[-1] == self.num_classes:
            y_true = y_true.argmax(dim=-1)
        y_true = y_true.reshape(-1).long()
        w = None
        if sample_weight is not None:
            w = torch.as_tensor(sample_weight, device=y_pred.device).reshape(-1)
        cm = _confusion_matrix(y_true, y_pred, self.num_classes, w)
        cm = cm.detach().cpu().numpy().astype(np.float64)
        if self.accum_enable:
            self.total_cm += cm
        else:
            self.total_cm = cm
        return self.total_cm

    def result(self) -> float:
        cm = self.total_cm
        sum_over_row = cm.sum(axis=0)
        sum_over_col = cm.sum(axis=1)
        true_pos = np.diag(cm)
        denom = sum_over_row + sum_over_col - true_pos
        valid = denom > 0
        iou = np.where(valid, true_pos / np.maximum(denom, 1e-12), 0.0)
        n_valid = max(valid.sum(), 1)
        return float(iou.sum() / n_valid)

    def __call__(self, y_true, y_pred, sample_weight=None) -> float:
        self.update_state(y_true, y_pred, sample_weight)
        return self.result()
