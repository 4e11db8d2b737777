"""Metrics (counterpart of ``paddle_tpu/metric/__init__.py``, Paddle's
``paddle.metric``): ``Accuracy`` (top-k), ``Precision``, ``Recall``,
``Auc`` and ``accuracy``. They accumulate on the host in numpy, as the
reference's do: ``compute`` reads a batch's predictions and labels back
once (a tensor on any device, or an array) and ``update`` /
``accumulate`` work on what it returns."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return np.asarray(x)


class Metric:
    def __init__(self, name=None):
        self._name = name or self.__class__.__name__.lower()

    def name(self):
        return self._name

    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def compute(self, *args):
        """A pre-computation on the model's outputs; by default the
        predictions and labels pass through."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        super().__init__(name or "acc")
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        """``[N, maxk]`` float32: whether each of the top ``maxk``
        predictions is the label."""
        pred_np = _np(pred)
        label_np = _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        top = np.argsort(-pred_np, axis=-1)[..., :self.maxk]
        return (top == label_np[..., None]).astype(np.float32)

    def update(self, correct, *args):
        correct = _np(correct)
        num = correct.shape[0] if correct.ndim else 1
        for i, k in enumerate(self.topk):
            acc_k = correct[..., :k].sum(-1).mean() if correct.ndim else \
                float(correct)
            self.total[i] += float(acc_k) * num
            self.count[i] += num
        return self.accumulate()

    def accumulate(self):
        res = [t / c if c else 0.0 for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision of ``preds > 0.5`` against 0 / 1 labels."""

    def __init__(self, name=None):
        super().__init__(name or "precision")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fp += int(((p == 1) & (lab == 0)).sum())

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0


class Recall(Metric):
    """Binary recall of ``preds > 0.5`` against 0 / 1 labels."""

    def __init__(self, name=None):
        super().__init__(name or "recall")
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = (_np(preds) > 0.5).astype(np.int64).reshape(-1)
        lab = _np(labels).astype(np.int64).reshape(-1)
        self.tp += int(((p == 1) & (lab == 1)).sum())
        self.fn += int(((p == 0) & (lab == 1)).sum())

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0


class Auc(Metric):
    """ROC AUC over ``num_thresholds + 1`` score bins (a ``[N, 2]``
    prediction's second column is the positive score), by the
    trapezoid rule over descending thresholds."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        super().__init__(name or "auc")
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        pos_prob = preds[:, 1] if preds.ndim == 2 else preds.reshape(-1)
        bins = np.clip(np.round(pos_prob * self.num_thresholds)
                       .astype(np.int64), 0, self.num_thresholds)
        np.add.at(self._stat_pos, bins[labels != 0], 1)
        np.add.at(self._stat_neg, bins[labels == 0], 1)

    def accumulate(self):
        tot_pos = self._stat_pos.sum()
        tot_neg = self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        tpr = np.cumsum(self._stat_pos[::-1]) / tot_pos
        fpr = np.cumsum(self._stat_neg[::-1]) / tot_neg
        return float(np.trapezoid(tpr, fpr))


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top ``k`` predictions,
    a float32 scalar tensor."""
    pred = _np(input)
    lab = _np(label).reshape(-1)
    top = np.argsort(-pred, axis=-1)[:, :k]
    hit = (top == lab[:, None]).any(axis=1)
    return torch.tensor(np.asarray(hit.mean(), np.float32))
