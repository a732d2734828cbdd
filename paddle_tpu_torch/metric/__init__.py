"""Training metrics (counterpart of ``paddle_tpu/metric``; the port's
own copy): ``Metric``, ``Accuracy`` (top-k), ``Precision``, ``Recall``,
``Auc`` (ROC over ``num_thresholds`` buckets) and ``accuracy``.

Metrics accumulate on the host in numpy. ``Model`` calls
``compute(*outputs, *labels)`` and then ``update`` on each batch's
outputs; a torch tensor is read back to the host there (16-bit floats
widened to float32 first, as numpy has no bfloat16).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype in (torch.bfloat16, torch.float16)
                else x).cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        """Pre-processing of a step's outputs and labels before
        ``update``; the identity by default."""
        return args


class Accuracy(Metric):
    def __init__(self, topk=(1,), name=None):
        self.topk = topk if isinstance(topk, (list, tuple)) else (topk,)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label, *args):
        pred = _np(pred)
        label = _np(label)
        idx = np.argsort(-pred, axis=-1)[..., : self.maxk]
        if label.ndim == pred.ndim:  # one-hot / [N,1] sparse
            if label.shape[-1] == 1:
                label = label[..., 0]
            else:
                label = label.argmax(-1)
        return (idx == label[..., None]).astype(np.float32)

    def update(self, correct, *args):
        correct = _np(correct)
        accs = []
        for k in self.topk:
            num = correct[..., :k].sum()
            accs.append(num / max(1, correct.shape[0]))
            self.total[self.topk.index(k)] += num
        self.count += correct.shape[0]
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / max(1, self.count) for t in self.total]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    def __init__(self, name="precision"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_np(preds) > 0.5).astype(np.int32).reshape(-1)
        labels = _np(labels).astype(np.int32).reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """Histogram-bucketed ROC AUC (reference metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        self._name = name
        self.num_thresholds = num_thresholds
        self.reset()

    def update(self, preds, labels):
        preds = _np(preds)
        labels = _np(labels).reshape(-1)
        if preds.ndim == 2:  # [N,2] class probs -> positive prob
            preds = preds[:, -1]
        preds = preds.reshape(-1)
        buckets = np.clip(
            (preds * self.num_thresholds).astype(np.int64), 0,
            self.num_thresholds)
        for b, l in zip(buckets, labels):
            if l:
                self._stat_pos[b] += 1
            else:
                self._stat_neg[b] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        # walk thresholds high->low accumulating trapezoids
        for i in range(self.num_thresholds, -1, -1):
            new_pos = tot_pos + self._stat_pos[i]
            new_neg = tot_neg + self._stat_neg[i]
            auc += (new_pos + tot_pos) * self._stat_neg[i] / 2.0
            tot_pos, tot_neg = new_pos, new_neg
        if tot_pos == 0 or tot_neg == 0:
            return 0.0
        return auc / tot_pos / tot_neg

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Functional top-k accuracy."""
    m = Accuracy(topk=(k,))
    correct = m.compute(input, label)
    m.update(correct)
    return m.accumulate()
