"""Loss layers (counterpart of ``paddle_tpu/nn/layer/loss.py``): thin
``Layer`` wrappers over ``nn.functional``'s losses; ``HSigmoidLoss``
holds the ``[num_classes - 1, feature_size]`` weights of the tree's
internal nodes."""
from __future__ import annotations

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "NLLLoss", "BCELoss",
           "BCEWithLogitsLoss", "KLDivLoss", "SmoothL1Loss", "HuberLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "SigmoidFocalLoss",
           "CosineEmbeddingLoss", "CTCLoss", "HSigmoidLoss",
           "TripletMarginLoss", "TripletMarginWithDistanceLoss",
           "MultiLabelSoftMarginLoss"]


class CrossEntropyLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True,
                 label_smoothing=0.0, name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction
        self._soft_label = soft_label
        self._axis = axis
        self._use_softmax = use_softmax
        self._label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(
            input, label, weight=self._weight,
            ignore_index=self._ignore_index, reduction=self._reduction,
            soft_label=self._soft_label, axis=self._axis,
            use_softmax=self._use_softmax,
            label_smoothing=self._label_smoothing)


class MSELoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self._reduction)


class L1Loss(Layer):
    def __init__(self, reduction="mean", name=None):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.l1_loss(input, label, self._reduction)


class NLLLoss(Layer):
    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__()
        self._weight = weight
        self._ignore_index = ignore_index
        self._reduction = reduction

    def forward(self, input, label):
        return F.nll_loss(input, label, self._weight, self._ignore_index,
                          self._reduction)


class BCELoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction

    def forward(self, input, label):
        return F.binary_cross_entropy(input, label, self._weight,
                                      self._reduction)


class BCEWithLogitsLoss(Layer):
    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__()
        self._weight = weight
        self._reduction = reduction
        self._pos_weight = pos_weight

    def forward(self, logit, label):
        return F.binary_cross_entropy_with_logits(
            logit, label, self._weight, self._reduction, self._pos_weight)


class KLDivLoss(Layer):
    def __init__(self, reduction="mean"):
        super().__init__()
        self._reduction = reduction

    def forward(self, input, label):
        return F.kl_div(input, label, self._reduction)


class SmoothL1Loss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.smooth_l1_loss(input, label, self._reduction, self._delta)


class HuberLoss(Layer):
    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__()
        self._reduction = reduction
        self._delta = delta

    def forward(self, input, label):
        return F.huber_loss(input, label, self._delta, self._reduction)


class MarginRankingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, other, label):
        return F.margin_ranking_loss(input, other, label, self._margin,
                                     self._reduction)


class HingeEmbeddingLoss(Layer):
    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__()
        self._margin = margin
        self._reduction = reduction

    def forward(self, input, label):
        return F.hinge_embedding_loss(input, label, self._margin,
                                      self._reduction)


class SigmoidFocalLoss(Layer):
    def __init__(self, alpha=0.25, gamma=2.0, normalizer=None,
                 reduction="sum", name=None):
        super().__init__()
        self._alpha = alpha
        self._gamma = gamma
        self._normalizer = normalizer
        self._reduction = reduction

    def forward(self, logit, label):
        return F.sigmoid_focal_loss(logit, label, self._normalizer,
                                    self._alpha, self._gamma,
                                    self._reduction)


class CosineEmbeddingLoss(Layer):
    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__()
        self._margin, self._reduction = margin, reduction

    def forward(self, input1, input2, label):
        return F.cosine_embedding_loss(input1, input2, label, self._margin,
                                       self._reduction)


class TripletMarginLoss(Layer):
    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (margin, p, epsilon, swap, reduction)

    def forward(self, input, positive, negative):
        m, p, e, s, r = self._a
        return F.triplet_margin_loss(input, positive, negative, m, p, e, s, r)


class TripletMarginWithDistanceLoss(Layer):
    def __init__(self, distance_function=None, margin=1.0, swap=False,
                 reduction="mean", name=None):
        super().__init__()
        self._a = (distance_function, margin, swap, reduction)

    def forward(self, input, positive, negative):
        d, m, s, r = self._a
        return F.triplet_margin_with_distance_loss(
            input, positive, negative, d, m, s, r)


class MultiLabelSoftMarginLoss(Layer):
    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__()
        self._weight, self._reduction = weight, reduction

    def forward(self, input, label):
        return F.multi_label_soft_margin_loss(input, label, self._weight,
                                              self._reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self._blank = blank
        self._reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self._blank, self._reduction, norm_by_times)


class HSigmoidLoss(Layer):
    """The hierarchical sigmoid over the default (SimpleCode) tree, or a
    custom one given to ``forward`` as ``path_table``/``path_code``."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None):
        super().__init__()
        self._num_classes = num_classes
        n_nodes = num_classes - 1
        self.weight = self.create_parameter(
            [n_nodes, feature_size], attr=weight_attr)
        self.bias = self.create_parameter(
            [n_nodes], attr=bias_attr, is_bias=True)

    def forward(self, input, label, path_table=None, path_code=None):
        return F.hsigmoid_loss(input, label, self._num_classes, self.weight,
                               self.bias, path_table, path_code)
