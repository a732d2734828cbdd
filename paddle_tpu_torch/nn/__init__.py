"""``nn`` (counterpart of ``paddle_tpu/nn``): the ``Layer`` base and its
containers, the activation, common, convolution, pooling, normalization,
loss, transformer and recurrent layers, beam-search decoding,
``functional``, ``initializer`` and the gradient clips.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP Queue 1 item when reached: ``SyncBatchNorm`` (item 4), and
``nn.utils`` and ``nn.quant`` (item 5)."""
from . import clip, functional, initializer
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .decode import BeamSearchDecoder, dynamic_decode
from .layer.activation import (
    CELU, ELU, GELU, GLU, Hardshrink, Hardsigmoid, Hardswish, Hardtanh,
    LeakyReLU, LogSigmoid, LogSoftmax, Maxout, Mish, PReLU, ReLU, ReLU6,
    RReLU, SELU, Sigmoid, Silu, Softmax, Softmax2D, Softplus, Softshrink,
    Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU,
)
from .layer.common import (
    AlphaDropout, Bilinear, CosineSimilarity, Dropout, Dropout2D, Dropout3D,
    ChannelShuffle, Embedding, Flatten, Fold, Identity, Linear, Pad1D,
    Pad2D, Pad3D, PairwiseDistance, PixelShuffle, PixelUnshuffle, Unfold,
    Upsample, UpsamplingBilinear2D, UpsamplingNearest2D, ZeroPad2D,
)
from .layer.conv import (
    Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
    Conv3DTranspose,
)
from .layer.container import LayerDict, LayerList, ParameterList, Sequential
from .layer.layers import Layer, ParamAttr, set_param_attr
from .layer.loss import (
    BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss, CrossEntropyLoss,
    CTCLoss, HingeEmbeddingLoss, HSigmoidLoss, HuberLoss, KLDivLoss, L1Loss, MarginRankingLoss,
    MSELoss, MultiLabelSoftMarginLoss, NLLLoss, SigmoidFocalLoss,
    SmoothL1Loss, TripletMarginLoss, TripletMarginWithDistanceLoss,
)
from .layer.norm import (
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SpectralNorm,
)
from .layer.pooling import (
    AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D, MaxPool3D, MaxUnPool1D,
    MaxUnPool2D, MaxUnPool3D,
)
from .layer.rnn import (
    BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNN, RNNCellBase, SimpleRNN,
    SimpleRNNCell,
)
from .layer.transformer import (
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from ..ops.registry import not_ported as _not_ported

#: the JAX package's ``nn`` names not ported yet, by ROADMAP Queue 1 item
_DEFERRED = {"SyncBatchNorm": 4}


#: imported at first use (``nn.quant`` imports ``quantization``, which
#: imports this package)
_LAZY = ("utils", "quant")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    if name in _DEFERRED:
        raise _not_ported(f"nn.{name}", _DEFERRED[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [n for n in dir() if not n.startswith("_")
           and n not in ("clip_grad",)]
