"""``incubate`` (counterpart of ``paddle_tpu/incubate``): the fused
transformer layers (``nn``), mixture of experts (``moe``), automatic
sparsity (``asp``), ``LookAhead``/``ModelAverage`` (``optimizer``), the
graph ops, the functional autodiff API (``autograd``) and the autotune
switches."""
from . import asp, autograd, autotune, moe, nn, optimizer  # noqa: F401
from .graph_ops import (  # noqa: F401
    graph_khop_sampler, graph_reindex, graph_sample_neighbors,
    graph_send_recv, segment_max, segment_mean, segment_min, segment_sum,
    softmax_mask_fuse, softmax_mask_fuse_upper_triangle,
)
from .moe import MoELayer  # noqa: F401
from .optimizer import LookAhead, ModelAverage  # noqa: F401
