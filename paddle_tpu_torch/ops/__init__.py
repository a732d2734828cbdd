"""The port's op tier: the registry (:mod:`.registry`), every op's plain
PyTorch body, one module a JAX op module (:mod:`.math_ops`,
:mod:`.extra_math_ops`, :mod:`.creation_ops`, :mod:`.manipulation_ops`,
:mod:`.linalg_ops`, :mod:`.nn_ops`, :mod:`.extra_nn_ops`,
:mod:`.sequence_ops`, registered on import), and each
hand-written CUDA kernel beside its plain PyTorch version, one module each
(:mod:`.ragged_paged_attention`, :mod:`.layer_norm`,
:mod:`.flash_attention`, :mod:`.fused_adamw`); :mod:`._build` compiles
``csrc/*.cu`` at first use."""
from . import (creation_ops, extra_math_ops, extra_nn_ops,  # noqa: F401
               linalg_ops, manipulation_ops, math_ops, nn_ops,
               sequence_ops)
