"""The port's op tier: the registry (:mod:`.registry`), the plain bodies
of the ops the GPT path runs (:mod:`.creation_ops`,
:mod:`.manipulation_ops`, :mod:`.math_ops`, :mod:`.nn_ops`, registered on
import), and each hand-written CUDA kernel beside its plain PyTorch
version, one module each (:mod:`.ragged_paged_attention`,
:mod:`.layer_norm`, :mod:`.flash_attention`, :mod:`.fused_adamw`);
:mod:`._build` compiles ``csrc/*.cu`` at first use."""
from . import creation_ops, manipulation_ops, math_ops, nn_ops  # noqa: F401
