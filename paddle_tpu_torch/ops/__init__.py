"""The port's kernel tier: each hand-written CUDA kernel beside its plain
PyTorch version, one module each (:mod:`.ragged_paged_attention`,
:mod:`.layer_norm`); :mod:`._build` compiles ``csrc/*.cu`` at first
use."""
