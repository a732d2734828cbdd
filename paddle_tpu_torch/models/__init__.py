"""Models of the port: GPT-2 (:mod:`.gpt`) and its fused serving step
(:mod:`.generation`)."""
from .generation import build_fused_step_fn
from .gpt import GPTBlock, GPTConfig, GPTForPretraining, GPTModel

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForPretraining",
           "build_fused_step_fn"]
