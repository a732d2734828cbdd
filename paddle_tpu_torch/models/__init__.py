"""Models of the port: GPT-2 (:mod:`.gpt`), its static-cache
``generate`` and its fused serving step (:mod:`.generation`)."""
from .generation import GenerationConfig, build_fused_step_fn, generate
from .gpt import GPTBlock, GPTConfig, GPTForPretraining, GPTModel

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForPretraining",
           "GenerationConfig", "generate", "build_fused_step_fn"]
