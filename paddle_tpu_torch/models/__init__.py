"""Models of the port: GPT-2 (:mod:`.gpt`), its static-cache
``generate`` and its serving steps (:mod:`.generation`), BERT
(:mod:`.bert`) and the encoder-decoder ``TransformerModel``
(:mod:`.seq2seq`, decoding in :mod:`.seq2seq_decode`)."""
from .bert import (BertConfig, BertForMaskedLM, BertForQuestionAnswering,
                   BertForSequenceClassification, BertModel)
from .generation import (GenerationConfig, build_fused_step_fn, generate,
                         save_for_serving)
from .gpt import GPTBlock, GPTConfig, GPTForPretraining, GPTModel
from .seq2seq import TransformerModel

__all__ = ["GPTConfig", "GPTBlock", "GPTModel", "GPTForPretraining",
           "GenerationConfig", "generate", "save_for_serving",
           "build_fused_step_fn",
           "BertConfig", "BertModel", "BertForQuestionAnswering",
           "BertForMaskedLM", "BertForSequenceClassification",
           "TransformerModel"]
