"""BERT (counterpart of ``paddle_tpu/models/bert.py``): the encoder and its
question-answering, masked-LM and sequence-classification heads, built
from the port's ``nn`` alone.

The encoder is ``nn.TransformerEncoder`` over post-norm
``TransformerEncoderLayer(activation="gelu")``s, so every LayerNorm runs
the fused LayerNorm kernels on the card (K2, and K3 as its gradient) and
an unmasked attention without attention dropout the flash kernels (K4,
K6 as its gradient). A 2-D ``[B, L]`` padding mask becomes an additive
``[B, 1, 1, L]`` one (``-1e9`` where it drops), and masked attention
runs the op's plain body, as in the JAX package. ``position_ids`` and
``token_type_ids`` default to tensors made on the ids' device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import nn
from ..framework.dispatch import call_op
from ..nn import functional as F

__all__ = ["BertConfig", "BertEmbeddings", "BertModel",
           "BertForQuestionAnswering", "BertForSequenceClassification",
           "BertForMaskedLM"]


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_dropout_prob: float = 0.1
    initializer_range: float = 0.02

    @classmethod
    def bert_base(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=128, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=2, intermediate_size=64,
                   max_position_embeddings=32, hidden_dropout_prob=0.0,
                   attention_dropout_prob=0.0)


class BertEmbeddings(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        attr = nn.ParamAttr(initializer=nn.initializer.Normal(
            0.0, cfg.initializer_range))
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                            weight_attr=attr)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size, weight_attr=attr)
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size, weight_attr=attr)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids=None, position_ids=None):
        seq = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(seq, dtype=torch.int64,
                                        device=input_ids.device)[None, :]
        if token_type_ids is None:
            token_type_ids = torch.zeros((input_ids.shape[0], seq),
                                         dtype=torch.int64,
                                         device=input_ids.device)
        x = self.word_embeddings(input_ids) + \
            self.position_embeddings(position_ids) + \
            self.token_type_embeddings(token_type_ids)
        return self.dropout(self.layer_norm(x))


class BertModel(nn.Layer):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        layer = nn.TransformerEncoderLayer(
            cfg.hidden_size, cfg.num_attention_heads, cfg.intermediate_size,
            dropout=cfg.hidden_dropout_prob, activation="gelu",
            attn_dropout=cfg.attention_dropout_prob)
        self.encoder = nn.TransformerEncoder(layer, cfg.num_hidden_layers)
        self.pooler = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, with_pool=True):
        if attention_mask is not None and attention_mask.ndim == 2:
            # [B, L] 1/0 padding mask -> additive [B, 1, 1, L]
            keep = torch.as_tensor(attention_mask, device=input_ids.device)
            attention_mask = ((1.0 - keep.float()) * -1e9)[:, None, None, :]
        x = self.embeddings(input_ids, token_type_ids, position_ids)
        x = self.encoder(x, attention_mask)
        if not with_pool:  # the QA and MLM heads never read the pooler
            return x, None
        return x, call_op("tanh", self.pooler(x[:, 0]))


class BertForQuestionAnswering(nn.Layer):
    """Span prediction (SQuAD): start and end logits; with positions,
    the mean of their two cross-entropies first."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        self.classifier = nn.Linear(cfg.hidden_size, 2)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, start_positions=None,
                end_positions=None):
        seq, _ = self.bert(input_ids, token_type_ids, position_ids,
                           attention_mask, with_pool=False)
        logits = self.classifier(seq)  # [B, L, 2]
        start_logits = logits[:, :, 0]
        end_logits = logits[:, :, 1]
        if start_positions is None:
            return start_logits, end_logits
        loss = (F.cross_entropy(start_logits, start_positions) +
                F.cross_entropy(end_logits, end_positions)) / 2.0
        return loss, start_logits, end_logits


class BertForMaskedLM(nn.Layer):
    """Masked-LM pretraining: a transform (dense, GELU, LayerNorm), then a
    decoder tied to the word-embedding table with its own output bias;
    positions labelled -100 add no loss."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.bert = BertModel(cfg)
        init = nn.ParamAttr(initializer=nn.initializer.Normal(
            0.0, cfg.initializer_range))
        self.transform = nn.Linear(cfg.hidden_size, cfg.hidden_size,
                                   weight_attr=init)
        self.layer_norm = nn.LayerNorm(cfg.hidden_size)
        self.decoder_bias = self.create_parameter(
            [cfg.vocab_size], is_bias=True)

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                attention_mask=None, labels=None):
        seq, _ = self.bert(input_ids, token_type_ids, position_ids,
                           attention_mask, with_pool=False)
        h = self.layer_norm(F.gelu(self.transform(seq)))
        logits = call_op(
            "matmul", h, self.bert.embeddings.word_embeddings.weight,
            transpose_y=True) + self.decoder_bias
        if labels is None:
            return logits
        loss = F.cross_entropy(
            call_op("reshape", logits, shape=(-1, logits.shape[-1])),
            call_op("reshape", labels, shape=(-1,)),
            ignore_index=-100, reduction="mean")
        return loss, logits


class BertForSequenceClassification(nn.Layer):
    def __init__(self, cfg: BertConfig, num_classes=2):
        super().__init__()
        self.bert = BertModel(cfg)
        self.dropout = nn.Dropout(cfg.hidden_dropout_prob)
        self.classifier = nn.Linear(cfg.hidden_size, num_classes)

    def forward(self, input_ids, token_type_ids=None, labels=None):
        _, pooled = self.bert(input_ids, token_type_ids)
        logits = self.classifier(self.dropout(pooled))
        if labels is None:
            return logits
        return F.cross_entropy(logits, labels), logits
