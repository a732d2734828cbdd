"""Beam-search decoding over a cell (counterpart of
``paddle_tpu/nn/decode.py``): ``BeamSearchDecoder`` and
``dynamic_decode``.

The decode is a loop of at most ``max_step_num`` steps with a finished
mask, each step one call of the cell on the ``[B * K]`` flattened beams;
it stops early once every beam has finished (one host read a step, the
JAX eager loop's test). The ancestry walk at the end is the
``gather_tree`` op. Ties among the candidates are broken as
``lax.top_k`` breaks them (lowest index first), so the tokens equal the
JAX package's on the same logits.
"""
from __future__ import annotations

import torch

from ..framework.dispatch import call_op as _op

__all__ = ["BeamSearchDecoder", "dynamic_decode"]


def _map(fn, tree):
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


class BeamSearchDecoder:
    """Wraps a cell (``cell(inputs, states) -> (outputs, new_states)``)
    into a beam-search decoder: ``embedding_fn`` maps token ids to the
    cell's inputs, ``output_fn`` its outputs to vocabulary logits."""

    def __init__(self, cell, start_token, end_token, beam_size,
                 embedding_fn=None, output_fn=None):
        self.cell = cell
        self.start_token = int(start_token)
        self.end_token = int(end_token)
        self.beam_size = int(beam_size)
        self.embedding_fn = embedding_fn
        self.output_fn = output_fn

    def initialize(self, initial_states, batch_size):
        """Start tokens, log-probs (beam 0 live, the others at -1e9 so the
        first step fans out), the finished mask and the states repeated
        to ``[B * K]``."""
        k = self.beam_size
        device = _leaves(initial_states)[0].device
        tok = torch.full((batch_size, k), self.start_token,
                         dtype=torch.int32, device=device)
        lp = torch.full((batch_size, k), -1e9, dtype=torch.float32,
                        device=device)
        lp[:, 0] = 0.0
        fin = torch.zeros((batch_size, k), dtype=torch.bool, device=device)
        tiled = _map(lambda s: torch.repeat_interleave(s, k, dim=0),
                     initial_states)
        return tok, lp, fin, tiled

    def step(self, tokens, log_probs, finished, states, batch):
        from ..models.generation import _beam_topk
        k = self.beam_size
        inp = tokens.reshape(-1)
        emb = self.embedding_fn(inp) if self.embedding_fn is not None \
            else inp
        out, new_states = self.cell(emb, states)
        logits = self.output_fn(out) if self.output_fn is not None else out
        vocab = logits.shape[-1]
        step_lp = torch.log_softmax(logits.float(), dim=-1).reshape(
            batch, k, vocab)
        # finished beams extend only with end_token, at no cost
        frozen = torch.full((vocab,), -1e9, dtype=torch.float32,
                            device=logits.device)
        frozen[self.end_token] = 0.0
        step_lp = torch.where(finished[..., None], frozen, step_lp)
        total = (log_probs[..., None] + step_lp).reshape(batch, k * vocab)
        top_lp, top_idx = _beam_topk(total, k)
        parent = (top_idx // vocab).to(torch.int32)
        token = (top_idx % vocab).to(torch.int32)
        new_finished = torch.gather(finished, 1, parent.long()) | (
            token == self.end_token)
        # reorder the states by parent beam
        gidx = (torch.arange(batch, device=parent.device)[:, None] * k
                + parent.long()).reshape(-1)
        new_states = _map(lambda s: s.index_select(0, gidx), new_states)
        return token, top_lp, new_finished, new_states, parent


def dynamic_decode(decoder, inits=None, max_step_num=32, batch_size=None,
                   output_time_major=False, **kwargs):
    """Run ``decoder`` for at most ``max_step_num`` steps. Returns ``(ids
    [B, K, T] int32, final log-probs [B, K])`` after the ``gather_tree``
    walk (``[T, B, K]`` ids when ``output_time_major``)."""
    if batch_size is None:
        batch_size = _leaves(inits)[0].shape[0]
    tok, lp, fin, states = decoder.initialize(inits, batch_size)
    tokens_acc, parents_acc = [], []
    for _ in range(int(max_step_num)):
        tok, lp, fin, states, parent = decoder.step(
            tok, lp, fin, states, batch_size)
        tokens_acc.append(tok)
        parents_acc.append(parent)
        if bool(fin.all()):
            break
    out = _op("gather_tree", torch.stack(tokens_acc),
              torch.stack(parents_acc))
    if not output_time_major:
        out = out.permute(1, 2, 0)
    return out, lp
