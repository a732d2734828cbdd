"""Mixture of experts (counterpart of ``paddle_tpu/incubate/moe.py``), on
the dense single-device path: GShard top-k routing with a capacity, the
tokens dispatched to and combined from the experts by products with a
capacity-bounded one-hot, as the JAX layer's single-shard path does.

The experts' parameters are stacked ``[E, ...]`` parameters of the
:class:`MoELayer` (``expert_fc1_weight``, ...), and the expert body, one
template layer kept out of the layer's registry, runs over the stack
under ``torch.func.vmap`` of ``torch.func.functional_call``; plain
autograd gives the gate and the experts their gradients. A stacked
``Linear`` weight is ``[E, out, in]`` (the port's ``Linear`` layout
inside) and carries the layout mark ``(0, 2, 1)`` of the JAX ``[E, in,
out]`` stack, which ``convert`` reads.

Routing follows ``jax.lax.top_k``: ties go to the lower expert index (a
stable descending sort, on the CPU and the card alike). Each token's
place in its expert's queue is counted in integers, token-major: an
early token's second choice queues ahead of a later token's first. (The
JAX layer counts in the probabilities' dtype, which is exact in float32;
the port's count is exact in bfloat16 too.) The expert-parallel path
(``shard_map`` with ``all_to_all`` over an ``"expert"`` mesh axis) needs a
mesh: ``group=`` raises naming ROADMAP Queue 1 item 4.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch.nn import functional as TF

from .. import nn
from ..nn import functional as F
from ..nn.layer.layers import jax_perm
from ..ops.registry import not_ported

__all__ = ["NaiveGate", "SwitchGate", "GShardGate", "MoELayer",
           "ExpertMLP"]


class NaiveGate(nn.Layer):
    """A top-k linear gate: ``fc`` ``[d_model, num_experts]`` logits."""

    def __init__(self, d_model, num_experts, topk=2):
        super().__init__()
        self.fc = nn.Linear(d_model, num_experts)
        self.topk = topk
        self.num_experts = num_experts

    def forward(self, x):
        return self.fc(x)


class SwitchGate(NaiveGate):
    def __init__(self, d_model, num_experts):
        super().__init__(d_model, num_experts, topk=1)


class GShardGate(NaiveGate):
    pass


class ExpertMLP(nn.Layer):
    """One expert's body: ``fc2(gelu(fc1(x)))``."""

    def __init__(self, d_model, d_hidden):
        super().__init__()
        self.fc1 = nn.Linear(d_model, d_hidden)
        self.fc2 = nn.Linear(d_hidden, d_model)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def top_k(probs, k):
    """The ``k`` largest of each row of ``probs`` and their indices, ties
    toward the lower index, as ``jax.lax.top_k`` orders them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


class MoELayer(nn.Layer):
    """``[B, L, D] -> [B, L, D]`` through ``topk`` of ``num_experts``
    experts (``experts=[...]``, each a layer of one structure, or
    ``num_experts`` :class:`ExpertMLP` s of ``d_hidden``), each taking at
    most ``ceil(tokens / E * capacity_factor)`` tokens; the load-balance
    loss ``sum(me * ce) * E`` is kept on ``self.l_aux``.
    ``recompute_interval`` is taken and unused, as in the JAX layer."""

    def __init__(self, d_model, experts: Optional[List[nn.Layer]] = None,
                 gate=None, num_experts=None, d_hidden=None, topk=2,
                 capacity_factor=1.25, group=None, recompute_interval=0):
        super().__init__()
        if group is not None:
            raise not_ported("MoELayer(group=...), the expert-parallel "
                             "path", 4)
        if experts is None:
            if num_experts is None or d_hidden is None:
                raise ValueError(
                    "pass experts=[...] or num_experts+d_hidden")
            experts = [ExpertMLP(d_model, d_hidden)
                       for _ in range(num_experts)]
        num_experts = len(experts)
        names = [n for n, _ in experts[0].named_parameters()]
        perms = {}
        for n in names:
            own = [dict(e.named_parameters())[n] for e in experts]
            key = "expert_" + n.replace(".", "_")
            self.add_parameter(key, torch.nn.Parameter(
                torch.stack([p.detach() for p in own])))
            perm = jax_perm(own[0])
            if perm is not None:
                perms[key] = (0,) + tuple(i + 1 for i in perm)
        self._jax_perms = perms
        self._mark_layouts()
        # the template is the per-expert function body only: out of the
        # registry, or its own parameters would join parameters() with no
        # gradient
        self.__dict__["_template_holder"] = [experts[0]]
        self._expert_param_names = names
        self.num_experts = num_experts
        self.topk = topk
        self.capacity_factor = capacity_factor
        self.gate = gate if isinstance(gate, nn.Layer) else \
            NaiveGate(d_model, num_experts, topk=topk)
        self.l_aux = None

    @property
    def _expert_template(self):
        return self.__dict__["_template_holder"][0]

    def _expert_params(self):
        return {n: getattr(self, "expert_" + n.replace(".", "_"))
                for n in self._expert_param_names}

    def _route(self, probs, cap):
        """GShard top-k routing with capacity ``cap``: ``probs`` ``[S, E]``
        -> (dispatch ``[S, E, C]``, combine ``[S, E, C]``, me ``[E]``, ce
        ``[E]``)."""
        s, e = probs.shape
        topv, topi = top_k(probs, self.topk)                    # [S, K]
        onehot = TF.one_hot(topi, e)                            # [S, K, E]
        flat = onehot.reshape(s * self.topk, e)
        pos = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(
            s, self.topk)                                       # [S, K]
        keep = pos < cap
        gates = topv * keep
        gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        cap_oh = TF.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
        onehot, cap_oh = onehot.to(probs.dtype), cap_oh.to(probs.dtype)
        dispatch = torch.einsum("ske,skc->sec", onehot, cap_oh)
        combine = torch.einsum("sk,ske,skc->sec", gates, onehot, cap_oh)
        me = probs.mean(0)
        ce = onehot[:, 0].mean(0)                               # top-1 share
        return dispatch, combine, me, ce

    def _forward_2d(self, x2):
        """``[S, D]`` tokens -> (``[S, D]`` out, scalar ``l_aux``)."""
        s = x2.shape[0]
        e = self.num_experts
        probs = torch.softmax(self.gate(x2), dim=-1)
        cap = max(1, int(math.ceil(s / e * self.capacity_factor)))
        dispatch, combine, me, ce = self._route(probs, cap)
        l_aux = (me * ce).sum() * e
        expert_in = torch.einsum("sd,sec->ecd", x2, dispatch)
        tmpl = self._expert_template

        def one_expert(params, xe):
            return torch.func.functional_call(tmpl, params, (xe,))

        expert_out = torch.func.vmap(one_expert)(self._expert_params(),
                                                 expert_in)
        return torch.einsum("ecd,sec->sd", expert_out, combine), l_aux

    def forward(self, x):
        b, l, d = x.shape
        out, self.l_aux = self._forward_2d(x.reshape(b * l, d))
        return out.reshape(b, l, d)
