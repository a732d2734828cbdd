"""The port's BERT against the JAX package's, on the CPU.

``BertConfig.tiny()`` (vocab 128, hidden 32, 2 layers, 2 heads, ffn 64,
dropout 0) in both packages, the JAX model's state carried across with
``convert.layer_from_jax``; batch 2 x 12 ids (and token types) from a
seed. For each of the four networks (``BertModel`` with its pooler, the
question-answering, masked-LM and sequence-classification heads), with
and without a 2-D padding mask where the head takes one: every output
within 1e-4 of its largest value, the loss within 1e-4, and every
parameter's gradient within 1e-3 of that gradient's largest value (a
float32 encoder in both, its sums in another order), but where the true
gradient is zero and both sides hold rounding noise: the attention key
biases (softmax ignores a shift shared by a query's scores) and, under
the span loss, the last LayerNorm's bias and the classifier's bias (a
shift shared by every position's logit): there both lie below 1e-6. The
masked-LM
decoder is tied to the word embeddings in both, so that table's gradient
sums the two uses. The JAX side runs its attention as the op's plain
composition; the port's unmasked attention goes through the flash
wrapper's plain version and LayerNorm through its kernel wrapper's, as
on the card.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import bert as jbert
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _linear_keys, layer_from_jax
from paddle_tpu_torch.models import bert as tbert

FWD_TOL, GRAD_TOL = 1e-4, 1e-3
#: a gradient whose true value is zero: both sides' largest |value|
ZERO_GRAD = 1e-6
BATCH, SEQ = 2, 12
HEADS = ("model", "qa", "mlm", "cls")


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _inputs():
    cfg = tbert.BertConfig.tiny()
    rs = np.random.RandomState(5)
    ids = rs.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int64)
    types = rs.randint(0, 2, (BATCH, SEQ)).astype(np.int64)
    mask = np.ones((BATCH, SEQ), np.float32)
    mask[0, 9:] = 0.0
    mask[1, 5:] = 0.0
    labels = rs.randint(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int64)
    labels[:, ::3] = -100
    return {"ids": ids, "types": types, "mask": mask, "labels": labels,
            "start": np.array([1, 7], np.int64),
            "end": np.array([4, 10], np.int64),
            "cls": np.array([1, 0], np.int64)}


def _net(mod, head):
    cfg = mod.BertConfig.tiny()
    return {"model": mod.BertModel, "qa": mod.BertForQuestionAnswering,
            "mlm": mod.BertForMaskedLM,
            "cls": mod.BertForSequenceClassification}[head](cfg)


def _run(net, head, arr, masked, inp):
    """The head's outputs (the first one a scalar loss) on ``inp``."""
    ids, types = arr(inp["ids"]), arr(inp["types"])
    mask = arr(inp["mask"]) if masked else None
    if head == "model":
        seq, pooled = net(ids, types, attention_mask=mask)
        return [(seq * seq).mean() + pooled.sum(), seq, pooled]
    if head == "qa":
        return list(net(ids, types, attention_mask=mask,
                        start_positions=arr(inp["start"]),
                        end_positions=arr(inp["end"])))
    if head == "mlm":
        return list(net(ids, types, attention_mask=mask,
                        labels=arr(inp["labels"])))
    return list(net(ids, types, labels=arr(inp["cls"])))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


#: every head unmasked and masked, but the classification head, whose
#: forward takes no attention mask (as in the JAX package)
CASES = [(h, m) for h in HEADS for m in (False, True)
         if not (h == "cls" and m)]


@pytest.mark.parametrize("head,masked", CASES,
                         ids=[f"{h}-{'masked' if m else 'unmasked'}"
                              for h, m in CASES])
def test_bert_matches_jax(head, masked):
    inp = _inputs()
    paddle.seed(0)
    jnet = _net(jbert, head)
    state = {k: np.asarray(v.numpy()) for k, v in jnet.state_dict().items()}
    jouts = _run(jnet, head, paddle.to_tensor, masked, inp)
    jouts[0].backward()
    jgrads = {n: p.grad.numpy() for n, p in jnet.named_parameters()
              if p.grad is not None}

    net = _net(tbert, head)
    assert set(net.state_dict()) == set(state)
    layer_from_jax(net, state)
    outs = _run(net, head, torch.from_numpy, masked, inp)
    outs[0].backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()
             if p.grad is not None}

    assert abs(outs[0].item() - float(jouts[0])) <= FWD_TOL * max(
        1.0, abs(float(jouts[0])))
    for got, want in zip(outs[1:], jouts[1:]):
        assert _rel(got.detach().numpy(), want.numpy()) <= FWD_TOL
    assert set(grads) == set(jgrads)
    linear = _linear_keys(net)
    for name, want in jgrads.items():
        got = grads[name].T if name in linear else grads[name]
        if np.abs(want).max() <= ZERO_GRAD:
            # zero up to rounding (see the module's docstring)
            assert np.abs(got).max() <= ZERO_GRAD, name
            continue
        assert _rel(got, want) <= GRAD_TOL, name
