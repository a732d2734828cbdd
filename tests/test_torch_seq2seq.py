"""The port's ``TransformerModel`` and its decode loops against the JAX
package's, on the CPU.

``TransformerModel(40, 40, d_model=32, nhead=4, 2 + 2 layers, ffn 64,
dropout 0, max_length 24)`` in both packages, the JAX state (the
``pos_table`` buffer included) carried across with
``convert.layer_from_jax``. Sources of 3 rows padded with ``pad_id`` 0
past lengths 9, 6 and 4 (the source-pad mask), targets of 7 tokens.

* Teacher forcing: the logits within 1e-5 of their largest value, and
  every parameter's gradient of a cross-entropy within 1e-4 of that
  gradient's largest value (float32 in both; every attention is masked,
  so the op's plain body on both sides), but the two embedding tables':
  the JAX ``TransformerModel._embed`` returns its sum as a new ``Tensor``
  outside the tape, so the JAX tables get no gradient (a defect of the
  reference, not copied: the port's get theirs).
* ``generate`` (``run_generate``): greedy, and beams of 3 with and
  without a length penalty, give the JAX tokens exactly, with their
  dtype and shape (``[B, max_length]`` int32, pads after EOS); an EOS
  chosen to be the greedy path's third token makes the early stop and
  the padding after it show.
* The JAX ``ValueError``s: ``num_beams < 1``, ``length_penalty`` without
  beams, ``max_length < 2``, ``max_length`` past the position table.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import seq2seq as jseq
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import _linear_keys, layer_from_jax
from paddle_tpu_torch.models import seq2seq as tseq

VOCAB, MAXLEN = 40, 24
EMBEDDINGS = ("src_embed.weight", "tgt_embed.weight")
KW = dict(d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
          dim_feedforward=64, dropout=0.0, max_length=MAXLEN)


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _pair(**kw):
    paddle.seed(0)
    jm = jseq.TransformerModel(VOCAB, VOCAB, **KW, **kw)
    tm = tseq.TransformerModel(VOCAB, VOCAB, **KW, **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert set(tm.state_dict()) == set(state)
    layer_from_jax(tm, state)
    return jm, tm


def _src():
    rs = np.random.RandomState(9)
    src = rs.randint(2, VOCAB, (3, 9)).astype(np.int64)
    for row, n in enumerate((9, 6, 4)):
        src[row, n:] = 0
    return src


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_teacher_forcing_matches_jax():
    jm, tm = _pair()
    src = _src()
    rs = np.random.RandomState(10)
    tgt = rs.randint(2, VOCAB, (3, 7)).astype(np.int64)
    lab = rs.randint(2, VOCAB, (3, 7)).astype(np.int64)
    jl = jm(paddle.to_tensor(src), paddle.to_tensor(tgt))
    tl = tm(torch.from_numpy(src), torch.from_numpy(tgt))
    assert _rel(tl.detach().numpy(), jl.numpy()) <= 1e-5
    paddle.nn.CrossEntropyLoss()(jl, paddle.to_tensor(lab)).backward()
    pt.nn.CrossEntropyLoss()(tl, torch.from_numpy(lab)).backward()
    jgrads = dict(jm.named_parameters())
    linear = _linear_keys(tm)
    for name, p in tm.named_parameters():
        if name in EMBEDDINGS:
            # the JAX ``_embed`` rewraps its sum in a new Tensor, so the
            # tables get no gradient there (a defect, not copied)
            assert jgrads[name].grad is None and p.grad.abs().max() > 0
            continue
        want = jgrads[name].grad.numpy()
        got = p.grad.numpy().T if name in linear else p.grad.numpy()
        if np.abs(want).max() <= 1e-6:      # a key bias: zero up to rounding
            assert np.abs(got).max() <= 1e-6, name
            continue
        assert _rel(got, want) <= 1e-4, name


def _eos_on_the_greedy_path():
    """A model whose ``eos_id`` is the third token its greedy decode picks
    for the first row, so that row stops early."""
    jm, _ = _pair()
    first = np.asarray(jm.generate(paddle.to_tensor(_src()),
                                   max_length=12).numpy())
    return int(first[0, 3])


@pytest.mark.parametrize("beams,penalty", [(1, 0.0), (3, 0.0), (3, 0.6)],
                         ids=["greedy", "beam", "beam_penalty"])
def test_generate_tokens_equal_jax(beams, penalty):
    eos = _eos_on_the_greedy_path()
    jm, tm = _pair(eos_id=eos)
    src = _src()
    want = np.asarray(jm.generate(paddle.to_tensor(src), max_length=12,
                                  num_beams=beams,
                                  length_penalty=penalty).numpy())
    got = tm.generate(torch.from_numpy(src), max_length=12, num_beams=beams,
                      length_penalty=penalty)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if beams == 1:
        assert want[0, 3] == eos and (want[0, 4:] == 0).all()


@pytest.mark.parametrize("kw,match", [
    (dict(num_beams=0), "num_beams"),
    (dict(length_penalty=0.5), "length_penalty"),
    (dict(max_length=1), "max_length must be"),
    (dict(max_length=MAXLEN + 1), "positional table"),
], ids=["beams", "penalty", "short", "long"])
def test_generate_raises_the_jax_value_errors(kw, match):
    jm, tm = _pair()
    src = _src()
    with pytest.raises(ValueError, match=match):
        jm.generate(paddle.to_tensor(src), **kw)
    with pytest.raises(ValueError, match=match):
        tm.generate(torch.from_numpy(src), **kw)
