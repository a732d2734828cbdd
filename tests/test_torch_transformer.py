"""``nn.Transformer`` in the port against the JAX package's.

A small encoder-decoder translation model (a shared ``Embedding`` scaled
by sqrt(d_model) plus sinusoidal positions made from each package's own
ops, ``nn.Transformer`` at d_model 32, 4 heads, 2 + 2 layers, an output
``Linear``, ``nn.CrossEntropyLoss``) is built in both packages from the
same code over the package's public API; the JAX model's state goes
across with ``convert.layer_from_jax``. On batch 2 x 8 source and 10
target tokens, with and without the causal target mask
(``generate_square_subsequent_mask``): the logits (atol 1e-5), the loss,
every parameter's gradient (atol 1e-5 + rtol 1e-4) and the parameters
after one AdamW step (atol 2e-5 + rtol 1e-5) agree. The step's epsilon
is 1e-3: a first Adam step moves a parameter by about ``lr *
sign(grad)``, which near-zero gradients (a key bias's is zero up to
rounding: softmax ignores a shift shared by a query's scores) would turn
into the sign of rounding noise; with this epsilon the step is a smooth
function of the gradient, so it differs by no more than the gradients.
Each updated parameter is held to the AdamW step computed in numpy from
the JAX gradient, and to the JAX optimizer's own step where the JAX
parameter's name is unique: the JAX optimizer keys its moments by
``Parameter.name``, and the encoder's and decoder's deep-copied layers
(``TransformerEncoder`` copies its first layer) share their names with
the layer copied, so their moments mix there (a defect of the reference,
left as it is). The JAX side runs its
attention as the op's plain composition (its Pallas kernel is not
selected off the TPU); the port's unmasked attention goes through the
flash wrapper's plain version, the masked one through the op's plain
body, as on the card.
"""
import collections
import math

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.optimizer import AdamW as JaxAdamW
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import layer_from_jax, layer_to_numpy
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.optimizer import AdamW

VOCAB, D, HEADS, FF, LAYERS = 50, 32, 4, 64, 2
BATCH, SRC, TGT = 2, 8, 10
LR, EPS = 1e-3, 1e-3


def seq2seq(P, masked):
    """The model over package ``P`` (``paddle_tpu`` or
    ``paddle_tpu_torch``)."""
    nn = P.nn

    def positions(length):
        pos = P.unsqueeze(P.arange(0, length, dtype="float32"), 1)
        i = P.arange(0, D, 2, dtype="float32")
        angle = pos * P.exp(i * (-math.log(10000.0) / D))
        return P.reshape(P.stack([P.sin(angle), P.cos(angle)], axis=-1),
                         [length, D])

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(VOCAB, D)
            self.transformer = nn.Transformer(
                D, HEADS, LAYERS, LAYERS, FF, dropout=0.0, attn_dropout=0.0)
            self.proj = nn.Linear(D, VOCAB)

        def forward(self, src, tgt):
            x = self.embed(src) * math.sqrt(D) + positions(src.shape[1])
            y = self.embed(tgt) * math.sqrt(D) + positions(tgt.shape[1])
            mask = nn.Transformer.generate_square_subsequent_mask(
                tgt.shape[1]) if masked else None
            return self.proj(self.transformer(x, y, tgt_mask=mask))

    return Seq2Seq()


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _batch():
    rs = np.random.RandomState(3)
    return (rs.randint(0, VOCAB, (BATCH, SRC)).astype(np.int64),
            rs.randint(0, VOCAB, (BATCH, TGT)).astype(np.int64),
            rs.randint(0, VOCAB, (BATCH, TGT)).astype(np.int64))


def _jax_run(masked, src, tgt, labels):
    paddle.seed(0)
    net = seq2seq(paddle, masked)
    state = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    opt = JaxAdamW(LR, parameters=net.parameters(), weight_decay=0.01,
                   epsilon=EPS)
    logits = net(paddle.to_tensor(src), paddle.to_tensor(tgt))
    loss = paddle.nn.CrossEntropyLoss()(logits, paddle.to_tensor(labels))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in net.named_parameters()}
    opt.step()
    after = {k: np.asarray(v.numpy()) for k, v in net.state_dict().items()}
    names = collections.Counter(p.name for p in net.parameters())
    unique = {n for n, p in net.named_parameters() if names[p.name] == 1}
    return state, logits.numpy(), float(loss), grads, after, unique


def adamw_step(p, g):
    """One AdamW step from zero moments, in numpy (the update both
    packages implement: bias-corrected moments, decoupled decay)."""
    m, v = (1 - 0.9) * g, (1 - 0.999) * g * g
    mh, vh = m / (1 - 0.9), v / (1 - 0.999)
    return p - LR * mh / (np.sqrt(vh) + EPS) - LR * 0.01 * p


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
def test_transformer_matches_jax(masked):
    src, tgt, labels = _batch()
    state, want_logits, want_loss, want_grads, want_after, unique = \
        _jax_run(masked, src, tgt, labels)
    net = seq2seq(pt, masked)
    assert set(net.state_dict()) == set(state)
    layer_from_jax(net, state)
    opt = AdamW(LR, parameters=net.parameters(), weight_decay=0.01,
                epsilon=EPS)
    flash = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    sdpa = pt.framework.monitor.stat_get("op_count/"
                                         "scaled_dot_product_attention")
    logits = net(torch.from_numpy(src), torch.from_numpy(tgt))
    loss = pt.nn.CrossEntropyLoss()(logits, torch.from_numpy(labels))
    loss.backward()
    # 6 attentions a forward: 2 encoder self, 2 decoder self, 2 cross; on
    # the CPU the wrappers run their plain versions and count no launch
    assert pt.framework.monitor.stat_get(
        "op_count/scaled_dot_product_attention") - sdpa == 3 * LAYERS
    assert (fa.flash_attention_fwd.launches,
            fa.flash_attention_bwd.launches) == flash
    np.testing.assert_allclose(logits.detach().numpy(), want_logits,
                               atol=1e-5, rtol=0)
    assert loss.item() == pytest.approx(want_loss, abs=1e-5)
    linear = {k for k in state if k.endswith("proj.weight")
              or k.endswith("linear1.weight") or k.endswith("linear2.weight")}
    for name, p in net.named_parameters():
        g = p.grad.numpy().T if name in linear else p.grad.numpy()
        np.testing.assert_allclose(g, want_grads[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    opt.step()
    assert len(unique) == len(state) - 2 * 42      # the deep copies' names
    for k, v in layer_to_numpy(net).items():
        np.testing.assert_allclose(v, adamw_step(state[k], want_grads[k]),
                                   atol=2e-5, rtol=1e-5, err_msg=k)
        if k in unique:
            np.testing.assert_allclose(v, want_after[k], atol=2e-5,
                                       rtol=1e-5, err_msg=k)


def test_the_unmasked_attention_takes_the_flash_route():
    """On a CPU tensor the override still picks the kernel wrapper (which
    runs its plain version) for the unmasked self- and cross-attention,
    and the op's plain body for the masked decoder self-attention."""
    from paddle_tpu_torch.nn import functional as F
    calls = []
    real = F.flash_attention

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    F.flash_attention = spy
    try:
        src, tgt, _ = _batch()
        for masked, want in ((False, 3 * LAYERS), (True, 2 * LAYERS)):
            calls.clear()
            seq2seq(pt, masked)(torch.from_numpy(src), torch.from_numpy(tgt))
            assert len(calls) == want
    finally:
        F.flash_attention = real


def test_generate_square_subsequent_mask_matches_jax():
    got = pt.nn.Transformer.generate_square_subsequent_mask(5)
    want = paddle.nn.Transformer.generate_square_subsequent_mask(5).numpy()
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_incremental_cache_decoding_matches_jax():
    """``TransformerDecoder.gen_cache`` + a step at a time (the
    incremental self-attention ``Cache`` and the cross-attention's
    ``StaticCache``) gives the full masked forward's rows, in both
    packages."""
    rs = np.random.RandomState(5)
    mem, tgt = rs.randn(2, 6, D).astype(np.float32), \
        rs.randn(2, 4, D).astype(np.float32)

    def build(P):
        layer = P.nn.TransformerDecoderLayer(D, HEADS, FF, dropout=0.0)
        return P.nn.TransformerDecoder(layer, 2)

    jdec, tdec = build(paddle.nn and paddle), build(pt)
    jdec.eval()
    tdec.eval()
    layer_from_jax(tdec, {k: np.asarray(v.numpy())
                          for k, v in jdec.state_dict().items()})
    m, t = torch.from_numpy(mem), torch.from_numpy(tgt)
    full = tdec(t, m, tgt_mask=pt.nn.Transformer
                .generate_square_subsequent_mask(4)).detach().numpy()
    cache = tdec.gen_cache(m)
    steps = []
    for i in range(4):
        out, cache = tdec(t[:, i:i + 1], m, cache=cache)
        steps.append(out.detach().numpy())
    np.testing.assert_allclose(np.concatenate(steps, 1), full, atol=1e-5)
    jcache = jdec.gen_cache(paddle.to_tensor(mem))
    jout, _ = jdec(paddle.to_tensor(tgt[:, :1]), paddle.to_tensor(mem),
                   cache=jcache)
    np.testing.assert_allclose(steps[0], jout.numpy(), atol=1e-5)
