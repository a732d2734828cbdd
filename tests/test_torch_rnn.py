"""The port's recurrent layers and beam-search decoder against the JAX
package's, on the CPU.

Each layer is built in both packages (input 3, hidden 5), the JAX state
carried across with ``convert.layer_from_jax`` (the same keys and
layouts: ``weight_ih [gates * H, I]``, ``weight_hh``, ``bias_ih``,
``bias_hh``); inputs ``[2, 6, 3]`` from a seed, lengths 6 and 4 where a
case takes ``sequence_length``. The outputs and final states agree
within 1e-5 and every parameter's and the input's gradient (of the sum
of the outputs against a fixed random weighting) within 1e-5: float32
recurrences in both, the same operations in the same order.

Cases: the three cells for one step (SimpleRNN with tanh and relu);
``RNN`` forward and reversed, batch- and time-major, with and without
lengths; ``BiRNN``; ``SimpleRNN``/``LSTM``/``GRU`` at 2 layers,
bidirectional with lengths, and with initial states in the reference
layout ``[layers * directions, B, H]``. Then ``BeamSearchDecoder`` over
an ``LSTMCell`` (an embedding in, a projection out, beam 3, vocabulary
11, at most 7 steps) through ``dynamic_decode``: the token ids equal and
the final log-probabilities within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as pt
from paddle_tpu_torch.convert import layer_from_jax

I, H, B, T = 3, 5, 2, 6
TOL = 1e-5
LENGTHS = np.array([6, 4], np.int64)


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _pair(make):
    """The JAX layer and the port's with the JAX layer's state."""
    paddle.seed(0)
    jl = make(paddle.nn)
    tl = make(pt.nn)
    layer_from_jax(tl, {k: np.asarray(v.numpy())
                        for k, v in jl.state_dict().items()})
    return jl, tl


def _leaves(out):
    if isinstance(out, (tuple, list)):
        return [x for o in out for x in _leaves(o)]
    return [out]


def _compare(make, x, call, state_arrays=()):
    """Run ``call(layer, x, states)`` in both packages; hold every output
    leaf and every gradient."""
    jl, tl = _pair(make)
    rs = np.random.RandomState(7)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.tensor(x, requires_grad=True)
    jout = _leaves(call(jl, jx, [paddle.to_tensor(s)
                                 for s in state_arrays], paddle))
    tout = _leaves(call(tl, tx, [torch.from_numpy(s.copy())
                                 for s in state_arrays], pt))
    assert len(jout) == len(tout)
    weights = [rs.randn(*o.shape).astype(np.float32) for o in jout]
    jloss = sum((o * paddle.to_tensor(w)).sum()
                for o, w in zip(jout, weights))
    tloss = sum((o * torch.from_numpy(w)).sum()
                for o, w in zip(tout, weights))
    jloss.backward()
    tloss.backward()
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=TOL,
                               rtol=TOL)
    jgrads = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), jgrads[name].grad.numpy(),
                                   atol=TOL, rtol=TOL, err_msg=name)


def _x(*shape):
    return np.random.RandomState(3).randn(*shape).astype(np.float32)


def _h(*shape):
    return (0.5 * np.random.RandomState(4).randn(*shape)).astype(np.float32)


CELLS = {
    "simple_tanh": (lambda nn: nn.SimpleRNNCell(I, H), 1),
    "simple_relu": (lambda nn: nn.SimpleRNNCell(I, H, activation="relu"), 1),
    "lstm": (lambda nn: nn.LSTMCell(I, H), 2),
    "gru": (lambda nn: nn.GRUCell(I, H), 1),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_matches_jax(name):
    make, n_states = CELLS[name]
    states = [_h(B, H), _h(B, H) * 2][:n_states]

    def call(layer, x, st, P):
        return layer(x, tuple(st) if n_states == 2 else st[0])

    _compare(make, _x(B, I), call, states)


def test_lstm_cell_initial_states_match_jax():
    jl, tl = _pair(lambda nn: nn.LSTMCell(I, H))
    jh, jc = jl.get_initial_states(paddle.to_tensor(_x(B, I)))
    th, tc = tl.get_initial_states(torch.from_numpy(_x(B, I)))
    assert th.shape == tuple(jh.shape) and th.dtype == torch.float32
    assert not th.any() and not tc.any()


RNNS = {
    "forward": dict(),
    "reverse": dict(is_reverse=True),
    "time_major": dict(time_major=True),
    "reverse_time_major": dict(is_reverse=True, time_major=True),
}


@pytest.mark.parametrize("lengths", [False, True], ids=["full", "lengths"])
@pytest.mark.parametrize("kind", sorted(RNNS))
@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_rnn_matches_jax(cell, kind, lengths):
    kw = RNNS[kind]
    make_cell = CELLS[cell][0]
    x = _x(T, B, I) if kw.get("time_major") else _x(B, T, I)

    def call(layer, x, st, P):
        sl = P.to_tensor(LENGTHS) if lengths else None
        return layer(x, sequence_length=sl)

    _compare(lambda nn: nn.RNN(make_cell(nn), **kw), x, call)


def test_birnn_matches_jax():
    def call(layer, x, st, P):
        return layer(x, sequence_length=P.to_tensor(LENGTHS))

    _compare(lambda nn: nn.BiRNN(nn.GRUCell(I, H), nn.GRUCell(I, H)),
             _x(B, T, I), call)


STACKS = {
    "simple": lambda nn, **kw: nn.SimpleRNN(I, H, **kw),
    "lstm": lambda nn, **kw: nn.LSTM(I, H, **kw),
    "gru": lambda nn, **kw: nn.GRU(I, H, **kw),
}


@pytest.mark.parametrize("name", sorted(STACKS))
def test_bidirectional_stack_with_lengths_matches_jax(name):
    def call(layer, x, st, P):
        return layer(x, sequence_length=P.to_tensor(LENGTHS))

    _compare(lambda nn: STACKS[name](nn, num_layers=2, direction="bidirect"),
             _x(B, T, I), call)


@pytest.mark.parametrize("name", sorted(STACKS))
def test_stack_with_initial_states_matches_jax(name):
    n = 2 if name == "lstm" else 1
    states = [_h(2, B, H), _h(2, B, H) * 2][:n]

    def call(layer, x, st, P):
        return layer(x, tuple(st) if n == 2 else st[0])

    _compare(lambda nn: STACKS[name](nn, num_layers=2, time_major=True),
             _x(T, B, I), call, states)


def test_stack_state_keys_equal_jax():
    jl, tl = _pair(lambda nn: nn.LSTM(I, H, num_layers=2,
                                      direction="bidirect"))
    assert list(tl.state_dict()) == list(jl.state_dict())


VOCAB, EMB, BEAM, STEPS = 11, 4, 3, 7


def _decode(P, nn, arr, state):
    cell = nn.LSTMCell(EMB, H)
    embed = nn.Embedding(VOCAB, EMB)
    proj = nn.Linear(H, VOCAB)
    if state is not None:
        for layer, key in ((cell, "cell"), (embed, "embed"), (proj, "proj")):
            layer_from_jax(layer, state[key])
    dec = nn.BeamSearchDecoder(cell, start_token=0, end_token=1,
                               beam_size=BEAM, embedding_fn=embed,
                               output_fn=proj)
    h = arr(_h(B, H))
    ids, lp = nn.dynamic_decode(dec, inits=(h, arr(_h(B, H) * 0.3)),
                                max_step_num=STEPS)
    return (cell, embed, proj, np.asarray(ids.detach().numpy()),
            np.asarray(lp.detach().numpy()))


def test_beam_search_decode_matches_jax():
    paddle.seed(0)
    jcell, jembed, jproj, jids, jlp = _decode(paddle, paddle.nn,
                                              paddle.to_tensor, None)
    state = {k: {n: np.asarray(v.numpy()) for n, v in m.state_dict().items()}
             for k, m in (("cell", jcell), ("embed", jembed),
                          ("proj", jproj))}
    _, _, _, tids, tlp = _decode(pt, pt.nn, lambda a: torch.from_numpy(
        a.copy()), state)
    assert tids.dtype == jids.dtype == np.int32
    assert tids.shape == jids.shape and tids.shape[:2] == (B, BEAM)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_allclose(tlp, jlp, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("name", ["simple_tanh", "gru"])
def test_cell_without_states_starts_from_zeros(name):
    """The JAX ``SimpleRNNCell``/``GRUCell`` called without states fail in
    ``get_initial_states`` (``tuple`` of an int: a defect of the
    reference, not copied); the port's start from zero states, which is
    the JAX cell given zeros."""
    make = CELLS[name][0]
    jl, tl = _pair(make)
    x = _x(B, I)
    with pytest.raises(TypeError):
        jl(paddle.to_tensor(x))
    got, _ = tl(torch.from_numpy(x))
    want, _ = jl(paddle.to_tensor(x), paddle.to_tensor(np.zeros((B, H),
                                                                np.float32)))
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=TOL,
                               rtol=TOL)
