"""``incubate.nn.FusedMultiTransformer`` and the CacheKV attention of the
PyTorch port against the JAX package's, on the CPU: the uncached causal
forward, the context stage, scalar and ``[B]`` vector ``time_step``
decode, a 2-token chunk against two single steps, every capacity error,
and the cache passed in left as it was.

Inputs from ``numpy.random.RandomState``; dropout off (the two packages'
random streams differ). float32 within rtol 1e-5 / atol 1e-6, except
where a test says otherwise.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import incubate as jinc
import paddle_tpu_torch as pt
from paddle_tpu_torch import incubate as tinc
from paddle_tpu_torch.convert import layer_from_jax

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def cpu_default():
    old = pt.get_device()
    pt.set_device("cpu")
    yield
    pt.set_device(old)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().numpy()
    return np.asarray(t._data if hasattr(t, "_data") else t)


def _close(got, want, rtol=RTOL, atol=ATOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _carry(jlayer, tlayer):
    layer_from_jax(tlayer, {k: _np(v) for k, v in
                            jlayer.state_dict().items()})
    return jlayer, tlayer


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# -- FusedMultiTransformer and its CacheKV stages -------------------------------

def _fmt_pair(seed, d=16, heads=4, ffn=32, layers=2):
    paddle.seed(seed)
    j, t = _carry(*(m.nn.FusedMultiTransformer(d, heads, ffn,
                                               num_layers=layers)
                    for m in (jinc, tinc)))
    j.eval()
    t.eval()
    return j, t


def test_multi_transformer_uncached_is_causal_and_matches():
    j, t = _fmt_pair(42)
    x = _rand(43, 2, 6, 16)
    jy, ty = j(paddle.to_tensor(x)), t(torch.tensor(x))
    _close(ty, jy)
    # causal: a change at the last position leaves the others as they were
    x2 = x.copy()
    x2[:, -1] += 1.0
    _close(t(torch.tensor(x2))[:, :-1], ty[:, :-1], 0, 0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        tinc.nn.FusedMultiTransformer(16, 4, 32, num_layers=1, nranks=2)


def test_multi_transformer_prefill_and_scalar_decode():
    """The context stage, then one step a position: each output and each
    cache equals the JAX layer's, each step equals the uncached causal
    forward's row, and the caches passed in are left as they were."""
    j, t = _fmt_pair(44)
    x = _rand(45, 2, 7, 16)
    full = t(torch.tensor(x))
    jc, tc = j.gen_cache(2, 7), t.gen_cache(2, 7)
    assert [tuple(c.shape) for c in tc] == [(2, 2, 4, 7, 4)] * 2
    jo, jc = j(paddle.to_tensor(x[:, :4]), caches=jc)
    before = [c.clone() for c in tc]
    to, tc2 = t(torch.tensor(x[:, :4]), caches=tc)
    _close(to, jo)
    for a, b in zip(tc, before):                  # left as it was
        assert torch.equal(a, b)
    for a, b in zip(tc2, jc):
        _close(a, b)
    _close(to, full[:, :4], 1e-4, 1e-5)
    for step in range(4, 7):
        jo, jc = j(paddle.to_tensor(x[:, step:step + 1]), caches=jc,
                   time_step=step)
        kept = [c.clone() for c in tc2]
        to, tc3 = t(torch.tensor(x[:, step:step + 1]), caches=tc2,
                    time_step=torch.tensor(step))
        for a, b in zip(tc2, kept):
            assert torch.equal(a, b)
        _close(to, jo)
        for a, b in zip(tc3, jc):
            _close(a, b)
        _close(to, full[:, step:step + 1], 1e-4, 1e-5)
        tc2 = tc3


def test_multi_transformer_chunk_equals_two_single_steps():
    j, t = _fmt_pair(46, d=32, ffn=64)
    x = _rand(47, 2, 6, 32)
    _, c1 = t(torch.tensor(x[:, :4]), caches=t.gen_cache(2, 6))
    chunk, _ = t(torch.tensor(x[:, 4:6]), caches=c1, time_step=4)
    s4, c2 = t(torch.tensor(x[:, 4:5]), caches=c1, time_step=4)
    s5, _ = t(torch.tensor(x[:, 5:6]), caches=c2, time_step=5)
    _close(chunk[:, 0], s4[:, 0], 1e-4, 1e-5)
    _close(chunk[:, 1], s5[:, 0], 1e-4, 1e-5)
    _, jc = j(paddle.to_tensor(x[:, :4]), caches=j.gen_cache(2, 6))
    jchunk, _ = j(paddle.to_tensor(x[:, 4:6]), caches=jc, time_step=4)
    _close(chunk, jchunk)


def test_vector_time_step_matches_jax_and_per_row_scalars():
    """A [B] ``time_step`` writes row b at starts[b] (the cache laid out
    [2, B, H, L, Dh] as in the JAX scatter) and equals per-row scalar
    calls, with a bool and an additive mask too."""
    paddle.seed(48)
    b, e, h, length = 3, 16, 4, 12
    j, t = _carry(*(m.nn.FusedMultiHeadAttention(
        e, h, dropout_rate=0.0, attn_dropout_rate=0.0,
        normalize_before=True) for m in (jinc, tinc)))
    j.eval()
    t.eval()
    starts = np.array([2, 5, 0], np.int32)
    x = _rand(49, b, 1, e)
    seed = _rand(50, 2, b, h, length, e // h)
    seed_t = torch.tensor(seed)
    jo, jc = j(paddle.to_tensor(x), cache=paddle.to_tensor(seed),
               time_step=paddle.to_tensor(starts))
    to, tc = t(torch.tensor(x), cache=seed_t, time_step=torch.tensor(starts))
    assert torch.equal(seed_t, torch.tensor(seed))     # left as it was
    _close(to, jo)
    _close(tc, jc)
    for i in range(b):
        o, c = t(torch.tensor(x[i:i + 1]), cache=seed_t[:, i:i + 1],
                 time_step=int(starts[i]))
        # the K/V rows come from a product at batch 1 here, at batch 3
        # above: float32 sums in another order
        _close(to[i:i + 1], o, 1e-5, 1e-5)
        _close(tc[:, i:i + 1], c)
    for mask in (np.arange(length) % 3 != 1,
                 np.where(np.arange(length) % 3 == 1, -1e9, 0.0).astype(
                     np.float32)):
        mask = mask.reshape(1, 1, 1, length)
        jo, _ = j(paddle.to_tensor(x), cache=paddle.to_tensor(seed),
                  time_step=paddle.to_tensor(starts),
                  attn_mask=paddle.to_tensor(mask))
        to, _ = t(torch.tensor(x), cache=seed_t, time_step=starts,
                  attn_mask=torch.tensor(mask))
        _close(to, jo)


def test_capacity_and_argument_errors():
    j, t = _fmt_pair(51)
    x = torch.zeros(1, 3, 16)
    with pytest.raises(ValueError, match="time_step requires caches"):
        t(x, time_step=2)
    with pytest.raises(ValueError, match="cache tensors"):
        t(x, caches=t.gen_cache(1, 8)[:1])
    _, caches = t(x, caches=t.gen_cache(1, 4))
    with pytest.raises(ValueError, match="exceeds the cache capacity 4"):
        t(x[:, :1], caches=caches, time_step=4)         # the cache is full
    with pytest.raises(ValueError, match="time_step 3 \\+ chunk 2"):
        t(x[:, :2], caches=caches, time_step=3)
    mha = t.layers[0].fused_attn
    cache = torch.zeros(2, 2, 4, 6, 4)
    xb = torch.zeros(2, 1, 16)
    with pytest.raises(ValueError, match="time_step max 6 \\+ chunk 1 "
                                         "exceeds the cache capacity 6"):
        mha(xb, cache=cache, time_step=torch.tensor([0, 6]))
    with pytest.raises(ValueError, match="3 entries for batch 2"):
        mha(xb, cache=cache, time_step=torch.tensor([0, 1, 2]))
    with pytest.raises(ValueError, match="must equal the cache capacity "
                                         "max_len=6"):
        mha(xb, cache=cache, time_step=1,
            attn_mask=torch.ones(1, 1, 1, 3, dtype=torch.bool))
    with pytest.raises(ValueError, match="must equal the cache capacity"):
        mha(xb, cache=cache, time_step=torch.tensor([0, 1]),
            attn_mask=torch.ones(1, 1, 1, 3, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="need_weights"):
        tinc.nn.FusedMultiHeadAttention(16, 4, need_weights=True)
    with pytest.raises(NotImplementedError, match="ParamAttr"):
        tinc.nn.FusedMultiHeadAttention(16, 4, qkv_weight_attr="w")
    with pytest.raises(NotImplementedError, match="pre-LN"):
        tinc.nn.FusedMultiTransformer(16, 4, 32, num_layers=1,
                                      normalize_before=False)
    with pytest.raises(ValueError, match="num_layers"):
        tinc.nn.FusedMultiTransformer(16, 4, 32)
