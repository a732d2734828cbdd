"""The sampling truncation of the PyTorch port
(paddle_tpu_torch/models/generation.py ``_filter_logits``) against the
JAX package's (paddle_tpu/models/generation.py ``_filter_logits``).

bf16 logits over GPT-2's 50304-token vocabulary tie often, and top-p
keeps a prefix of the logits sorted in descending order, so which of the
tied tokens survive the cutoff depends on the sort's order among equal
values. ``jnp.argsort(-logits)`` is stable (ties in ascending index
order); the port must keep the same support. Tokens whose exclusive
cumulative probability lies within f32 rounding (1e-6) of ``top_p`` are
excluded from the comparison: the two frameworks sum the cumulative
probabilities in different orders, so such a token may fall on either
side of the cutoff.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.generation import _filter_logits as jax_filter
from paddle_tpu_torch.models.generation import _filter_logits

VOCAB = 50304
NEAR = 1e-6          # f32 rounding of a cumulative sum of probabilities


def _bf16_logits(seed, scale):
    """[4, VOCAB] float32 logits holding bf16 values, from a numpy seed."""
    x = np.random.RandomState(seed).randn(4, VOCAB).astype(np.float32)
    return torch.from_numpy(x * scale).to(torch.bfloat16).float().numpy()


def _near_cutoff(logits, top_k, top_p):
    """Tokens whose exclusive cumulative probability, in float64 over the
    stable descending order, lies within NEAR of ``top_p``."""
    x = logits.astype(np.float64)
    if top_k:
        kth = np.sort(x, axis=-1)[:, -top_k][:, None]
        x = np.where(x < kth, -np.inf, x)
    order = np.argsort(-x, axis=-1, kind="stable")
    s = np.take_along_axis(x, order, axis=-1)
    p = np.exp(s - s[:, :1])
    p /= p.sum(axis=-1, keepdims=True)
    near_sorted = np.abs(np.cumsum(p, axis=-1) - p - top_p) <= NEAR
    near = np.zeros_like(near_sorted)
    np.put_along_axis(near, order, near_sorted, axis=-1)
    return near


@pytest.mark.parametrize("scale", [3.0, 10.0])
@pytest.mark.parametrize("top_p", [0.5, 0.9])
@pytest.mark.parametrize("top_k", [0, 1000])
def test_top_p_keeps_the_reference_support_on_tied_bf16_logits(scale, top_p,
                                                               top_k):
    logits = _bf16_logits(int(scale * 10 + top_p * 100) + top_k, scale)
    # ties are what the test is about: make sure the rows have them
    assert all(len(np.unique(r)) < VOCAB // 4 for r in logits)
    want = np.isfinite(np.asarray(jax_filter(jnp.asarray(logits), top_k,
                                             top_p, jnp.float32(1.0))))
    got = np.isfinite(_filter_logits(torch.from_numpy(logits), top_k, top_p,
                                     torch.tensor(1.0)).numpy())
    assert want.any(axis=-1).all() and got.any(axis=-1).all()
    differ = (got != want) & ~_near_cutoff(logits, top_k, top_p)
    assert not differ.any(), (
        f"{int(differ.sum())} tokens kept by one side only, in rows "
        f"{np.nonzero(differ.any(axis=-1))[0].tolist()}")


def test_top_p_keeps_tied_logits_in_ascending_index_order():
    """Four equal logits and top_p = 0.4: exactly the first two by index
    survive (each holds 0.25 of the mass), in both packages."""
    logits = np.zeros((1, 8), np.float32)
    logits[0, [1, 3, 5, 6]] = 5.0
    logits[0, [0, 2, 4, 7]] = -30.0
    want = np.isfinite(np.asarray(jax_filter(jnp.asarray(logits), 0, 0.4,
                                             jnp.float32(1.0))))
    got = np.isfinite(_filter_logits(torch.from_numpy(logits), 0, 0.4,
                                     torch.tensor(1.0)).numpy())
    assert np.nonzero(want[0])[0].tolist() == [1, 3]
    np.testing.assert_array_equal(got, want)
