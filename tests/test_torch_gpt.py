"""GPT-2 of the PyTorch port (paddle_tpu_torch/models/gpt.py) against the
JAX package's: weights carried across with gpt_from_jax_params, logits
compared on the CPU. Tolerance: float32 atol 1e-4 on the logits (the same
math in another summation order, over 2 blocks)."""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import GPTConfig as JaxGPTConfig
from paddle_tpu.models import GPTForPretraining as JaxGPT
from paddle_tpu.nn.layer.layers import get_params_tree
from paddle_tpu_torch import seed
from paddle_tpu_torch.convert import gpt_from_jax_params
from paddle_tpu_torch.models import GPTConfig, GPTForPretraining
from paddle_tpu_torch.nn import MultiHeadAttention


def _jax_model(seed=0, cfg=None):
    paddle.seed(seed)
    model = JaxGPT(cfg or JaxGPTConfig.tiny())
    model.eval()
    params = {k: np.asarray(v) for k, v in get_params_tree(model).items()}
    return model, params


def test_config_matches_jax():
    for name in ("gpt2_small", "tiny"):
        assert dataclasses.asdict(getattr(GPTConfig, name)()) == \
            dataclasses.asdict(getattr(JaxGPTConfig, name)())


def test_gpt_from_jax_params_round_trip():
    _, params = _jax_model(1)
    model = gpt_from_jax_params(params, GPTConfig.tiny(), device="cpu")
    state = model.state_dict()
    assert set(state) == set(params)
    for key, arr in params.items():
        got = state[key].numpy()
        if key.endswith("proj.weight") or key.endswith("mlp_fc.weight"):
            got = got.T                  # torch [out, in] -> JAX [in, out]
        np.testing.assert_array_equal(got, arr, err_msg=key)


def test_gpt_from_jax_params_rejects_bad_trees():
    _, params = _jax_model(1)
    cfg = GPTConfig.tiny()
    with pytest.raises(KeyError, match="missing"):
        gpt_from_jax_params({k: v for k, v in params.items()
                             if k != "gpt.ln_f.bias"}, cfg, device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        gpt_from_jax_params(dict(params, extra=np.zeros(1)), cfg,
                            device="cpu")
    bad = dict(params)
    bad["gpt.blocks.0.mlp_fc.weight"] = bad["gpt.blocks.0.mlp_fc.weight"].T
    with pytest.raises(ValueError, match="mlp_fc.weight"):
        gpt_from_jax_params(bad, cfg, device="cpu")


@pytest.mark.parametrize("batch,seq", [(2, 16), (1, 37)])
def test_tiny_logits_match_jax(batch, seq):
    jmodel, params = _jax_model(2)
    cfg = GPTConfig.tiny()
    ids = np.random.RandomState(seq).randint(0, cfg.vocab_size,
                                             (batch, seq))
    want = jmodel(paddle.to_tensor(ids)).numpy()
    model = gpt_from_jax_params(params, cfg, device="cpu").eval()
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    assert got.shape == (batch, seq, cfg.vocab_size)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_seeded_init_is_reproducible_and_jax_shaped():
    cfg = GPTConfig.tiny()
    seed(3)
    a = GPTForPretraining(cfg).state_dict()
    seed(3)
    b = GPTForPretraining(cfg).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    _, params = _jax_model(0)
    for key, arr in params.items():
        shape = tuple(a[key].shape)
        if a[key].ndim == 2 and not key.endswith(("wte.weight",
                                                  "wpe.weight")):
            shape = shape[::-1]
        assert shape == arr.shape, key
    assert torch.all(a["gpt.ln_f.weight"] == 1)
    assert torch.all(a["gpt.blocks.0.mlp_fc.bias"] == 0)


def test_head_split_merge_and_loss_path():
    mha = MultiHeadAttention(64, 4)
    x = torch.randn(2, 5, 64)
    h = mha._split_heads(x)
    assert tuple(h.shape) == (2, 5, 4, 16)
    assert torch.equal(mha._merge_heads(h), x)
    with pytest.raises(ValueError, match="divisible"):
        MultiHeadAttention(64, 5)
    model = GPTForPretraining(GPTConfig.tiny())
    loss, logits = model(torch.zeros(1, 4, dtype=torch.long),
                         labels=torch.zeros(1, 4, dtype=torch.long))
    assert loss.dim() == 0 and torch.isfinite(loss)
    assert tuple(logits.shape) == (1, 4, GPTConfig.tiny().vocab_size)
