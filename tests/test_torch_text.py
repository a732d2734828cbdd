"""``paddle_tpu_torch.text`` against the JAX package's ``text``, on the CPU.

``viterbi_decode`` on potentials ``[3, 7, 5]`` and transitions ``[5,
5]`` from a seed, lengths 7, 4 and 1, with and without the BOS/EOS tags:
the paths equal (int64, 0 past each length) and the scores within 1e-5;
the scores' gradients in the potentials and the transitions within
1e-5. ``ViterbiDecoder`` gives the function's result. The download-driven
datasets raise as the JAX ones do, and the top-level ``text`` is the
module.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.text as jtext
import paddle_tpu_torch as pt
from paddle_tpu_torch import text as ttext

TOL = 1e-5


def _inputs():
    rs = np.random.RandomState(12)
    return (rs.randn(3, 7, 5).astype(np.float32),
            rs.randn(5, 5).astype(np.float32),
            np.array([7, 4, 1], np.int64))


@pytest.mark.parametrize("tags", [True, False], ids=["bos_eos", "plain"])
def test_viterbi_matches_jax(tags):
    pot, trans, lens = _inputs()
    jp = paddle.to_tensor(pot, stop_gradient=False)
    jt = paddle.to_tensor(trans, stop_gradient=False)
    js, jpath = jtext.viterbi_decode(jp, jt, paddle.to_tensor(lens), tags)
    tp = torch.tensor(pot, requires_grad=True)
    tt = torch.tensor(trans, requires_grad=True)
    ts, tpath = ttext.viterbi_decode(tp, tt, torch.from_numpy(lens), tags)
    assert tpath.dtype == torch.int64
    np.testing.assert_array_equal(tpath.numpy(), jpath.numpy())
    np.testing.assert_allclose(ts.detach().numpy(), js.numpy(), atol=TOL,
                               rtol=TOL)
    js.sum().backward()
    ts.sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(), atol=TOL)
    np.testing.assert_allclose(tt.grad.numpy(), jt.grad.numpy(), atol=TOL)


def test_viterbi_decoder_layer_gives_the_function():
    pot, trans, lens = _inputs()
    layer = ttext.ViterbiDecoder(torch.from_numpy(trans), False)
    got = layer(torch.from_numpy(pot), torch.from_numpy(lens))
    want = ttext.viterbi_decode(torch.from_numpy(pot),
                                torch.from_numpy(trans),
                                torch.from_numpy(lens), False)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("name", ["Conll05st", "Imdb", "Imikolov",
                                  "Movielens", "UCIHousing", "WMT14",
                                  "WMT16"])
def test_download_datasets_raise_as_jax(name):
    with pytest.raises(RuntimeError, match="no network egress"):
        getattr(jtext, name)()
    with pytest.raises(RuntimeError, match="no network egress"):
        getattr(ttext, name)(mode="train")


def test_top_level_text_is_the_module():
    assert pt.text is ttext
    assert set(ttext.__all__) == set(jtext.__all__)


def test_numpy_inputs_go_to_the_current_place():
    pot, trans, lens = _inputs()
    old = pt.get_device()
    try:
        pt.set_device("cpu")
        scores, paths = ttext.viterbi_decode(pot, trans, lens)
        assert scores.device.type == paths.device.type == "cpu"
        pt.set_device("gpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ttext.viterbi_decode(pot, trans, lens)
    finally:
        pt.set_device(old)
