"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and the ``nvcc`` that builds the
kernels; on a host without one each skips. This file imports neither jax
nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: float32 atol 1e-4; bfloat16 atol 2e-2 + rtol 1e-2 (one bf16
ulp of the output, after upcasting).
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import layer_norm as ln
from paddle_tpu_torch.ops import ragged_paged_attention as rpa

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(atol=1e-4, rtol=0),
       torch.bfloat16: dict(atol=2e-2, rtol=1e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 8, 300])
def test_layer_norm_kernel_matches_plain(cuda, dtype, rows):
    g = torch.Generator(device=cuda).manual_seed(rows)
    x = torch.randn(rows, 768, device=cuda, generator=g).to(dtype)
    w = (1 + 0.1 * torch.randn(768, device=cuda, generator=g)).to(dtype)
    b = (0.1 * torch.randn(768, device=cuda, generator=g)).to(dtype)
    before = ln.fused_layer_norm.launches
    got = ln.fused_layer_norm(x, w, b)
    torch.cuda.synchronize()
    assert ln.fused_layer_norm.launches == before + 1
    torch.testing.assert_close(got.float(),
                               ln.layer_norm_plain(x, w, b).float(),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_attention_kernel_matches_plain(cuda, dtype):
    rng = np.random.RandomState(0)
    L, H, bs, Dh, S, T = 2, 12, 16, 64, 5, 8
    nb = S * T
    pool = torch.from_numpy(rng.randn(L, 2, nb + 1, H, bs, Dh)
                            .astype(np.float32)).to(cuda, dtype)
    tables = np.zeros((S, T), np.int32)
    free = rng.permutation(np.arange(1, nb + 1)).tolist()
    q_lens, pos0s, kv_lens = [], [], []
    for s in range(S):
        kv = int(rng.randint(1, T * bs + 1))
        q = 0 if s == 2 else 1 if s % 2 == 0 else int(rng.randint(1, kv + 1))
        nblk = -(-kv // bs)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(kv - q)
        kv_lens.append(kv if q else 0)
    # two pad blocks past the content
    qp = (len(rpa.ragged_layout(q_lens, pos0s)[0]) + 2) * 8
    blk_seq, qstart, pos0, _, _ = rpa.ragged_layout(q_lens, pos0s,
                                                    q_bucket=qp)
    q = torch.from_numpy(rng.randn(H, qp, Dh).astype(np.float32)).to(
        cuda, dtype)
    meta = [torch.from_numpy(np.asarray(a, np.int32)).to(cuda)
            for a in (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
                      kv_lens)]
    got = rpa.ragged_paged_attention(q, pool, 1, *meta)
    torch.cuda.synchronize()
    want = rpa.ragged_paged_attention_plain(q, pool, 1, *meta)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert torch.all(got[:, qp - 16:] == 0)


def test_ragged_attention_rejects_host_metadata(cuda):
    q = torch.zeros(2, 8, 16, device=cuda)
    pool = torch.zeros(1, 2, 3, 2, 8, 16, device=cuda)
    z = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match="int32 tensor"):
        rpa.ragged_paged_attention(q, pool, 0, z, z, z,
                                   np.zeros((1, 1), np.int32), z, z)
