"""Ragged paged attention of the PyTorch port
(paddle_tpu_torch/ops/ragged_paged_attention.py) against the JAX package:
the host row layout array for array, and the port's plain version
against the JAX Pallas kernel (interpret mode on the CPU) and the numpy
oracle on random ragged mixed batches over random page tables.

On the CPU the port's wrapper runs its plain version; the CUDA kernel
itself is checked on the card by chip_smoke.py and tests/test_torch_cuda.py.
Tolerances: float32 atol 2e-5 (the JAX suite's own for this kernel);
bfloat16 storage 0.08 against the float32 oracle (bf16 inputs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

ATOL = 2e-5


def _random_case(rng, *, L=2, H=3, BS=8, DH=16, S=4, T=4, NB=24):
    """A ragged batch over a random page table: one decode row, chunk
    tails, one absent sequence."""
    pool = rng.randn(L, 2, NB + 1, H, BS, DH).astype(np.float32)
    tables = np.zeros((S, T), np.int32)
    q_lens, pos0s, kv_lens = [], [], []
    free = list(range(1, NB + 1))
    rng.shuffle(free)
    for s in range(S):
        if s == S - 1:                  # one absent sequence
            q_lens.append(0), pos0s.append(0), kv_lens.append(0)
            continue
        kv = int(rng.randint(1, T * BS + 1))
        q = 1 if s == 0 else int(rng.randint(1, kv + 1))
        nblk = -(-kv // BS)
        tables[s, :nblk] = [free.pop() for _ in range(nblk)]
        q_lens.append(q)
        pos0s.append(kv - q)
        kv_lens.append(kv)
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout(q_lens, pos0s)
    q = rng.randn(H, len(blk_seq) * 8, DH).astype(np.float32)
    meta = (blk_seq, qstart, pos0, tables, np.zeros(S, np.int32),
            np.asarray(kv_lens, np.int32))
    return q, pool, int(rng.randint(0, L)), meta, q_lens, pos0s


def _real_rows(out, meta, q_lens):
    qstart = meta[1]
    return np.stack([np.asarray(out, np.float32)[:, qstart[s] + i, :]
                     for s in range(len(q_lens)) for i in range(q_lens[s])])


def _oracle(q, pool, layer, meta, q_lens, pos0s):
    rows, row_seq, row_pos = [], [], []
    for s, n in enumerate(q_lens):
        for i in range(n):
            rows.append(q[:, meta[1][s] + i, :])
            row_seq.append(s)
            row_pos.append(pos0s[s] + i)
    return trpa.reference_ragged_attention(
        np.stack(rows), pool, layer, row_seq, row_pos,
        [list(t) for t in meta[3]], meta[4])


@pytest.mark.parametrize("q_lens,pos0s,q_bucket", [
    ([1, 0, 9], [4, 0, 2], 32),
    ([20], [0], 0),
    ([1, 1, 1, 1], [3, 7, 0, 12], 0),
    ([0, 0, 5], [0, 0, 9], 8),
    ([17, 3, 0, 8, 1], [0, 40, 0, 2, 63], 64),
])
def test_ragged_layout_matches_jax(q_lens, pos0s, q_bucket):
    got = trpa.ragged_layout(q_lens, pos0s, q_bucket=q_bucket)
    want = jrpa.ragged_layout(q_lens, pos0s, q_bucket=q_bucket)
    assert got[4] == want[4]
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_ragged_layout_rejects_bad_buckets_like_jax():
    with pytest.raises(ValueError, match="multiple of block_q"):
        trpa.ragged_layout([1], [0], q_bucket=12)
    with pytest.raises(ValueError, match="cannot hold"):
        trpa.ragged_layout([9, 9], [0, 0], q_bucket=16)


@pytest.mark.parametrize("seed", [3, 4, 5, 6])
def test_plain_matches_jax_kernel_and_oracle(seed):
    q, pool, layer, meta, q_lens, pos0s = _random_case(
        np.random.RandomState(seed))
    want = np.asarray(jrpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(pool), layer, *meta))
    got = trpa.ragged_paged_attention(
        torch.from_numpy(q), torch.from_numpy(pool), layer, *meta)
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    # every row, pad rows of real blocks and pad blocks included: the
    # plain version walks whole blocks exactly as both kernels do
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    ref = _oracle(q, pool, layer, meta, q_lens, pos0s)
    np.testing.assert_allclose(_real_rows(got, meta, q_lens), ref,
                               atol=ATOL, rtol=0)


def test_pad_blocks_are_zero_and_metadata_may_be_tensors():
    q, pool, layer, meta, q_lens, _ = _random_case(np.random.RandomState(8))
    blk = np.concatenate([meta[0], [-1, -1]]).astype(np.int32)
    qp = np.concatenate([q, np.ones((q.shape[0], 16, q.shape[2]),
                                    np.float32)], axis=1)
    out = trpa.ragged_paged_attention(
        torch.from_numpy(qp), torch.from_numpy(pool), layer,
        torch.from_numpy(blk), *map(torch.from_numpy, meta[1:]))
    assert torch.all(out[:, -16:] == 0)
    np.testing.assert_allclose(
        out[:, :q.shape[1]].numpy(),
        trpa.ragged_paged_attention(torch.from_numpy(q),
                                    torch.from_numpy(pool), layer,
                                    *meta).numpy(), atol=0, rtol=0)


def test_multi_block_chunk_is_causal():
    """A 20-row chunk spans 3 q blocks; every row sees its own prefix."""
    rng = np.random.RandomState(7)
    H, BS, DH = 2, 8, 16
    pool = rng.randn(1, 2, 5, H, BS, DH).astype(np.float32)
    tables = np.array([[1, 2, 3, 4]], np.int32)
    blk_seq, qstart, pos0, _, _ = trpa.ragged_layout([20], [0])
    q = rng.randn(H, len(blk_seq) * 8, DH).astype(np.float32)
    meta = (blk_seq, qstart, pos0, tables, np.zeros(1, np.int32),
            np.asarray([20], np.int32))
    out = trpa.ragged_paged_attention(torch.from_numpy(q),
                                      torch.from_numpy(pool), 0, *meta)
    ref = trpa.reference_ragged_attention(
        q[:, :20, :].transpose(1, 0, 2), pool, 0, [0] * 20, list(range(20)),
        [list(tables[0])], np.zeros(1, np.int32))
    np.testing.assert_allclose(out.numpy()[:, :20, :],
                               ref.transpose(1, 0, 2), atol=ATOL, rtol=0)


def test_bfloat16_storage_stays_close():
    q, pool, layer, meta, q_lens, pos0s = _random_case(
        np.random.RandomState(5))
    qb = torch.from_numpy(q).to(torch.bfloat16)
    pb = torch.from_numpy(pool).to(torch.bfloat16)
    got = trpa.ragged_paged_attention(qb, pb, layer, *meta)
    assert got.dtype == torch.bfloat16
    ref = _oracle(qb.float().numpy(), pb.float().numpy(), layer, meta,
                  q_lens, pos0s)
    np.testing.assert_allclose(_real_rows(got.float(), meta, q_lens), ref,
                               atol=0.08, rtol=0.08)
    before = trpa.ragged_paged_attention.launches
    trpa.ragged_paged_attention(qb, pb, layer, *meta)
    assert trpa.ragged_paged_attention.launches == before   # plain: no launch


@pytest.mark.parametrize("case,match", [
    ("block_size", "block_size 4 < 8"),
    ("rows", "multiple of block_q"),
    ("heads", "heads/head_dim"),
    ("layer", "out of range"),
])
def test_validation_errors(case, match):
    q = torch.zeros(2, 8, 16)
    pool = torch.zeros(1, 2, 3, 2, 8, 16)
    layer = 0
    if case == "block_size":
        pool = torch.zeros(1, 2, 3, 2, 4, 16)
    elif case == "rows":
        q = torch.zeros(2, 12, 16)
    elif case == "heads":
        pool = torch.zeros(1, 2, 3, 3, 8, 16)
    else:
        layer = 1
    z = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match=match):
        trpa.ragged_paged_attention(q, pool, layer, z, z, z,
                                    np.zeros((1, 1), np.int32), z, z)
