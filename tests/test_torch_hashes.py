"""PyTorch port: XXH64 and the Util::hash sequence hash on int64 tensors,
exactly equal to the JAX package's numpy and jnp versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plass_tpu.ops.hashes import seq_hash_batch_np, xxh64_u64_jnp, xxh64_u64_np
from plass_tpu_torch.ops.hashes import seq_hash_torch, xxh64_u64_torch


@pytest.mark.parametrize("seed", [0, 67, 68, 2**40 + 3])
def test_xxh64_matches_reference(seed):
    rng = np.random.default_rng(seed % 1000)
    v = rng.integers(0, 2**64, 20000, dtype=np.uint64)
    v[:4] = [0, 1, 2**63, 2**64 - 1]   # the top bit set and clear
    got = xxh64_u64_torch(torch.from_numpy(v.view(np.int64)), seed) \
        .numpy().view(np.uint64)
    np.testing.assert_array_equal(got, xxh64_u64_np(v, seed))
    np.testing.assert_array_equal(
        got, np.asarray(xxh64_u64_jnp(jnp.asarray(v), seed)))


def test_seq_hash_matches_reference():
    """h = h*31 + x wraps mod 2^64 for long rows; empty rows hash to 0."""
    rng = np.random.default_rng(5)
    seqs = rng.integers(0, 13, (64, 400)).astype(np.uint8)
    lengths = rng.integers(0, 401, 64).astype(np.int32)
    lengths[:3] = [0, 1, 400]
    got = seq_hash_torch(torch.from_numpy(seqs), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  seq_hash_batch_np(seqs, lengths))
