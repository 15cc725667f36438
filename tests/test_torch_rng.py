"""The port's counter-based generator (ops/kernels/rng.py): Philox4x32-10
against Random123's known-answer vectors, the uniforms and normals drawn
from it, the key split, and the MPPI stream's counter layout. The device
copy (csrc/philox.cuh) is held to it bit for bit on the card by
chip_smoke.py.
"""

import math

import numpy as np
import pytest
import torch

from differentiable_robot_model_tpu_torch.ops.kernels import rng

# Random123's kat_vectors for philox4x32_10: (counter, key, output).
KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter, key, expect", KAT, ids=["zeros", "ones", "pi"])
def test_philox_matches_random123_known_answers(counter, key, expect):
    assert tuple(int(w) for w in rng.philox4x32(counter, key)) == expect


def test_philox_on_tensors_matches_word_by_word():
    """The vectorised form (tensor counters and keys broadcasting) gives
    the scalar form's words."""
    g = np.random.default_rng(0)
    ctr = torch.from_numpy(g.integers(0, 2**32, (4, 16), dtype=np.int64))
    keys = torch.from_numpy(g.integers(0, 2**32, (2, 16), dtype=np.int64))
    words = rng.philox4x32(tuple(ctr), tuple(keys))
    for i in range(16):
        one = rng.philox4x32(tuple(int(c) for c in ctr[:, i]), tuple(int(k) for k in keys[:, i]))
        assert [int(w[i]) for w in words] == [int(w) for w in one]


def test_uniforms_stay_inside_the_open_interval():
    """24-bit uniforms (bits >> 8) 2^-24 + 2^-25: never 0 or 1 in float64,
    at the extreme bits too; in float32 the same values rounded (the top one
    rounds to 1, as the TPU kernel's does), never 0."""
    g = np.random.default_rng(1)
    bits = torch.from_numpy(np.concatenate([[0, 255, 256, 2**32 - 1],
                                            g.integers(0, 2**32, 4096, dtype=np.int64)]))
    u64 = rng.uniform(bits, torch.float64)
    assert torch.all(u64 > 0) and torch.all(u64 < 1)
    assert u64[0].item() == 2.0**-25 and u64[3].item() == 1 - 2.0**-25
    u32 = rng.uniform(bits, torch.float32)
    assert torch.all(u32 > 0) and torch.all(u32 <= 1)
    assert torch.equal(u32, u64.to(torch.float32))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_normals_have_unit_moments(dtype):
    """Mean and variance of 8192 normals of one MPPI iteration, within five
    standard errors of 0 and 1."""
    z = rng.mppi_normals(2024, 4, 0, 16, 8, 32, dtype).double().flatten()
    n = z.numel()
    assert abs(z.mean().item()) < 5 / math.sqrt(n)
    assert abs(z.var().item() - 1) < 5 * math.sqrt(2 / n)
    assert torch.all(torch.isfinite(z))


def test_mppi_stream_counter_layout():
    """Entry (h, d) of scenario b, sample k, iteration t is the normal of
    Philox((b, t, (h D + d) // 2, k)) under the key: words 0, 1 for an even
    h D + d, words 2, 3 for an odd one (D odd, so pairs straddle steps)."""
    H, D, B, K, t, key = 3, 5, 2, 4, 7, 0xDEADBEEF12345678
    z = rng.mppi_normals(key, B, t, H, D, K, torch.float64)
    assert z.shape == (H, D, B, K)
    k0, k1 = rng.key_words(key)
    for h in range(H):
        for d in range(D):
            i = h * D + d
            for b in range(B):
                for k in range(K):
                    w = rng.philox4x32((b, t, i // 2, k), (k0, k1))
                    pair = (w[0], w[1]) if i % 2 == 0 else (w[2], w[3])
                    expect = rng.box_muller(*pair, torch.float64)
                    assert z[h, d, b, k].item() == expect.item()


def test_keys_split_deterministically_into_distinct_keys():
    key = rng.prng_key(5)
    assert key.tolist() == [5, 0] and rng.key_words(key) == (5, 0)
    assert rng.key_words(2**64 - 1) == (2**32 - 1, 2**32 - 1)
    a, b = rng.split_key(key)
    assert torch.equal(rng.split_key(key), torch.stack([a, b]))
    assert not torch.equal(a, b) and not torch.equal(a, key)
    many = rng.split_key(key, 5)
    assert torch.equal(many[:2], torch.stack([a, b]))
    assert len({tuple(x) for x in many.tolist()}) == 5
    batch = rng.split_key(torch.stack([key, rng.prng_key(6)]))
    assert batch.shape == (2, 2, 2) and torch.equal(batch[0], rng.split_key(key))
    with pytest.raises(ValueError, match="64-bit"):
        rng.key_words(-1)
    with pytest.raises(ValueError, match="shape"):
        rng.key_words(torch.zeros(3, dtype=torch.int64))
