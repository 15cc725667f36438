"""The counter-based generator of the MPPI noise: Philox4x32-10 in plain
PyTorch, bit for bit the device code of csrc/philox.cuh, and the normals
drawn from it.

The JAX package's MPPI kernel draws its noise from the TPU's on-core
generator (ops/pallas/solver.py `_uniforms` / `_normal_tile`), and its
XLA path from threefry; neither exists here. Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011; the Random123
constants) maps a 128-bit counter and a 64-bit key to 128 random bits with
no state, so the kernel and this plain version compute the same bits for
the same (counter, key).

The MPPI stream's layout, fixed once (csrc/philox.cuh holds the same):

    key     = the solve's 64-bit key, words (k0, k1) = (low, high)
    counter = (scenario, iteration, (h*D + d) // 2, sample)
    words 0, 1 -> the normal of the even entry h*D + d, words 2, 3 -> the odd

or, keyed per scenario (keys [B, 2], one a scenario: `scenario_keys`),
scenario b draws under keys[b] at scenario word 0, the stream a
one-scenario solve under keys[b] draws, wherever b sits in the batch (so a
scenario draws the same noise on any number of ranks).

A uniform is `(bits >> 8) * 2^-24 + 2^-25` in the working type, as
`_uniforms` makes it (24 random bits; in float32 the top value rounds to 1,
as on the TPU), and a normal is `sqrt(-2 log u1) * cos(2 pi u2)`, the
cosine half of Box-Muller, as `_normal_tile` makes it. Sample 0 of every
scenario is the unperturbed nominal: the solvers zero its noise.

Keys are int64 tensors whose last axis holds the two 32-bit words; they
live on the CPU (`prng_key`, `split_key`); per-scenario keys may live on
the device. Nothing here keeps a global state.

Torch has no unsigned 32x32 -> 64-bit product that fits int64, so the
multiplies are built from 16-bit limbs, each partial product below 2^34.
"""

from __future__ import annotations

import math

import torch

PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57  # the round multipliers
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85  # the Weyl key increments
PHILOX_ROUNDS = 10
MASK32 = 0xFFFFFFFF
_SPLIT_COUNTER = (MASK32,) * 4  # no MPPI counter reaches iteration 2^32 - 1


def _mulhilo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of a * m for a in [0, 2^32) (int64) and the
    constant m, from 16-bit limbs."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    m_hi, m_lo = m >> 16, m & 0xFFFF
    t = a_lo * m_lo
    mid = a_hi * m_lo + a_lo * m_hi + (t >> 16)
    return a_hi * m_hi + (mid >> 16), ((mid & 0xFFFF) << 16) | (t & 0xFFFF)


def philox4x32(counter, key):
    """Philox4x32-10 of the counter words (c0, c1, c2, c3) under the key
    words (k0, k1). Each word is an int64 tensor (or int) in [0, 2^32); they
    broadcast together. Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The uniform of 32 random bits: (bits >> 8) 2^-24 + 2^-25."""
    return (bits >> 8).to(dtype) * 2.0**-24 + 2.0**-25


def box_muller(w1: torch.Tensor, w2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The standard normal sqrt(-2 log u1) cos(2 pi u2) of two random words."""
    u1, u2 = uniform(w1, dtype), uniform(w2, dtype)
    two_pi = torch.tensor(2.0 * math.pi, dtype=dtype, device=u2.device)
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)


def key_words(key) -> tuple[int, int]:
    """(k0, k1) of a key: an int in [0, 2^64) or a tensor of two words."""
    if isinstance(key, int):
        if not 0 <= key < 2**64:
            raise ValueError(f"a key is a 64-bit unsigned int, got {key}")
        return key & MASK32, key >> 32
    k = torch.as_tensor(key)
    if k.shape != (2,) or k.dtype != torch.int64:
        raise ValueError(f"a key tensor is int64 of shape [2], got {k.dtype} {tuple(k.shape)}")
    k0, k1 = (int(x) for x in k.tolist())
    if not (0 <= k0 <= MASK32 and 0 <= k1 <= MASK32):
        raise ValueError(f"key words must be 32-bit unsigned, got {k0}, {k1}")
    return k0, k1


def per_scenario(key) -> bool:
    """Whether `key` is one key a scenario ([B, 2]) rather than one key."""
    return isinstance(key, torch.Tensor) and key.dim() == 2


def scenario_keys(keys: torch.Tensor, n_scenarios: int) -> torch.Tensor:
    """Checks per-scenario keys, int64 [B, 2] with B = n_scenarios, and
    returns them. Their words are checked to be 32-bit unsigned where they
    lie on the CPU; on the device that would read them back to the host,
    and only their low 32 bits are used."""
    if keys.dtype != torch.int64 or tuple(keys.shape) != (n_scenarios, 2):
        raise ValueError(f"per-scenario keys are int64 [{n_scenarios}, 2], got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if keys.device.type == "cpu" and keys.numel() and not bool(
            ((keys >= 0) & (keys <= MASK32)).all()):
        raise ValueError("key words must be 32-bit unsigned")
    return keys


def prng_key(seed: int) -> torch.Tensor:
    """A key from a 64-bit seed: int64 [2] on the CPU."""
    return torch.tensor(key_words(int(seed)), dtype=torch.int64)


def split_key(key: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """New keys from keys [..., 2], by Philox at a counter no noise draw
    uses: with n None, [..., 2, 2] (two keys each, as `jax.random.split`'s
    default); else [..., n, 2]."""
    key = torch.as_tensor(key, dtype=torch.int64).cpu()
    count = 2 if n is None else n
    k0, k1 = key[..., 0, None], key[..., 1, None]
    block = torch.arange((count + 1) // 2, dtype=torch.int64)
    w = philox4x32((block, *_SPLIT_COUNTER[1:]), (k0, k1))
    words = torch.stack([torch.stack(w[:2], -1), torch.stack(w[2:], -1)], -2)  # [..., blocks, 2, 2]
    return words.reshape(key.shape[:-1] + (-1, 2))[..., :count, :]


def mppi_normals(key, n_scenarios: int, iteration: int, horizon: int, n_dofs: int,
                 n_samples: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """The standard normals of one MPPI iteration, [H, D, B, K], from the
    stream laid out in this module's docstring under one key (scenario b
    at scenario word b) or per-scenario keys [B, 2] (scenario b under
    keys[b] at scenario word 0); sample 0 included: the solvers zero it."""
    HD = horizon * n_dofs
    pairs = (HD + 1) // 2
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=device)
    if per_scenario(key):
        kw = scenario_keys(key, n_scenarios).to(device)
        k0, k1, b = kw[:, 0, None, None], kw[:, 1, None, None], 0
    else:
        k0, k1 = key_words(key)
        b = ar(n_scenarios)[:, None, None]
    p = ar(pairs)[None, :, None]
    k = ar(n_samples)[None, None, :]
    w0, w1, w2, w3 = philox4x32((b, iteration & MASK32, p, k), (k0, k1))
    z = torch.stack([box_muller(w0, w1, dtype), box_muller(w2, w3, dtype)], dim=2)  # [B, P, 2, K]
    z = z.reshape(n_scenarios, 2 * pairs, n_samples)[:, :HD]
    return z.reshape(n_scenarios, horizon, n_dofs, n_samples).permute(1, 2, 0, 3)
