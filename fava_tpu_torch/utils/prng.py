"""Counter-based PRNG: Threefry-2x32-20, word for word fava_tpu's.

Counterpart of fava_tpu/utils/prng.py (Salmon et al. 2011, the cipher
behind ``jax.random``'s default). ``(seed, stream, position)`` fully
determine every sample, with no sequential state, so the port draws the
same words as fava_tpu: the structure functions and the increment PDFs
sample the same point pairs in both packages. Streams decorrelate
independent draws that share a seed.

torch has no uint32 arithmetic on the CPU (add, shifts and remainder
raise NotImplementedError), so the words are int64 tensors holding values
in [0, 2^32), masked after each add and left shift. Seeds are host
integers (a Python int or a ``(hi, lo)`` pair of 32-bit words); there is
no traced form, as nothing here is jitted.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
# The Threefry-2x32 rotation schedule (Random123 reference).
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """Threefry-2x32, 20 rounds, on 32-bit words held as Python ints or
    int64 tensors (broadcasting); returns the two output words in [0,
    2^32).

    Random123 known-answer vector (zero key, zero counter):

    >>> x0, x1 = threefry2x32(0, 0, 0, 0)
    >>> (hex(int(x0)), hex(int(x1)))
    ('0x6b200159', '0x99ba4efe')
    """
    ks = (k0 & _MASK, k1 & _MASK, (k0 ^ k1 ^ _PARITY) & _MASK)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for d in range(5):
        for r in _ROTATIONS[d % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & _MASK
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & _MASK
    return x0, x1


def _key(seed) -> Tuple[int, int]:
    """64-bit seed -> (hi, lo) 32-bit key words: jax.random.PRNGKey's split
    (hi = seed >> 32, lo = the low word) of a Python int taken mod 2^64,
    or a pre-split ``(hi, lo)`` pair."""
    if isinstance(seed, tuple):
        hi, lo = seed
        return int(hi) & _MASK, int(lo) & _MASK
    if isinstance(seed, (int, np.integer)) and not isinstance(seed, bool):
        s = int(seed) % (1 << 64)
        return s >> 32, s & _MASK
    raise TypeError(f"seed must be an int or a (hi, lo) pair of words, got {type(seed).__name__}")


def random_bits(seed, stream: Word, shape, device="cpu") -> torch.Tensor:
    """Random 32-bit words of ``shape`` (int64 tensor on ``device``): word
    i is Threefry of counter (i, stream) under the seed's key. ``stream``
    (an int, or an int64 tensor broadcasting against ``shape``) selects an
    independent sequence for the same seed."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape)) if shape else 1
    if n >= (1 << 32):
        raise ValueError(f"shape {shape} exceeds the 2^32 counter space of one stream")
    k0, k1 = _key(seed)
    ctr = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    if isinstance(stream, torch.Tensor):
        stream = stream.to(device=device, dtype=torch.int64)
    x0, _ = threefry2x32(k0, k1, ctr, stream)
    return x0


def uniform(seed, stream: Word, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Uniform [0, 1) samples: 23 random bits as a float32 in [1, 2), less
    1, cast to ``dtype``."""
    bits = random_bits(seed, stream, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).to(dtype)


def randint(seed, stream: Word, shape, maxval: int, device="cpu") -> torch.Tensor:
    """int32 samples in [0, maxval) by modulo (bias < maxval / 2^32;
    ``maxval`` a positive int32)."""
    maxval = int(maxval)
    if not 0 < maxval < 2**31:
        raise ValueError(f"maxval must be a positive int32, got {maxval}")
    return (random_bits(seed, stream, shape, device) % maxval).to(torch.int32)
