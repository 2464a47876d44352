"""Bit vectors (parity: BitStream, core/include/tsd/telecom/bitstream.hpp,
core/src/telecom/bitstream.cc).

Representation: an int8 jax array of 0/1 values.  The reference's
mutable push/pop API becomes functional helpers; random/pad/concat/Hamming
distance are vectorized.
"""
from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "bits_from_string", "bits_to_string", "randbits", "pad_bits",
    "hamming_distance", "bits_from_bytes", "bits_to_bytes", "altbits",
    "zerobits", "onebits",
]

Bits = jax.Array  # int8 array of 0/1


def bits_from_string(s: str) -> Bits:
    """'0101...' -> bits (parity: BitStream(string ctor))."""
    return jnp.asarray([int(c) for c in s if c in "01"], jnp.int8)


def bits_to_string(b: Bits) -> str:
    return "".join(str(int(v)) for v in np.asarray(b))


def randbits(key, n: int) -> Bits:
    """Random bit vector (parity: randstream, bitstream.cc)."""
    return jax.random.bernoulli(key, 0.5, (n,)).astype(jnp.int8)


def zerobits(n: int) -> Bits:
    return jnp.zeros(n, jnp.int8)


def onebits(n: int) -> Bits:
    return jnp.ones(n, jnp.int8)


def altbits(n: int) -> Bits:
    """Alternating 0,1,0,1 (parity: BitStream::altern)."""
    return (jnp.arange(n) % 2).astype(jnp.int8)


def pad_bits(b: Bits, mult: int) -> Bits:
    """Zero-pad so the length is a multiple of ``mult`` (parity:
    BitStream::pad_mult)."""
    n = b.shape[0]
    pad = (-n) % mult
    from ..block import safe_pad
    return safe_pad(b, 0, pad, axis=0) if pad else b


def hamming_distance(a: Bits, b: Bits) -> jax.Array:
    """Number of differing bits (parity: BitStream::dst_Hamming)."""
    n = min(a.shape[0], b.shape[0])
    return jnp.sum(jnp.abs(a[:n].astype(jnp.int32) - b[:n].astype(jnp.int32)))


def bits_from_bytes(data: bytes, lsb_first: bool = True) -> Bits:
    arr = np.frombuffer(data, np.uint8)
    bits = np.unpackbits(arr, bitorder="little" if lsb_first else "big")
    return jnp.asarray(bits, jnp.int8)


def bits_to_bytes(b: Bits, lsb_first: bool = True) -> bytes:
    arr = np.asarray(b, np.uint8)
    return np.packbits(arr, bitorder="little" if lsb_first else "big").tobytes()
