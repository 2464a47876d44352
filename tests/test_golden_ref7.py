"""WAV file interoperability against the reference binary (golden_gen7).

Both directions are covered:

* files WRITTEN by the reference (`wav_enregistre` = PCM_FLOAT,
  `WavEcrivain` PCM_16 — wav.cc:83-95, 446-455) must load through
  `utils/wav.py`;
* files WRITTEN by `utils/wav.py` (committed as g7_ours_*.wav; the exact
  generation recipe is reproduced below) were read by the reference's
  `wav_charge` at golden time and its readback is diffed here.

Scaling convention (documented difference): the reference keeps 16-bit
samples in RAW UNITS in float (reads `y(i) = t16[i]`, writes a plain
truncating `(int16_t)` cast) while this library normalizes to [-1, 1]
(/32768 on read, *32767 clip-round on write).  The tests convert at the
boundary; float32 WAVs carry identical bytes, no conversion.
"""
import os

import numpy as np
import pytest

from libtsd_jax.utils.wav import wav_load, wav_save

G = os.path.join(os.path.dirname(__file__), "golden")


def _g(name):
    p = os.path.join(G, name)
    if not os.path.exists(p):
        pytest.skip(f"golden {name} not generated")
    return np.load(p) if name.endswith(".npy") else p


def test_load_reference_float32_mono():
    x, rate = wav_load(_g("g7_ref_mono_f32.wav"))
    ref = _g("g7_ref_mono.npy")
    assert rate == 16000 and x.shape == ref.shape
    # float32 PCM: identical bytes end to end
    assert np.array_equal(x, ref)


def test_load_reference_float32_stereo():
    x, rate = wav_load(_g("g7_ref_stereo_f32.wav"))
    l = _g("g7_ref_stereo_l.npy")
    r = _g("g7_ref_stereo_r.npy")
    assert rate == 22050 and x.shape == (len(l), 2)
    assert np.array_equal(x[:, 0], l)
    assert np.array_equal(x[:, 1], r)


def test_load_reference_pcm16_mono():
    x, rate = wav_load(_g("g7_ref_mono_i16.wav"))
    raw = _g("g7_ref_mono_i16.npy")     # reference's own reload (raw ints)
    assert rate == 8000
    # our [-1,1] domain * 32768 == the raw int samples, exactly
    assert np.array_equal(np.round(x * 32768.0), raw)


def test_reference_reads_our_pcm16():
    rb = _g("g7_ours_i16_readback.npy")
    n = 1024
    x16 = (0.8 * np.sin(2 * np.pi * 0.01 * np.arange(n))).astype(np.float32)
    expected = np.clip(x16 * 32767.0, -32768, 32767).astype(np.int16)
    assert np.array_equal(rb, expected.astype(np.float32))


def test_reference_reads_our_float32():
    rb = _g("g7_ours_f32_readback.npy")
    n = 1024
    xf = (0.5 * np.cos(2 * np.pi * 0.017 * np.arange(n))).astype(np.float32)
    assert np.array_equal(rb, xf)


def test_committed_files_match_recipe():
    """The committed g7_ours_*.wav really are the documented recipe (so
    the golden readbacks above prove what they claim)."""
    n = 1024
    i = np.arange(n)
    x16 = (0.8 * np.sin(2 * np.pi * 0.01 * i)).astype(np.float32)
    xf = (0.5 * np.cos(2 * np.pi * 0.017 * i)).astype(np.float32)
    a, ra = wav_load(_g("g7_ours_i16.wav"))
    b, rb = wav_load(_g("g7_ours_f32.wav"))
    assert ra == 8000 and rb == 16000
    q = np.clip(x16 * 32767.0, -32768, 32767).astype(np.int16)
    assert np.array_equal(a, q.astype(np.float32) / 32768.0)
    assert np.array_equal(b, xf)
