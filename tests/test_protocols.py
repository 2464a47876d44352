"""ADS-B / POCSAG protocol decoders.

The reference DECLARES both (`protocols.hpp:12-48`) but ships no
implementation — these tests validate our working decoders against
PUBLIC truth: documented Mode S example frames (whose CRC-24 must check
under the standard 0x1FFF409 polynomial) and the published POCSAG
constants (frame sync 0x7CD215D8, idle 0x7A89C197 — both must be valid
BCH(31,21)+parity codewords), plus synthesized-signal loopback.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from libtsd_jax.models import adsb as A


def _hexbits(h: str) -> np.ndarray:
    v = int(h, 16)
    n = 4 * len(h)
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


# publicly documented DF17 example frames (mode-s.org decoding guide):
# an aircraft-identification squitter (callsign KLM1023) and an even/odd
# airborne-position pair for ICAO 40621D around (52.257, 3.919).
IDENT = "8D4840D6202CC371C32CE0576098"
POS_EVEN = "8D40621D58C382D690C8AC2863A7"
POS_ODD = "8D40621D58C386435CC412692AD6"


def test_crc24_on_published_frames():
    # the standard polynomial must zero the syndrome of real frames
    for h in (IDENT, POS_EVEN, POS_ODD):
        assert A.adsb_crc(_hexbits(h)).sum() == 0, h
    # and a single flipped bit must break it
    b = _hexbits(IDENT)
    b[37] ^= 1
    assert A.adsb_crc(b).sum() != 0


def test_adsb_loopback_decode():
    rng = np.random.default_rng(7)
    osf = 4
    cfg = A.AdsbConfig(fe=osf * 1e6, Ne=1 << 14, threshold=0.55,
                       max_frames=8)
    dec = A.AdsbDecoder(cfg)
    n = 1 << 14
    x = 0.02 * np.abs(rng.standard_normal(n)).astype(np.float32)
    frames = {3000: IDENT, 8000: POS_EVEN, 12000: POS_ODD}
    for pos, h in frames.items():
        wf = A.adsb_waveform(_hexbits(h), osf=osf)
        x[pos:pos + len(wf)] += 0.9 * wf
    got = dec.decode(x)
    assert len(got) == 3
    for fr, (pos, h) in zip(got, sorted(frames.items())):
        assert fr.crc_ok and abs(fr.position - pos) <= 1
        assert np.array_equal(fr.bits, _hexbits(h))
    # field decoding against the published ground truth
    assert "ICAO 4840D6" in got[0].text and "ident KLM1023" in got[0].text
    assert "alt 38000 ft" in got[1].text and "ICAO 40621D" in got[1].text


def test_adsb_noise_and_overlap_rejection():
    rng = np.random.default_rng(3)
    osf = 2
    dec = A.AdsbDecoder(A.AdsbConfig(fe=2e6, max_frames=8))
    # pure noise: no CRC-valid frames
    x = np.abs(rng.standard_normal(1 << 14)).astype(np.float32)
    assert dec.decode(x) == []
    # corrupted frame: detected by preamble but rejected by CRC
    b = _hexbits(IDENT)
    b[40] ^= 1
    wf = A.adsb_waveform(b, osf=osf)
    x = 0.01 * np.abs(rng.standard_normal(4096)).astype(np.float32)
    x[500:500 + len(wf)] += wf
    assert dec.decode(x, crc_filter=True) == []
    # without CRC filtering the corrupted frame is still surfaced (plus
    # possibly preamble-shaped patterns inside the PPM payload — exactly
    # what the CRC gate exists to reject)
    got = dec.decode(x, crc_filter=False)
    assert any(abs(f.position - 500) <= 1 for f in got)
    assert not any(f.crc_ok for f in got)


def test_adsb_streaming_across_boundaries():
    """Push odd-size chunks; a frame straddling the jit-block boundary
    must still decode exactly once (overlap + dedupe)."""
    rng = np.random.default_rng(11)
    osf = 2
    Ne = 4096
    st = A.AdsbStream(A.AdsbConfig(fe=2e6, Ne=Ne, max_frames=8))
    n = 20000
    x = 0.02 * np.abs(rng.standard_normal(n)).astype(np.float32)
    wf = A.adsb_waveform(_hexbits(IDENT), osf=osf)
    # one frame inside block 1, one GENUINELY straddling the first block
    # boundary (starts before Ne, ends after — undetectable in block 1's
    # tail mask, must come from the overlapped re-decode), one late, and
    # one in the final partial residue (only reachable via flush())
    positions = [1000, Ne - len(wf) // 2, 3 * Ne // 2 + 700, 19000]
    assert positions[1] > Ne - (len(wf) + osf // 2 - 1)  # true straddle
    for p in positions:
        x[p:p + len(wf)] += 0.8 * wf
    got = []
    i = 0
    for sz in [1111, 2048, 5000, 3333, 4096, 4096, 4096]:
        got += st.push(x[i:i + sz])
        i += sz
    got += st.push(x[i:])
    got += st.flush()
    gp = sorted(f.position for f in got)
    assert len(gp) == 4, gp
    assert all(abs(g - p) <= 1 for g, p in zip(gp, sorted(positions)))
    assert all(np.array_equal(f.bits, _hexbits(IDENT)) for f in got)


def test_pocsag_bch_constants():
    from libtsd_jax.models import pocsag as P
    # the published frame-sync and idle words must be valid BCH(31,21)+
    # parity codewords under generator 0x769 — pins the polynomial
    for w in (P.FSC, P.IDLE):
        assert P.bch3121_encode(w >> 11) == w
    # single-bit corruption anywhere must yield a NON-codeword: re-encode
    # of the (possibly modified) data bits never reproduces the flipped
    # word (flips in data re-encode to different check bits; flips in
    # check/parity leave data and hence the true encoding unchanged)
    for k in range(32):
        flipped = P.FSC ^ (1 << k)
        assert P.bch3121_encode(flipped >> 11) != flipped, k


@pytest.mark.parametrize("baud,auto", [(1200, True), (512, False),
                                       (2400, False)])
def test_pocsag_loopback(baud, auto):
    from libtsd_jax.models import pocsag as P
    fe = 38400.0
    bits = P.pocsag_encode(ric=0x12345, function=3, text="HELLO GPU")
    x = P.pocsag_waveform(bits, fe=fe, debit=baud, fi=0.0)
    rng = np.random.default_rng(1)
    x = x + 0.05 * (rng.standard_normal(len(x))
                    + 1j * rng.standard_normal(len(x))).astype(np.complex64)
    cfg = P.PocsagConfig(fe=fe, debit=-1 if auto else baud)
    dec = P.PocsagDecoder(cfg)
    msgs, got_baud = dec.decode(x, return_baud=True)
    assert got_baud == baud
    assert len(msgs) == 1
    m = msgs[0]
    assert m.ric == 0x12345 and m.function == 3
    assert m.text.startswith("HELLO GPU")


def test_pocsag_numeric_and_offset_carrier():
    from libtsd_jax.models import pocsag as P
    fe, fi, baud = 48000.0, 4000.0, 1200
    bits = P.pocsag_encode(ric=1234567, function=0, text="0123 456-789",
                           numeric=True)
    x = P.pocsag_waveform(bits, fe=fe, debit=baud, fi=fi)
    dec = P.PocsagDecoder(P.PocsagConfig(fe=fe, fi=fi, debit=baud))
    msgs = dec.decode(x)
    assert len(msgs) == 1
    m = msgs[0]
    assert m.ric == 1234567 and m.function == 0
    assert m.text.startswith("0123 456-789")


def test_pocsag_single_bit_error_correction():
    from libtsd_jax.models import pocsag as P
    fe, baud = 38400.0, 1200
    bits = P.pocsag_encode(ric=42, function=3, text="BCH OK")
    # flip one payload bit inside the first MESSAGE codeword: address
    # for ric=42 sits at frame (42&7)=2 -> slot 4; message is slot 5
    k = 576 + 32 + 5 * 32 + 7
    bits = bits.copy()
    bits[k] ^= 1
    x = P.pocsag_waveform(bits, fe=fe, debit=baud)
    msgs = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(x)
    assert len(msgs) == 1 and msgs[0].text.startswith("BCH OK")


def test_adsb_streaming_osf4_boundary_gap():
    """Regression: at osf=4 (hs=2) the decoder masks starts in the last
    hs-1 positions of a block; the stream overlap must rewind far enough
    that such a frame is decodable in the next block (it was lost when
    the overlap was frame_len-1)."""
    rng = np.random.default_rng(13)
    osf, Ne = 4, 4096
    st = A.AdsbStream(A.AdsbConfig(fe=osf * 1e6, Ne=Ne, max_frames=8))
    wf = A.adsb_waveform(_hexbits(IDENT), osf=osf)
    start = Ne - len(wf)          # masked in block 1, gap position
    x = 0.02 * np.abs(rng.standard_normal(2 * Ne)).astype(np.float32)
    x[start:start + len(wf)] += 0.9 * wf
    got = st.push(x) + st.flush()
    assert [f.position for f in got] == [start]
    assert np.array_equal(got[0].bits, _hexbits(IDENT))


def test_pocsag_numeric_padding_stripped():
    """Numeric pages shorter than the 20-bit boundary must not grow
    spurious trailing digits (padding is the space nibble, stripped)."""
    from libtsd_jax.models import pocsag as P
    fe, baud = 38400.0, 1200
    bits = P.pocsag_encode(ric=77, function=0, text="911", numeric=True)
    x = P.pocsag_waveform(bits, fe=fe, debit=baud)
    msgs = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(x)
    assert len(msgs) == 1 and msgs[0].text == "911"


def test_pocsag_double_bit_error_correction():
    """BCH(31,21) has d=5: two bit errors in one codeword must be
    corrected (syndrome matched against the 465 pair table)."""
    from libtsd_jax.models import pocsag as P
    fe, baud = 38400.0, 1200
    bits = P.pocsag_encode(ric=42, function=3, text="BCH2 OK")
    # two flips inside the first message codeword (slot 5: addr frame 2)
    base = 576 + 32 + 5 * 32
    bits = bits.copy()
    bits[base + 3] ^= 1
    bits[base + 19] ^= 1
    x = P.pocsag_waveform(bits, fe=fe, debit=baud)
    msgs = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(x)
    assert len(msgs) == 1 and msgs[0].text.startswith("BCH2 OK")
    # three flips exceed the correction radius -> the word must be
    # REJECTED (or corrected to a wrong word caught by parity), never
    # silently accepted as-is
    bits2 = P.pocsag_encode(ric=42, function=3, text="BCH2 OK").copy()
    for k in (3, 19, 27):
        bits2[base + k] ^= 1
    x2 = P.pocsag_waveform(bits2, fe=fe, debit=baud)
    msgs2 = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(x2)
    assert not (msgs2 and msgs2[0].text.startswith("BCH2 OK"))


def test_pocsag_message_spans_batches():
    """A long message overflows the first batch; assembly must continue
    through the second batch's sync word."""
    from libtsd_jax.models import pocsag as P
    fe, baud = 38400.0, 1200
    text = "THE QUICK BROWN FOX JUMPS OVER THE LAZY DOG 0123456789"
    bits = P.pocsag_encode(ric=0x3FFFD, function=3, text=text)  # frame 5
    assert len(bits) > 576 + 2 * 544 - 32  # really two batches
    x = P.pocsag_waveform(bits, fe=fe, debit=baud)
    msgs = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(x)
    assert len(msgs) == 1
    assert msgs[0].ric == 0x3FFFD and msgs[0].text.startswith(text)


def test_pocsag_noise_sensitivity():
    """Decodes through moderate AWGN on the FSK signal (the BCH layer
    plus the 8x bit integration should hold well above threshold)."""
    from libtsd_jax.models import pocsag as P
    fe, baud = 38400.0, 1200
    bits = P.pocsag_encode(ric=99, function=3, text="NOISY")
    x0 = P.pocsag_waveform(bits, fe=fe, debit=baud)
    rng = np.random.default_rng(5)
    nz = (rng.standard_normal(len(x0)) + 1j * rng.standard_normal(len(x0)))
    x = x0 + 0.35 * nz.astype(np.complex64)   # ~9 dB SNR
    msgs = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(x)
    assert len(msgs) == 1 and msgs[0].text.startswith("NOISY")


def test_adsb_batched_channels_vmap():
    """The device decode path is vmap-able over channels — the batched
    form for monitoring C receivers at once."""
    import jax
    rng = np.random.default_rng(2)
    osf = 2
    dec = A.AdsbDecoder(A.AdsbConfig(fe=2e6, Ne=8192, max_frames=4))
    wf = A.adsb_waveform(_hexbits(IDENT), osf=osf)
    C = 4
    x = 0.02 * np.abs(rng.standard_normal((C, 8192))).astype(np.float32)
    pos = [700, 1500, 2500, 4000]
    for c in range(C):
        x[c, pos[c]:pos[c] + len(wf)] += 0.9 * wf
    d = jax.jit(jax.vmap(dec._decode_block))(jnp.asarray(x))
    got_pos = np.asarray(d.position)
    ok = np.asarray(d.crc_ok)
    val = np.asarray(d.valid)
    for c in range(C):
        hits = [p for k, p in enumerate(got_pos[c])
                if val[c, k] and ok[c, k]]
        assert hits == [pos[c]]


def test_cpr_global_pair():
    # published even/odd pair decodes to the documented position
    be, bo = _hexbits(POS_EVEN), _hexbits(POS_ODD)
    assert be[53] == 0 and bo[53] == 1
    lat_e = A._field(be, 54, 71)
    lon_e = A._field(be, 71, 88)
    lat_o = A._field(bo, 54, 71)
    lon_o = A._field(bo, 71, 88)
    p = A.cpr_global(lat_e, lon_e, lat_o, lon_o, newest_odd=False)
    assert p is not None
    lat, lon = p
    assert abs(lat - 52.2572) < 2e-3 and abs(lon - 3.91937) < 2e-3


def test_pocsag_parity_bit_error_patterns():
    """d=6 decision table: errors involving the PARITY bit are
    correctable (the old post-correction-parity gate rejected them)."""
    from libtsd_jax.models import pocsag as P
    fe, baud = 38400.0, 1200
    base = 576 + 32 + 5 * 32          # first message codeword (frame 2)
    # (a) parity-bit-only error: data intact, must decode
    bits = P.pocsag_encode(ric=42, function=3, text="PAR OK").copy()
    bits[base + 31] ^= 1
    msgs = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(
        P.pocsag_waveform(bits, fe=fe, debit=baud))
    assert len(msgs) == 1 and msgs[0].text.startswith("PAR OK")
    # (b) data + parity double error: data corrected, must decode
    bits = P.pocsag_encode(ric=42, function=3, text="PAR OK").copy()
    bits[base + 7] ^= 1
    bits[base + 31] ^= 1
    msgs = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud)).decode(
        P.pocsag_waveform(bits, fe=fe, debit=baud))
    assert len(msgs) == 1 and msgs[0].text.startswith("PAR OK")


@pytest.mark.slow
def test_adsb_detection_probability_sweep():
    """Statistical gate: P(decode) vs amplitude-to-noise ratio over many
    random trials — the detection front end plus the CRC gate must turn
    on sharply (the reference's test strategy for modems, SURVEY §4,
    applied to the protocol decoder).

    DETERMINISTIC: all randomness comes from the seeded generator below
    (default_rng(42)) — a failure reproduces exactly by re-running this
    test; the gate thresholds were calibrated against this seed's
    realization with margin."""
    rng = np.random.default_rng(42)
    osf = 2
    dec = A.AdsbDecoder(A.AdsbConfig(fe=2e6, Ne=4096, max_frames=4))
    wf = A.adsb_waveform(_hexbits(IDENT), osf=osf)
    trials = 40
    got = {}
    for amp in (0.25, 0.5, 1.5):
        ok = 0
        for _ in range(trials):
            x = 0.25 * np.abs(rng.standard_normal(4096)).astype(np.float32)
            p = int(rng.integers(100, 4096 - len(wf) - 2))
            x[p:p + len(wf)] += amp * wf
            frames = dec.decode(x)
            ok += any(np.array_equal(f.bits, _hexbits(IDENT))
                      for f in frames)
        got[amp] = ok / trials
    # deep fades fail, strong pulses decode essentially always
    assert got[1.5] >= 0.95, got
    assert got[0.25] <= 0.5, got
    # monotone turn-on
    assert got[0.25] <= got[0.5] <= got[1.5] + 1e-9, got


@pytest.mark.slow
def test_pocsag_message_error_rate_vs_snr():
    """POCSAG decode probability vs AWGN level at 1200 baud: clean decode
    well above threshold, graceful loss below.

    DETERMINISTIC: seeded default_rng(7) — failures reproduce exactly;
    thresholds calibrated with margin on this seed's realization."""
    from libtsd_jax.models import pocsag as P
    rng = np.random.default_rng(7)
    fe, baud = 38400.0, 1200
    bits = P.pocsag_encode(ric=777, function=3, text="SNR SWEEP")
    x0 = P.pocsag_waveform(bits, fe=fe, debit=baud)
    dec = P.PocsagDecoder(P.PocsagConfig(fe=fe, debit=baud))
    trials = 12
    rates = {}
    for sigma in (0.2, 0.9):
        ok = 0
        for _ in range(trials):
            nz = (rng.standard_normal(len(x0))
                  + 1j * rng.standard_normal(len(x0)))
            x = x0 + sigma * nz.astype(np.complex64)
            msgs = dec.decode(x)
            ok += bool(msgs and msgs[0].ric == 777
                       and msgs[0].text.startswith("SNR SWEEP"))
        rates[sigma] = ok / trials
    # a full-text decode needs EVERY message codeword <= 2 bit errors,
    # so the turn-on is sharper than the single-codeword tests suggest:
    # ~11 dB decodes clean, ~-2.6 dB is lossy but must not crash
    assert rates[0.2] == 1.0, rates
    assert rates[0.9] < 1.0, rates
