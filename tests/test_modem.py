"""Demodulator and frame receiver tests — statistical end-to-end loops
(mirrors test_recepteur/test_demod, core/tests/test-telecom.cc:810+)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.models import waveform as WF
from libtsd_jax.models import channel as CH
from libtsd_jax.models import ber as BER
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.modulator import ModConfig, Modulator
from libtsd_jax.models.demod import DemodConfig, Demodulator, llr, \
    quadrature_discriminator
from libtsd_jax.models.detector import Detector, DetectorConfig, detect_pattern
from libtsd_jax.models.frame import FrameFormat, Transmitter, Receiver


def _loop(wf, osf, nbits, EbN0, key=0, freq_offset=0.0):
    mod = Modulator.create(ModConfig(wf=wf, fe=float(osf), fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(key), nbits)
    x, _ = mod.modulate(bits)
    if freq_offset:
        n = x.shape[0]
        x = x * jnp.exp(2j * jnp.pi * freq_offset *
                        jnp.arange(n)).astype(jnp.complex64)
    y = CH.awgn(jax.random.PRNGKey(key + 1), x, EbN0, osf=osf,
                k_bits=wf.info.k)
    dm = Demodulator.create(DemodConfig(wf=wf, fe=float(osf), fsymb=1.0))
    rx_bits, syms, mask, bmask = dm.demodulate(y)
    rx = np.asarray(rx_bits)[np.asarray(bmask)]
    return bits, rx


def test_demod_qpsk_high_snr():
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    bits, rx = _loop(wf, 4, 2 * 2000, 20.0)
    # skip convergence region, resolve phase ambiguity
    ber, errs, lag = BER.cmp_bits_psk(bits[800:], jnp.asarray(rx[800:]), 2,
                                      max_lag=64)
    assert ber < 0.01, (ber, errs)


def test_demod_bpsk_moderate_snr():
    wf = WF.wf_bpsk(WF.PulseShape.rcs(0.25))
    bits, rx = _loop(wf, 4, 4000, 8.0, key=10)
    ber, errs, lag = BER.cmp_bits_psk(bits[1000:], jnp.asarray(rx[1000:]), 1,
                                      max_lag=64)
    th = float(wf.ber(8.0))
    assert ber < max(5 * th, 0.01), (ber, th)


def test_quadrature_discriminator():
    f0 = 0.05
    x = jnp.exp(2j * jnp.pi * f0 * jnp.arange(256)).astype(jnp.complex64)
    d = np.asarray(quadrature_discriminator(x))
    assert np.allclose(d[1:], 2 * np.pi * f0, atol=1e-4)


def test_llr_signs():
    wf = WF.wf_bpsk()
    y = jnp.asarray([1.0 + 0j, -1.0 + 0j], jnp.complex64)
    L = np.asarray(llr(wf, y, 0.5))
    # bit 1 <-> symbol +1 (decode_BPSK convention): strong positive LLR
    # means bit 1 more likely under our (d0 - d1) definition
    assert L[0] > 0 and L[1] < 0


def test_detector_multiple_patterns():
    rng = np.random.default_rng(5)
    M = 48
    p = (rng.standard_normal(M) + 1j * rng.standard_normal(M)).astype(np.complex64)
    n = 8192
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    positions = [500, 3000, 6200]
    for pos in positions:
        x[pos:pos + M] += p
    det, score = detect_pattern(jnp.asarray(x), p,
                                DetectorConfig(threshold=0.6, max_peaks=8))
    got = sorted(np.asarray(det.position)[np.asarray(det.valid)].tolist())
    assert got == positions, got


def test_detector_rif_mode_matches_ola():
    """The direct-form (RIF) correlation finds the same peaks with the
    same scores as the default OLA-FFT correlation."""
    rng = np.random.default_rng(7)
    M = 48
    p = (rng.standard_normal(M) + 1j * rng.standard_normal(M)).astype(np.complex64)
    n = 8192
    x = 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    positions = [700, 4200]
    for pos in positions:
        x[pos:pos + M] += p
    det_o, _ = detect_pattern(jnp.asarray(x), p,
                              DetectorConfig(threshold=0.6))
    det_r, _ = detect_pattern(jnp.asarray(x), p,
                              DetectorConfig(threshold=0.6, mode="rif"))
    for det in (det_o, det_r):
        got = sorted(np.asarray(det.position)[np.asarray(det.valid)].tolist())
        assert got == positions, got
    so = np.sort(np.asarray(det_o.score)[np.asarray(det_o.valid)])
    sr = np.sort(np.asarray(det_r.score)[np.asarray(det_r.valid)])
    assert np.max(np.abs(so - sr)) < 1e-3


def test_detector_end_of_buffer_and_alignment():
    """Regressions: (a) a pattern ending in the last M/2 samples must be
    detected one-shot (internal M-pad); (b) the score track is aligned to
    WINDOW-END positions; (c) tiny-amplitude signals detect (the energy
    guard is scale-relative, not absolute); (d) short buffers still yield
    (max_peaks,) shapes."""
    rng = np.random.default_rng(9)
    M = 64
    p = (rng.standard_normal(M) + 1j * rng.standard_normal(M)).astype(np.complex64)
    # (a) pattern flush against the end
    x = 0.05 * (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
                ).astype(np.complex64)
    x[936:1000] += p
    det, score = detect_pattern(jnp.asarray(x), p,
                                DetectorConfig(threshold=0.6, mode="rif"))
    got = np.asarray(det.position)[np.asarray(det.valid)]
    assert 936 in got.tolist(), got
    # (b) track peak at the window END of a mid-buffer pattern
    x2 = 0.05 * (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)
                 ).astype(np.complex64)
    x2[500:564] += p
    det2, score2 = detect_pattern(jnp.asarray(x2), p,
                                  DetectorConfig(threshold=0.6, mode="rif"))
    assert int(np.argmax(np.asarray(score2))) == 563
    # (c) the same buffer scaled down by 1e7 must still detect
    det3, _ = detect_pattern(jnp.asarray(x2 * 1e-7), p,
                             DetectorConfig(threshold=0.6, mode="rif"))
    got3 = np.asarray(det3.position)[np.asarray(det3.valid)]
    assert 500 in got3.tolist(), got3
    # (d) buffer shorter than max_peaks segments
    det4, _ = detect_pattern(jnp.asarray(x2[:100]), p,
                             DetectorConfig(threshold=0.6, mode="rif",
                                            max_peaks=4))
    assert np.asarray(det4.position).shape == (4,)


def test_detector_no_false_alarm():
    rng = np.random.default_rng(6)
    M = 48
    p = (rng.standard_normal(M) + 1j * rng.standard_normal(M)).astype(np.complex64)
    x = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)).astype(np.complex64)
    det, _ = detect_pattern(jnp.asarray(x), p, DetectorConfig(threshold=0.7))
    assert not np.asarray(det.valid).any()


@pytest.fixture
def frame_setup():
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=256)
    return wf, fmt


def test_frame_loop_clean(frame_setup):
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(1), 256)
    frame = tx.transmit(payload)
    x = jnp.zeros(4096, jnp.complex64).at[700:700 + frame.shape[0]].add(frame)
    x = x + 1e-4 * jax.random.normal(jax.random.PRNGKey(5), (4096,))
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    frames = rx.receive(x)
    v = np.asarray(frames.valid)
    assert v.any()
    i = int(np.argmax(v))
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(frames.bits[i]), 4)
    assert errs == 0


def test_frame_loop_impaired(frame_setup):
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(2), 256)
    frame = tx.transmit(payload)
    n = 4096
    key = jax.random.PRNGKey(3)
    x = 0.01 * (jax.random.normal(key, (n,))
                + 1j * jax.random.normal(jax.random.PRNGKey(4), (n,))
                ).astype(jnp.complex64)
    x = x.at[900:900 + frame.shape[0]].add(
        1.8 * jnp.exp(1j * 1.1) * frame)
    # sigma for a true IN-FRAME Eb/N0 of 12 dB
    lvl = 1.8 * jnp.sqrt(jnp.mean(jnp.abs(frame) ** 2))
    sigma = lvl * jnp.sqrt(0.5 * (4 / 2) / 10.0 ** (12.0 / 10.0))
    x = CH.awgn_noise(jax.random.PRNGKey(6), x, sigma)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    frames = rx.receive(x)
    v = np.asarray(frames.valid)
    assert v.any()
    i = int(np.argmax(v))
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(frames.bits[i]), 4)
    assert ber < 0.02, (ber, errs)
    assert abs(float(frames.EbN0_db[i]) - 12.0) < 2.0, float(frames.EbN0_db[i])


def test_frame_ebn0_estimate(frame_setup):
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(7), 256)
    frame = tx.transmit(payload)
    x = jnp.zeros(4096, jnp.complex64).at[500:500 + frame.shape[0]].add(frame)
    # 15 dB true in-frame Eb/N0: inside the estimator's linear range (the
    # decision-directed EVM floors near ~18 dB from truncated-RRC ISI +
    # PLL jitter, same ceiling as the reference's correlation-score SNR)
    lvl = jnp.sqrt(jnp.mean(jnp.abs(frame) ** 2))
    sigma = lvl * jnp.sqrt(0.5 * (4 / 2) / 10.0 ** (15.0 / 10.0))
    x = CH.awgn_noise(jax.random.PRNGKey(8), x, sigma)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    frames = rx.receive(x)
    v = np.asarray(frames.valid)
    i = int(np.argmax(v))
    assert v[i]
    est = float(frames.EbN0_db[i])
    assert abs(est - 15.0) < 2.0, est


def test_demod_fsk_loop():
    """End-to-end 2-FSK (MSK index): mod -> AWGN -> discriminator demod."""
    wf = WF.wf_fsk(2, 0.5, WF.PulseShape.nrz())
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(30), 3000)
    x, _ = mod.modulate(bits)
    y = CH.awgn(jax.random.PRNGKey(31), x, 14.0, osf=4, k_bits=1)
    dm = Demodulator.create(DemodConfig(wf=wf, fe=4.0, fsymb=1.0))
    rb, syms, mask, bmask = dm.demodulate(y)
    rbn = np.asarray(rb)[np.asarray(bmask)]
    ber, errs, lag = BER.cmp_bits(bits[800:], jnp.asarray(rbn[800:]),
                                  max_lag=64)
    assert ber < 0.01, (ber, errs)


def test_demod_pi4_qpsk_loop():
    """pi/4-QPSK through the full blind chain (parity-free decisions +
    union-constellation decision PED)."""
    wf = WF.wf_pi4_qpsk(WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(32), 2 * 3000)
    x, _ = mod.modulate(bits)
    y = CH.awgn(jax.random.PRNGKey(33), x, 14.0, osf=4, k_bits=2)
    dm = Demodulator.create(DemodConfig(wf=wf, fe=4.0, fsymb=1.0))
    rb, syms, mask, bmask = dm.demodulate(y)
    rbn = np.asarray(rb)[np.asarray(bmask)]
    ber, errs, lag = BER.cmp_bits_psk(bits[2 * 800:],
                                      jnp.asarray(rbn[2 * 800:]), 2,
                                      max_lag=64)
    assert ber < 0.01, (ber, errs)


def test_demod_with_if_transposition():
    """Demodulator's baseband-transposition path (fi != 0)."""
    wf = WF.wf_qpsk(WF.PulseShape.rcs(0.25))
    fi = 1.0  # IF at fe/4
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fi=fi, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(50), 2 * 2000)
    x, _ = mod.modulate(bits)
    y = CH.awgn(jax.random.PRNGKey(51), x, 18.0, osf=4, k_bits=2)
    dm = Demodulator.create(DemodConfig(wf=wf, fe=4.0, fi=fi, fsymb=1.0))
    rb, syms, mask, bmask = dm.demodulate(y)
    rbn = np.asarray(rb)[np.asarray(bmask)]
    ber, errs, lag = BER.cmp_bits_psk(bits[2 * 800:],
                                      jnp.asarray(rbn[2 * 800:]), 2,
                                      max_lag=64)
    assert ber < 0.01, (ber, errs)


def test_receiver_streaming_two_blocks(frame_setup):
    """A frame fully inside the SECOND block must be caught by the
    streaming receiver with carried state."""
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(60), 256)
    frame = tx.transmit(payload)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    Ne = rx.det.corr.Ne
    nblk = ((2048 + Ne - 1) // Ne) * Ne
    blk1 = jnp.zeros(nblk, jnp.complex64) + 0.01 * (
        jax.random.normal(jax.random.PRNGKey(61), (nblk,))
        + 1j * jax.random.normal(jax.random.PRNGKey(62), (nblk,)))
    blk2 = jnp.zeros(nblk, jnp.complex64).at[
        300:300 + frame.shape[0]].add(frame) + 0.01 * (
        jax.random.normal(jax.random.PRNGKey(63), (nblk,))
        + 1j * jax.random.normal(jax.random.PRNGKey(64), (nblk,)))
    st = rx.init()
    st, f1 = rx.step(st, blk1)
    st, f2 = rx.step(st, blk2)
    assert not np.asarray(f1.valid).any()
    v2 = np.asarray(f2.valid)
    assert v2.any()
    i = int(np.argmax(v2))
    assert abs(int(f2.detection.position[i]) - 310) <= 1
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(f2.bits[i]), 4)
    assert errs == 0


def test_frame_fractional_delay(frame_setup):
    """Frame at a NON-INTEGER delay (900.37 samples): the receiver must
    apply the detector's position_frac through the sinc interpolator bank
    (parity: recepteur.cc:131-160 + itrp.cc:11-57).  0 payload errors at
    12 dB, Eb/N0 estimate within +-2 dB."""
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(21), 256)
    frame = tx.transmit(payload)
    n = 4096
    from libtsd_jax.ops.fft import delay_signal
    x = jnp.zeros(n, jnp.complex64).at[900:900 + frame.shape[0]].add(
        1.4 * jnp.exp(1j * 0.7) * frame)
    x = delay_signal(x, 0.37)             # off-grid timing
    # sigma for a true IN-FRAME Eb/N0 of 12 dB (awgn() would normalize
    # over the mostly-zero buffer and understate the actual SNR)
    lvl = 1.4 * jnp.sqrt(jnp.mean(jnp.abs(frame) ** 2))
    sigma = lvl * jnp.sqrt(0.5 * (4 / 2) / 10.0 ** (12.0 / 10.0))
    x = CH.awgn_noise(jax.random.PRNGKey(22), x, sigma)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    frames = rx.receive(x)
    v = np.asarray(frames.valid)
    assert v.any()
    i = int(np.argmax(v))
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(frames.bits[i]), 4)
    assert errs == 0, (ber, errs)
    assert abs(float(frames.EbN0_db[i]) - 12.0) < 2.0, float(frames.EbN0_db[i])


def test_frame_if_offset(frame_setup):
    """fi != 0: the receiver mixes the IF signal to baseband before
    detection (reference pushes fi into the demod, recepteur.cc:236-238)."""
    wf, _ = frame_setup
    import dataclasses as DC
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0, fi=0.3)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=256)
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(23), 256)
    frame = tx.transmit(payload)          # modulated AT the IF
    n = 4096
    x = jnp.zeros(n, jnp.complex64).at[700:700 + frame.shape[0]].add(frame)
    x = CH.awgn(jax.random.PRNGKey(24), x, 14.0, osf=4, k_bits=2)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    frames = rx.receive(x)
    v = np.asarray(frames.valid)
    assert v.any()
    i = int(np.argmax(v))
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(frames.bits[i]), 4)
    assert errs == 0, (ber, errs)


def test_frame_fractional_delay_and_if(frame_setup):
    """The hard scenario: non-integer delay AND an IF offset at 12 dB
    -> 0 payload errors, Eb/N0 within +-2 dB."""
    wf, _ = frame_setup
    mc = ModConfig(wf=wf, fe=4.0, fsymb=1.0, fi=0.25)
    hdr = np.asarray(randbits(jax.random.PRNGKey(42), 64))
    fmt = FrameFormat(modulation=mc,
                      header_bits=tuple(int(b) for b in hdr),
                      payload_bits=256)
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(25), 256)
    frame = tx.transmit(payload)
    n = 4096
    from libtsd_jax.ops.fft import delay_signal
    x = jnp.zeros(n, jnp.complex64).at[900:900 + frame.shape[0]].add(
        1.2 * jnp.exp(-1j * 0.4) * frame)
    x = delay_signal(x, 0.37)
    lvl = 1.2 * jnp.sqrt(jnp.mean(jnp.abs(frame) ** 2))
    sigma = lvl * jnp.sqrt(0.5 * (4 / 2) / 10.0 ** (12.0 / 10.0))
    x = CH.awgn_noise(jax.random.PRNGKey(26), x, sigma)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    frames = rx.receive(x)
    v = np.asarray(frames.valid)
    assert v.any()
    i = int(np.argmax(v))
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(frames.bits[i]), 4)
    assert errs == 0, (ber, errs)
    assert abs(float(frames.EbN0_db[i]) - 12.0) < 2.0, float(frames.EbN0_db[i])


def test_receiver_monitors(frame_setup):
    """moniteurs() per-stage scopes (parity: recepteur.cc:83-110)."""
    from libtsd_jax.models.frame import MonitoredReceiver
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(27), 256)
    frame = tx.transmit(payload)
    x = jnp.zeros(4096, jnp.complex64).at[600:600 + frame.shape[0]].add(frame)
    x = x + 1e-4 * jax.random.normal(jax.random.PRNGKey(28), (4096,))
    rx = MonitoredReceiver(Receiver.create(fmt, DetectorConfig(threshold=0.5)))
    frames = rx.receive(x)
    assert np.asarray(frames.valid).any()
    stats = rx.moniteurs()
    assert set(stats) >= {"recepteur/ola", "recepteur/demod"}
    assert stats["recepteur/ola"].count >= 1
    assert stats["recepteur/ola"].total_s > 0
    assert stats["recepteur/demod"].samples > 0


def test_demod_pi4_qpsk_streaming_parity_carry():
    """pi/4-QPSK streamed in blocks: the rotation parity is carried in
    demod state (detected once, advanced by emitted-symbol count), so
    multi-block decisions equal the one-shot run even when blocks emit
    odd symbol counts."""
    from libtsd_jax.block import stream
    wf = WF.wf_pi4_qpsk(WF.PulseShape.rcs(0.25))
    mod = Modulator.create(ModConfig(wf=wf, fe=4.0, fsymb=1.0))
    bits = randbits(jax.random.PRNGKey(34), 2 * 1500)
    x, _ = mod.modulate(bits)
    y = CH.awgn(jax.random.PRNGKey(35), x, 16.0, osf=4, k_bits=2)
    dm = Demodulator.create(DemodConfig(wf=wf, fe=4.0, fsymb=1.0))
    rb1, _, _, bm1 = dm.demodulate(y)
    once = np.asarray(rb1)[np.asarray(bm1)]
    # stream in blocks of 404 samples (-> ~101 symbols/block, odd counts)
    st = dm.init()
    parts = []
    n = (y.shape[0] // 404) * 404
    for i in range(0, n, 404):
        st, (rb, syms, mask, bmask) = dm.step(st, y[i:i + 404])
        parts.append(np.asarray(rb)[np.asarray(bmask)])
    streamed = np.concatenate(parts)
    m = min(len(once), len(streamed))
    # skip the pull-in region; then decisions must agree
    agree = np.mean(once[2 * 400:m] == streamed[2 * 400:m])
    assert agree > 0.995, agree


def test_receiver_lookahead_frame_cut_by_block_edge(frame_setup):
    """A frame CUT by the final block edge (header straddling the
    boundary) must NOT decode garbage from block 1; the detection defers
    to block 2 (negative position into the carried history) and decodes
    cleanly there."""
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(70), 256)
    frame = tx.transmit(payload)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    Ne = rx.det.Ne
    nblk = ((2048 + Ne - 1) // Ne) * Ne
    start = nblk - 100            # 100 samples of the frame in block 1
    whole = jnp.zeros(2 * nblk, jnp.complex64).at[
        start:start + frame.shape[0]].add(frame)
    whole = whole + 0.01 * (
        jax.random.normal(jax.random.PRNGKey(71), (2 * nblk,))
        + 1j * jax.random.normal(jax.random.PRNGKey(72), (2 * nblk,))
    ).astype(jnp.complex64)
    st = rx.init()
    st, f1 = rx.step(st, whole[:nblk])
    st, f2 = rx.step(st, whole[nblk:])
    v2 = np.asarray(f2.valid)
    assert v2.any(), "frame cut by the block edge was lost"
    i = int(np.argmax(v2))
    # position is relative to block 2: the frame started 100 samples
    # before it (+10 modulator latency to the pattern start)
    pos = int(np.asarray(f2.detection.position)[i])
    assert abs(pos - (-100 + 10)) <= 2, pos
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(f2.bits[i]), 4)
    assert errs == 0, (ber, errs)


def test_receiver_payload_cut_by_block_edge(frame_setup):
    """A frame whose HEADER is detected in block 1 but whose PAYLOAD
    extends into block 2 must be deferred and decoded from the full data
    — not extracted early against a clipped buffer (which would decode
    garbage with valid=True)."""
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(80), 256)
    frame = tx.transmit(payload)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    Ne = rx.det.Ne
    nblk = ((max(2048, rx.frame_len + 64) + Ne - 1) // Ne) * Ne
    # header well inside block 1 (detected there), payload crossing into
    # block 2: start so that ~3/4 of the frame is still missing
    start = nblk - rx.frame_len // 4
    assert start + frame.shape[0] > nblk  # really straddles
    whole = jnp.zeros(2 * nblk, jnp.complex64).at[
        start:start + frame.shape[0]].add(frame)
    whole = whole + 0.01 * (
        jax.random.normal(jax.random.PRNGKey(81), (2 * nblk,))
        + 1j * jax.random.normal(jax.random.PRNGKey(82), (2 * nblk,))
    ).astype(jnp.complex64)
    st = rx.init()
    st, f1 = rx.step(st, whole[:nblk])
    st, f2 = rx.step(st, whole[nblk:])
    # block 1 must NOT claim a valid frame at this position (payload
    # incomplete there)
    v1 = np.asarray(f1.valid)
    p1 = np.asarray(f1.detection.position)
    assert not np.any(v1 & (np.abs(p1 - start) < rx.frame_len)), (v1, p1)
    # block 2 delivers it (deferred detection, negative position)
    v2 = np.asarray(f2.valid)
    assert v2.any(), "payload-straddling frame was lost"
    i = int(np.argmax(v2))
    ber, errs, _ = BER.cmp_bits(payload, jnp.asarray(f2.bits[i]), 4)
    assert errs == 0, (ber, errs)


def test_detector_rif_mode_matches_ola():
    """MODE_RIF (direct Toeplitz FIR correlation) gives the same detections as
    the OLA engine (parity: DetecteurConfig::mode, detection.cc:68-96)."""
    rng_ = np.random.default_rng(9)
    M = 64
    p = (rng_.standard_normal(M) + 1j * rng_.standard_normal(M)
         ).astype(np.complex64)
    n = 4096
    x = 0.05 * (rng_.standard_normal(n) + 1j * rng_.standard_normal(n)
                ).astype(np.complex64)
    for pos in (700, 2500):
        x[pos:pos + M] += 1.3 * np.exp(0.6j) * p
    da, _ = detect_pattern(jnp.asarray(x), p,
                           DetectorConfig(threshold=0.6, mode="ola"))
    dr, _ = detect_pattern(jnp.asarray(x), p,
                           DetectorConfig(threshold=0.6, mode="rif"))
    ga = sorted(np.asarray(da.position)[np.asarray(da.valid)].tolist())
    gr = sorted(np.asarray(dr.position)[np.asarray(dr.valid)].tolist())
    assert ga == gr == [700, 2500], (ga, gr)
    # gains/thetas agree too
    ia = np.argsort(np.asarray(da.position))
    ir = np.argsort(np.asarray(dr.position))
    assert np.allclose(np.asarray(da.gain)[ia], np.asarray(dr.gain)[ir],
                       rtol=1e-3)
    assert np.allclose(np.asarray(da.theta)[ia], np.asarray(dr.theta)[ir],
                       atol=1e-3)


def test_detection_callback_surface():
    """gere_detection-style callback driver (detection.cc:357-364)."""
    from libtsd_jax.models.detector import detect_with_callback
    rng_ = np.random.default_rng(12)
    M = 48
    p = (rng_.standard_normal(M) + 1j * rng_.standard_normal(M)
         ).astype(np.complex64)
    x = 0.05 * (rng_.standard_normal(4096)
                + 1j * rng_.standard_normal(4096)).astype(np.complex64)
    for pos in (400, 1900):
        x[pos:pos + M] += p
    seen = []
    detect_with_callback(jnp.asarray(x), p, seen.append,
                         DetectorConfig(threshold=0.6))
    assert [d["position"] for d in seen] == [400, 1900]
    assert all(d["score"] > 0.6 for d in seen)


def test_stream_receiver_any_push_size(frame_setup):
    """StreamReceiver (parity: the reference receiver's internal
    re-blocking via tampon_création, tsd.cc:303-386): arbitrary push
    sizes, multiple frames, zero-error decodes, flush() emits trailing
    frames."""
    from libtsd_jax.models.frame import StreamReceiver
    wf, fmt = frame_setup
    tx = Transmitter.create(fmt)
    payload = randbits(jax.random.PRNGKey(1), 256)
    frame = np.asarray(tx.transmit(payload))
    rng = np.random.default_rng(0)
    stream = (0.01 * (rng.standard_normal(20000)
                      + 1j * rng.standard_normal(20000))).astype(np.complex64)
    for pos in (900, 5000, 13000):
        stream[pos:pos + len(frame)] += frame
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5))
    sr = StreamReceiver(rx)
    i = 0
    for sz in (700, 1333, 4096, 2048, 977, 5000, 6000):
        sr.push(stream[i:i + sz])
        i += sz
    sr.push(stream[i:])
    sr.flush()
    assert sr.nframes >= 3
    clean = 0
    for fr in sr.frames:
        _, errs, _ = BER.cmp_bits(payload, jnp.asarray(fr.bits), 4)
        clean += (errs == 0)
    assert clean >= 3
