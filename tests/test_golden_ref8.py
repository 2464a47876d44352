"""Golden diff #8: the FULL Récepteur composite + both stand-alone
demodulator architectures against the reference binary
(refbuild/golden_gen8.cc; recepteur.cc:31-785, demod-dec.cc:193-625,
demod-ndec.cc:17-408).

This closes the last self-certified parity claim: the
flagship composite's decoded bits are diffed BIT-EXACT against the
reference's own decoded output on identical impaired multi-frame
signals, the detection metadata (position/frac/gain/θ/score) against the
reference's Detection records, and the corrected symbol trajectory x1
against the reference's RécepteurTrame::x1.

Known estimator-convention deviations (documented, both sides sane):
* SNR_dB: in a NOISE-FREE golden the "noise" the estimators see is the
  residual ISI/interpolation floor, where the two implementations
  measure different things (reference: detector sigma-noise estimate;
  ours: correlation-residual).  Both report >10 dB; no strict diff.
* EbN0: the reference derives it from the detector SNR (recepteur.cc:
  477); ours is an EVM-based full-frame estimate (frame.py).  Same
  regime, different estimator; asserted sane, not equal.
* position: ours is a constant +2 samples vs the reference's convention
  (pattern-start index vs the reference's detector lag accounting);
  the OFFSET-CORRECTED precise positions agree to <0.2 samples and the
  frame SPACINGS agree exactly.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def g(name):
    return np.load(os.path.join(GOLD, name + ".npy"))


def lcg_bits(seed: int, n: int) -> np.ndarray:
    """The deterministic bit source of golden_gen8.cc (same LCG)."""
    s = seed
    out = []
    for _ in range(n):
        s = (s * 1103515245 + 12345) & 0xFFFFFFFF
        out.append((s >> 16) & 1)
    return np.asarray(out, np.uint8)


HDR = lcg_bits(0xACE1, 64)
POS_OFFSET = 2  # our pattern-start convention vs the reference's


def _ps():
    from libtsd_jax.models.waveform import PulseShape
    return PulseShape.rcs(0.25)


def _receive(tag, wf, hdr_wf=None):
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import FrameFormat, Receiver
    from libtsd_jax.models.modulator import ModConfig
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in HDR),
                      payload_bits=512, header_wf=hdr_wf)
    # generator seuil = 0.6 (golden_gen8.cc run_rx callers)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.6))
    fr = rx.receive(jnp.asarray(g(f"g8_{tag}_x")))
    idx = np.nonzero(np.asarray(fr.valid))[0]
    host = jax.tree_util.tree_map(lambda a: np.asarray(a)[idx], fr)
    return host


def _check_frames(tag, host, tx_seeds, traj_tol):
    meta = g(f"g8_{tag}_meta").reshape(-1, 8)
    nf = meta.shape[0]
    assert len(host.bits) == nf, (len(host.bits), nf)
    mypos = host.detection.position + host.detection.position_frac
    refpos = meta[:, 1]
    # frame spacings agree exactly (integer part) and precise positions
    # agree to <0.2 samples after the constant convention offset
    assert np.array_equal(np.diff(host.detection.position),
                          np.diff(meta[:, 0]).astype(np.int64))
    assert np.abs(mypos - (refpos + POS_OFFSET)).max() < 0.2, mypos - refpos
    # RF parameters measured on the header
    assert np.abs(host.detection.gain - meta[:, 2]).max() < 0.015
    assert np.abs(host.detection.theta - meta[:, 3]).max() < 0.015
    assert np.abs(host.detection.score - meta[:, 5]).max() < 0.02
    assert (host.detection.snr_db > 10).all() and (meta[:, 4] > 10).all()
    assert (host.EbN0_db > 12).all() and (meta[:, 6] > 12).all()
    for f in range(nf):
        tx = lcg_bits(tx_seeds[f], 512)
        refbits = g(f"g8_{tag}_bits_f{f}")
        # bit-exact: us == reference == transmitted
        assert np.array_equal(refbits, tx), f"reference frame {f} errs"
        assert np.array_equal(host.bits[f], tx), f"our frame {f} errs"
        # corrected symbol trajectory vs RécepteurTrame::x1
        x1 = g(f"g8_{tag}_x1_f{f}")
        d = np.abs(host.symbols[f][: len(x1)] - x1[: len(host.symbols[f])])
        assert d.max() < traj_tol, d.max()


def test_rx1_qpsk_receiver_matches_reference():
    """3-frame QPSK SRRC(0.25) osf=4 burst reception, gain 0.8 / phase
    0.4 rad / fractional delay 0.35: bits bit-exact, metadata and x1
    trajectory toleranced (recepteur.cc full chain)."""
    from libtsd_jax.models.waveform import wf_qpsk
    host = _receive("rx1", wf_qpsk(_ps()))
    _check_frames("rx1", host, [1001, 1002, 1003], traj_tol=0.12)


def test_rx2_ndec_architecture_golden_content():
    """The reference run with ARCHI_SANS_DECISION on the same signal:
    its frames 1-2 decode clean; frame 0 carries acquisition-transient
    errors (the ndec loops start unlocked at the burst edge — reference
    behavior, demod-ndec.cc).  Our receiver decodes all three clean
    (test_rx1; the golden documents the architecture delta)."""
    for f, seed in [(1, 1002), (2, 1003)]:
        assert np.array_equal(g(f"g8_rx2_bits_f{f}"), lcg_bits(seed, 512))
    errs0 = int((g("g8_rx2_bits_f0") != lcg_bits(1001, 512)).sum())
    assert 0 < errs0 < 100, errs0  # the recorded acquisition transient


def test_rx3_qam16_receiver_matches_reference():
    """QAM-16 version (BASELINE config-5 waveform), 2 frames, gain 0.9 /
    phase -0.3 / frac delay 0.35."""
    from libtsd_jax.models.waveform import wf_qam
    host = _receive("rx3", wf_qam(16, _ps()))
    _check_frames("rx3", host, [2001, 2002], traj_tol=0.15)


def test_rxh_header_waveform_tx_matches_reference():
    """fo_entete TX parity (emetteur.cc:80-95): BPSK header + QAM-16
    payload through ONE shared shaping filter.  Align for the latency
    convention, then require float32-level agreement."""
    from libtsd_jax.models.frame import FrameFormat, Transmitter
    from libtsd_jax.models.modulator import ModConfig
    from libtsd_jax.models.waveform import wf_bpsk, wf_qam
    fmt = FrameFormat(
        modulation=ModConfig(wf=wf_qam(16, _ps()), fe=4.0, fsymb=1.0),
        header_bits=tuple(int(b) for b in HDR),
        payload_bits=512, header_wf=wf_bpsk(_ps()))
    tx = Transmitter.create(fmt)
    w = np.asarray(tx.transmit(jnp.asarray(lcg_bits(3001, 512))))
    ref = g("g8_rxh_txwave")
    n = min(len(w), len(ref))
    c = np.abs(np.correlate(w[:n], ref[:n], "full"))
    lag = int(c.argmax()) - (n - 1)
    assert abs(lag) <= 8, lag
    wa = np.roll(w[:n], -lag)
    sl = slice(30, n - 30)
    err = np.abs(wa[sl] - ref[sl])
    assert err.max() < 1e-5 * np.abs(ref).max(), (lag, err.max())


def test_rxh_header_waveform_receiver_matches_reference():
    """fo_entete RX: BPSK-header detection + data-aided header tracking,
    QAM-16 payload decode — against the reference receiver configured
    with format.fo_entete (recepteur.cc:186-193,229-231,470-477)."""
    from libtsd_jax.models.waveform import wf_bpsk, wf_qam
    host = _receive("rxh", wf_qam(16, _ps()), hdr_wf=wf_bpsk(_ps()))
    _check_frames("rxh", host, [3001, 3002], traj_tol=0.15)


# ------------------------- stand-alone demodulator architectures


def _demod_input():
    return jnp.asarray(g("g8_d_x")), g("g8_d_bits").astype(np.int8)


def test_d1_decision_demod_matches_reference():
    """Stand-alone decision-directed demod (demod-dec.cc:193-625) on a
    QPSK stream with gain 1.3 / phase 0.25 / frac delay 0.3: after the
    acquisition region both the reference's output and ours decode the
    TX bits with zero errors (compared through the QPSK rotation/lag
    resolver), and therefore agree with each other."""
    from libtsd_jax.models import ber as BER
    from libtsd_jax.models.demod_dec import DecDemodConfig
    from libtsd_jax.models.demod_dec2 import DecisionDemod2
    from libtsd_jax.models.waveform import wf_qpsk
    x, bits = _demod_input()
    dd = DecisionDemod2.create(wf_qpsk(_ps()), DecDemodConfig(osf=4))
    _, (b, _, _, bval) = dd.step(dd.init(), x)
    mine = np.asarray(b)[np.asarray(bval)]
    ref = g("g8_d1_bits").astype(np.int8)
    for out in (mine, ref):
        _, errs, _ = BER.cmp_bits_psk(jnp.asarray(bits[512:]),
                                      jnp.asarray(out[512:]), 2,
                                      max_lag=64)
        assert int(errs) == 0
    _, errs, _ = BER.cmp_bits_psk(jnp.asarray(ref[512:]),
                                  jnp.asarray(mine[512:]), 2, max_lag=64)
    assert int(errs) == 0


def test_d2_nondecision_demod_matches_reference():
    """Stand-alone non-decision demod (demod-ndec.cc:17-408): same
    input; our composed chain (matched filter -> Gardner -> Costas)
    agrees with the reference's steady-state output bit-for-bit (lag 0
    after the rotation resolver) and decodes the TX cleanly."""
    from libtsd_jax.models import ber as BER
    from libtsd_jax.models.demod import DemodConfig, Demodulator
    from libtsd_jax.models.waveform import wf_qpsk
    x, bits = _demod_input()
    dm = Demodulator.create(DemodConfig(wf=wf_qpsk(_ps()), fe=4.0,
                                        fsymb=1.0))
    b, _, _, bmask = dm.demodulate(x)
    mine = np.asarray(b)[np.asarray(bmask)]
    ref = g("g8_d2_bits").astype(np.int8)
    for out in (mine, ref):
        _, errs, _ = BER.cmp_bits_psk(jnp.asarray(bits[512:]),
                                      jnp.asarray(out[512:]), 2,
                                      max_lag=64)
        assert int(errs) == 0
    _, errs, _ = BER.cmp_bits_psk(jnp.asarray(ref[512:]),
                                  jnp.asarray(mine[512:]), 2, max_lag=64)
    assert int(errs) == 0


def test_rx1_stride8_pll_bit_exact():
    """The stride-8 grouped residual PLL (the serving configuration)
    decodes the golden signal with the same bits and near-identical
    metadata as the reference."""
    import dataclasses
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import FrameFormat, Receiver
    from libtsd_jax.models.modulator import ModConfig
    from libtsd_jax.models.waveform import wf_qpsk
    fmt = FrameFormat(modulation=ModConfig(wf=wf_qpsk(_ps()),
                                           fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in HDR),
                      payload_bits=512)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.6),
                         pll_stride=8)
    fr = rx.receive(jnp.asarray(g("g8_rx1_x")))
    idx = np.nonzero(np.asarray(fr.valid))[0]
    assert len(idx) == 3
    meta = g("g8_rx1_meta").reshape(-1, 8)
    for j, i in enumerate(idx):
        tx = lcg_bits([1001, 1002, 1003][j], 512)
        assert np.array_equal(np.asarray(fr.bits)[i], tx)
        assert abs(float(np.asarray(fr.detection.gain)[i])
                   - meta[j, 2]) < 0.015
        assert abs(float(np.asarray(fr.detection.theta)[i])
                   - meta[j, 3]) < 0.015


def test_rxp_pi4_qpsk_receiver_matches_reference():
    """pi/4-QPSK framed reception: the rotating-constellation parity
    logic (reference: demod->reset(nb_symb_entete), recepteur.cc:487)
    against the binary — bits bit-exact, metadata toleranced."""
    from libtsd_jax.models.waveform import wf_pi4_qpsk
    host = _receive("rxp", wf_pi4_qpsk(_ps()))
    _check_frames("rxp", host, [5001, 5002], traj_tol=0.15)


def test_rxf_fsk_receiver_decodes_reference_frames():
    """2-FSK (index 1.0, NRZ) framed reception — the receiver's
    discriminator branch.  CONVENTION DELTA (documented): the reference
    detects the header on the DISCRIMINATED real signal
    (recepteur.cc:412-425); we detect on the complex IQ, whose
    constant-envelope autocorrelation has higher sidelobes — threshold
    0.7 rejects them (the reference's 0.55 works on its discriminated
    pattern).  Gain conventions differ for the same reason (ours is an
    IQ amplitude, its is post-discriminator); bits + positions gate."""
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import FrameFormat, Receiver
    from libtsd_jax.models.modulator import ModConfig
    from libtsd_jax.models.waveform import PulseShape, wf_fsk
    wf = wf_fsk(2, index=1.0, shaping=PulseShape.nrz())
    fmt = FrameFormat(modulation=ModConfig(wf=wf, fe=4.0, fsymb=1.0),
                      header_bits=tuple(int(b) for b in HDR),
                      payload_bits=512)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.7))
    fr = rx.receive(jnp.asarray(g("g8_rxf_x")))
    idx = np.nonzero(np.asarray(fr.valid))[0]
    meta = g("g8_rxf_meta").reshape(-1, 8)
    assert len(idx) == meta.shape[0] == 2
    for j, i in enumerate(idx):
        tx = lcg_bits([6001, 6002][j], 512)
        assert np.array_equal(g(f"g8_rxf_bits_f{j}"), tx)
        assert np.array_equal(np.asarray(fr.bits)[i], tx)
        # positions: constant convention offset (+3 here: the
        # discriminator path shifts the reference's pattern by one)
        d = int(np.asarray(fr.detection.position)[i]) - meta[j, 0]
        assert 1 <= d <= 4, d


def test_rxn_noisy_receiver_at_least_reference_parity():
    """12 QPSK frames under seeded AWGN (Eb/N0 ~ 7 dB) — BOTH receivers
    decode the IDENTICAL noisy samples.  The golden records the
    reference's outcome: 7/12 frames clean, 7 errored payload bits on
    real frames, 1 spurious detection (its frame 11 at position 20954
    matches no transmitted payload).  Gate: our receiver decodes AT
    LEAST as many clean frames with no more total bit errors and no
    more spurious detections (measured: 8 clean, 6 errored bits, 1
    spurious)."""
    from libtsd_jax.models.detector import DetectorConfig
    from libtsd_jax.models.frame import FrameFormat, Receiver
    from libtsd_jax.models.modulator import ModConfig
    from libtsd_jax.models.waveform import wf_qpsk
    tx_all = [lcg_bits(7001 + f, 512) for f in range(12)]

    def classify(bits_list):
        clean = errbits = spurious = 0
        for bits in bits_list:
            best = min(int((bits != tx).sum()) for tx in tx_all)
            if best == 0:
                clean += 1
            elif best > 50:
                spurious += 1
            else:
                errbits += best
        return clean, errbits, spurious

    meta = g("g8_rxn_meta").reshape(-1, 8)
    ref = classify([g(f"g8_rxn_bits_f{j}")
                    for j in range(meta.shape[0])])
    assert ref == (7, 7, 1), ref      # the recorded reference outcome

    fmt = FrameFormat(
        modulation=ModConfig(wf=wf_qpsk(_ps()), fe=4.0, fsymb=1.0),
        header_bits=tuple(int(b) for b in HDR), payload_bits=512)
    rx = Receiver.create(fmt, DetectorConfig(threshold=0.5,
                                             max_peaks=24))
    fr = rx.receive(jnp.asarray(g("g8_rxn_x")))
    idx = np.nonzero(np.asarray(fr.valid))[0]
    mine = classify([np.asarray(fr.bits)[i] for i in idx])
    assert mine[0] >= ref[0], (mine, ref)     # clean frames
    assert mine[1] <= ref[1], (mine, ref)     # errored bits
    assert mine[2] <= ref[2], (mine, ref)     # spurious detections


def test_reference_demod_llr_output_is_dead():
    """REFERENCE DEFECT #16 (recorded by the golden): both demodulator
    architectures take the LLR output parameter their API documents
    ('un train de LLR', telecom.hpp demod docs) and NEVER write it —
    demod-dec.cc:314 / demod-ndec.cc:172 declare `Tabf &llr` and no
    statement assigns it, so golden_gen8 captured 0-element arrays.
    Our max-log-MAP LLRs (models/demod.llr) are live: finite, correctly
    shaped, and sign-consistent with the hard decisions."""
    from libtsd_jax.models.demod import llr
    from libtsd_jax.models.waveform import wf_qpsk
    assert g("g8_d1_llr").size == 0
    assert g("g8_d2_llr").size == 0
    wf = wf_qpsk(_ps())
    syms = wf.make_symbols(jnp.asarray(lcg_bits(1, 64), jnp.int8))
    L = np.asarray(llr(wf, syms))
    assert L.shape == (64,)          # k=2 bits x 32 symbols
    assert np.isfinite(L).all()
    bits = lcg_bits(1, 64)
    # LLR convention: (d0 - d1)/sigma^2 — NEGATIVE when bit 0 was sent
    # (d0 ~ 0), positive favors bit 1
    agree = np.mean((L > 0) == (bits == 1))
    assert agree == 1.0, agree
