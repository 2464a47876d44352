"""Flagship pipeline tests: FM receiver chain (BASELINE config 4) and
QAM-16 modem with Gardner + decision carrier loop (config 5), including
multi-channel sharded runs."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from libtsd_jax.block import stream
from libtsd_jax.models import channel as CH
from libtsd_jax.models import ber as BER
from libtsd_jax.models.analog import fm_modulate
from libtsd_jax.models.bitstream import randbits
from libtsd_jax.models.receivers import (FmReceiver, FmReceiverConfig,
                                         Qam16Modem, evm)


def make_fm_if_signal(audio, cfg, n):
    """Place an FM signal at the channel frequency."""
    x = fm_modulate(audio, deviation=cfg.deviation / cfg.decim)
    k = jnp.arange(x.shape[-1], dtype=jnp.float32)
    lo = jnp.exp(2j * jnp.pi * cfg.channel_freq * k).astype(jnp.complex64)
    return (x * lo)[:n]


def test_fm_receiver_chain():
    cfg = FmReceiverConfig(channel_freq=0.2, decim=4, deviation=0.1,
                           deemph_fc=0.0)
    rx = FmReceiver.create(cfg)
    n = 8192
    t = np.arange(n)
    audio_true = np.sin(2 * np.pi * 0.004 * t).astype(np.float32)
    x = make_fm_if_signal(jnp.asarray(audio_true), cfg, n)
    st = rx.init_for(x)
    _, audio = rx.step(st, x)
    audio = np.asarray(audio)
    # recovered audio at the decimated rate matches the decimated original
    expected = audio_true[::4][: len(audio)]
    # skip the channel-filter transient, compensate its group delay
    d = int(rx.chan_filt.delay)
    seg = audio[50:-50]
    ref = expected[50 - d:len(seg) + 50 - d] if d <= 50 else expected
    m = min(len(seg), len(ref))
    corr = np.corrcoef(seg[:m], ref[:m])[0, 1]
    assert corr > 0.99, corr


def test_fm_receiver_multichannel_batched():
    cfg = FmReceiverConfig(channel_freq=0.15, decim=4, deviation=0.1,
                           deemph_fc=0.0)
    rx = FmReceiver.create(cfg)
    n = 4096
    freqs = [0.003, 0.006]
    auds = [np.sin(2 * np.pi * f * np.arange(n)).astype(np.float32)
            for f in freqs]
    xs = jnp.stack([make_fm_if_signal(jnp.asarray(a), cfg, n) for a in auds])
    st = rx.init_for(xs)
    _, audio = rx.step(st, xs)
    audio = np.asarray(audio)
    assert audio.shape == (2, n // 4)
    for c, f in enumerate(freqs):
        seg = audio[c, 100:-100]
        # dominant frequency of recovered audio = 4*f at decimated rate
        sp = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
        fpk = np.argmax(sp) / len(seg)
        assert abs(fpk - 4 * f / 4 * 4) < 0.003, (c, fpk, 4 * f)


def test_fm_receiver_streaming():
    cfg = FmReceiverConfig(channel_freq=0.2, decim=4, deviation=0.1,
                           deemph_fc=0.0)
    rx = FmReceiver.create(cfg)
    n = 8192
    audio_true = np.sin(2 * np.pi * 0.004 * np.arange(n)).astype(np.float32)
    x = make_fm_if_signal(jnp.asarray(audio_true), cfg, n)
    # streaming in 512-sample blocks == one shot
    st = rx.init_for(x)
    _, y_once = rx.step(st, x)
    st = rx.init_for(x)
    outs = []
    for i in range(0, n, 512):
        st, y = rx.step(st, x[i:i + 512])
        outs.append(np.asarray(y))
    y_stream = np.concatenate(outs)
    # fp32 accumulation ordering differs slightly between blockings
    assert np.max(np.abs(y_stream - np.asarray(y_once))) < 1e-3


def test_qam16_modem_clean():
    modem = Qam16Modem.create(osf=4)
    nsym = 2000
    bits = randbits(jax.random.PRNGKey(0), 4 * nsym)
    x = modem.transmit(bits)
    # small timing offset for the Gardner loop to chew on
    from libtsd_jax.ops.fft import delay_signal
    x = delay_signal(x, 1.3)
    rx_bits, syms, mask, ev = modem.receive(x)
    rb = np.asarray(rx_bits)[np.asarray(jnp.repeat(mask, 4))]
    ber, errs, lag = BER.cmp_bits(bits[4 * 400:], jnp.asarray(rb[4 * 400:]),
                                  max_lag=64)
    assert ber < 0.01, (ber, errs)
    assert float(ev) < 0.15, float(ev)


def test_qam16_modem_awgn_evm():
    modem = Qam16Modem.create(osf=4)
    nsym = 3000
    bits = randbits(jax.random.PRNGKey(1), 4 * nsym)
    x = modem.transmit(bits)
    EbN0 = 18.0
    y = CH.awgn(jax.random.PRNGKey(2), x, EbN0, osf=4, k_bits=4)
    rx_bits, syms, mask, ev = modem.receive(y)
    # Es/N0 = EbN0 + 10log10(4) = 24 dB -> EVM ~ 10^(-24/20) ~ 6.3%
    assert 0.03 < float(ev) < 0.15, float(ev)
    rb = np.asarray(rx_bits)[np.asarray(jnp.repeat(mask, 4))]
    ber, errs, lag = BER.cmp_bits(bits[4 * 500:], jnp.asarray(rb[4 * 500:]),
                                  max_lag=64)
    th = float(modem.wf.ber(EbN0))
    assert ber < max(10 * th, 0.01), (ber, th)


def test_qam16_modem_sharded_channels():
    """Config 5 shape: the modem RX vmapped over channels on a chan-sharded
    mesh."""
    from libtsd_jax.parallel import make_mesh, P, NamedSharding
    mesh = make_mesh(chan=8, time=1)
    modem = Qam16Modem.create(osf=4)
    C = 8
    nsym = 500
    keys = [jax.random.PRNGKey(10 + i) for i in range(C)]
    bits = jnp.stack([randbits(k, 4 * nsym) for k in keys])
    tx = jax.vmap(modem.transmit)(bits)
    txs = jax.device_put(tx, NamedSharding(mesh, P("chan", None)))

    @jax.jit
    def rx_all(m, v):
        return jax.vmap(lambda s: m.receive(s)[3])(v)  # per-channel EVM

    evs = np.asarray(rx_all(modem, txs))
    assert evs.shape == (C,)
    assert np.all(evs < 0.12), evs


@pytest.mark.parametrize("decim,deemph_fc", [(4, 0.05), (4, 0.0),
                                             (8, 0.05), (2, 0.02)])
def test_fm_receiver_matches_numpy_chain(decim, deemph_fc):
    """FmReceiver vs the composed NumPy reference over two channels and
    three streamed blocks."""
    from libtsd_jax.utils.testing import fm_receiver_ref
    cfg = FmReceiverConfig(channel_freq=0.2, decim=decim, deviation=0.1,
                           deemph_fc=deemph_fc)
    rx = FmReceiver.create(cfg)
    n = 3 * 1024
    t = np.arange(n)
    auds = [np.sin(2 * np.pi * f * t).astype(np.float32)
            for f in (0.002, 0.003)]
    x = np.stack([np.asarray(make_fm_if_signal(jnp.asarray(a), cfg, n))
                  for a in auds])
    x = x + 0.01 * np.random.default_rng(decim).standard_normal(x.shape)
    x = x.astype(np.complex64)
    st = rx.init_for(jnp.asarray(x[:, :1024]))
    outs = []
    for b0 in range(0, n, 1024):
        st, y = rx.step(st, jnp.asarray(x[:, b0:b0 + 1024]))
        outs.append(np.asarray(y))
    got = np.concatenate(outs, axis=-1)
    ref = fm_receiver_ref(rx, x)
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 2e-3
