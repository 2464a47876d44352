#!/usr/bin/env python
"""Protocol decoders demo: ADS-B (Mode S 1090ES) and POCSAG paging.

The reference library only DECLARES these decoders
(core/include/tsd/telecom/protocols.hpp) — this framework ships working
ones.  The demo synthesizes both signals, impairs them, and decodes:

* ADS-B: three real (publicly documented) DF17 squitters — an aircraft
  ident and an even/odd airborne-position pair — are placed in a noisy
  magnitude stream and pushed through the STREAMING sink in odd-size
  chunks; the even/odd pair is combined into a global CPR position fix.
* POCSAG: an alphanumeric page is FSK-modulated at 1200 baud with a
  carrier offset and AWGN, then decoded with automatic baud detection.

Run:
    python examples/protocols_demo.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from libtsd_jax.models import adsb as A
from libtsd_jax.models import pocsag as P


def hexbits(h: str) -> np.ndarray:
    v = int(h, 16)
    n = 4 * len(h)
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.int8)


def adsb_demo():
    print("== ADS-B ==")
    rng = np.random.default_rng(0)
    osf = 2                                     # 2 MS/s capture
    frames = {  # documented example squitters (mode-s.org guide)
        4000: "8D4840D6202CC371C32CE0576098",   # ident KLM1023
        9000: "8D40621D58C382D690C8AC2863A7",   # position, even
        15000: "8D40621D58C386435CC412692AD6",  # position, odd
    }
    x = 0.02 * np.abs(rng.standard_normal(1 << 15)).astype(np.float32)
    for pos, h in frames.items():
        wf = A.adsb_waveform(hexbits(h), osf=osf)
        x[pos:pos + len(wf)] += 0.8 * wf

    sink = A.AdsbStream(A.AdsbConfig(fe=osf * 1e6, Ne=1 << 13))
    got = []
    i = 0
    while i < len(x):                            # odd-size SDR pushes
        n = int(min(len(x) - i, 3000 + 500 * (i % 3)))
        got += sink.push(x[i:i + n])
        i += n
    cpr = {}
    for fr in got:
        print(f"  @{fr.position:6d} score {fr.score:.2f}  {fr.text}")
        b = fr.bits
        if 9 <= A._field(b, 32, 37) <= 18:
            cpr[int(b[53])] = (A._field(b, 54, 71), A._field(b, 71, 88))
    if len(cpr) == 2:
        lat, lon = A.cpr_global(*cpr[0], *cpr[1], newest_odd=False)
        print(f"  CPR global fix: lat {lat:.5f}  lon {lon:.5f}")


def pocsag_demo():
    print("== POCSAG ==")
    fe, fi, baud = 48000.0, 3000.0, 1200
    bits = P.pocsag_encode(ric=1300500, function=3,
                           text="CALL DISPATCH 555-0117")
    z = P.pocsag_waveform(bits, fe=fe, debit=baud, fi=fi)
    rng = np.random.default_rng(1)
    z = z + 0.25 * (rng.standard_normal(len(z)) + 1j *
                    rng.standard_normal(len(z))).astype(np.complex64)
    dec = P.PocsagDecoder(P.PocsagConfig(fe=fe, fi=fi, debit=-1))
    msgs, got_baud = dec.decode(z, return_baud=True)
    print(f"  detected baud: {got_baud}")
    for m in msgs:
        print(f"  RIC {m.ric}  fn {m.function}  text: {m.text!r}")


def rds_demo():
    print("== RDS ==")
    import jax.numpy as jnp
    from libtsd_jax.models import rds as R
    from libtsd_jax.models.analog import fm_broadcast_multiplex
    from libtsd_jax.ops.signal import cycles
    fe = 1.024e6
    pi, pty = 0xF201, 10
    groups = [R.rds_group_0a(pi, pty, s, "TSD JAX!"[2 * s:2 * s + 2])
              for s in range(4)]
    groups += [R.rds_group_2a(pi, pty, a, "JAX NATIVE DSP! "[4 * a:4 * a + 4])
               for a in range(4)]
    bits = R.rds_encode_groups(groups * 3)
    n = int(len(bits) / R._BITRATE * fe) + 65536
    al = 0.3 * jnp.sin(2 * jnp.pi * cycles(440.0 / fe, n))
    ar = 0.3 * jnp.sin(2 * jnp.pi * cycles(1000.0 / fe, n))
    x = fm_broadcast_multiplex(al, ar, fe,
                               rds=R.rds_subcarrier(bits, fe, n))
    got = R.rds_decode(x, fe)     # full FM front end + coherent decode
    ok = [g for g in got if g.errors[0] == 0]
    print(f"  groups decoded: {len(got)} ({len(ok)} clean)")
    if ok:
        print(f"  PI: 0x{ok[0].pi:04X}  PTY: {ok[0].pty}")
    else:
        print("  no clean PI block decoded (all groups carry errors)")
    print(f"  PS name:   {R.rds_station_name(got)!r}")
    print(f"  RadioText: {R.rds_radiotext(got)!r}")


if __name__ == "__main__":
    from libtsd_jax.platform import enable_compile_cache
    enable_compile_cache()
    adsb_demo()
    pocsag_demo()
    rds_demo()
