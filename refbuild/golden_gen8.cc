// Golden-output generator #8: the FULL Récepteur composite and both
// stand-alone demodulator architectures, diffed against the reference
// binary.
//
// Scenarios (all inputs deterministic: LCG bits, FFT fractional delay,
// fixed gain/phase — no RNG anywhere, so the .npy files are bit-for-bit
// reproducible):
//  R1  QPSK  SRRC(0.25) osf=4 framed receiver, 3 frames, impairments
//      gain 0.8 / phase +0.4 rad / fractional delay 0.35 samples
//      (recepteur.cc:31-785, demod dec architecture — the default).
//  R2  same signal through ARCHI_SANS_DECISION (demod-ndec.cc:17-408).
//  R3  QAM-16 version of R1 (BASELINE config-5 waveform).
//  RH  distinct header waveform (fo_entete, telecom.hpp:1214): BPSK
//      header + QAM-16 payload — clean TX dump (emetteur.cc:80-95) and
//      a full impaired receiver pass.
//  D1  stand-alone Démodulateur, ARCHI_AVEC_DECISION (demod-dec.cc:
//      193-625): QPSK osf=4 continuous stream, gain 1.3 / phase 0.25 /
//      fractional delay 0.3 (clock + carrier loops both exercised).
//  D2  same input, ARCHI_SANS_DECISION.
//
// Per frame the receiver dump carries the decoded bits, the detection
// metadata (position, position_prec, gain, θ, SNR_dB, score), EbN0 and
// the corrected symbol trajectory x1 (telecom.hpp:1256-1272).
#include "tsd/tsd-all.hpp"
#include "tsd/telecom.hpp"
#include <cstdio>
#include <cstdint>
#include <string>
#include <vector>
#include <complex>

using namespace tsd;
using namespace tsd::filtrage;
using namespace tsd::fourier;
using namespace tsd::telecom;

static void npy_write_header(FILE *f, const char *descr, size_t n)
{
  std::string hdr = "{'descr': '" + std::string(descr) +
                    "', 'fortran_order': False, 'shape': (" +
                    std::to_string(n) + ",), }";
  size_t total = 10 + hdr.size() + 1;
  size_t pad = (64 - total % 64) % 64;
  hdr += std::string(pad, ' ');
  hdr += '\n';
  uint16_t hlen = (uint16_t) hdr.size();
  fwrite("\x93NUMPY\x01\x00", 1, 8, f);
  fwrite(&hlen, 2, 1, f);
  fwrite(hdr.data(), 1, hdr.size(), f);
}

static void save_f32(const std::string &path, const Vecf &x)
{
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(1); }
  npy_write_header(f, "<f4", x.rows());
  for (auto i = 0; i < x.rows(); i++) { float v = x(i); fwrite(&v, 4, 1, f); }
  fclose(f);
  printf("wrote %s (%d f32)\n", path.c_str(), x.rows());
}

static void save_c64(const std::string &path, const Veccf &x)
{
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(1); }
  npy_write_header(f, "<c8", x.rows());
  for (auto i = 0; i < x.rows(); i++) {
    std::complex<float> v = x(i);
    fwrite(&v, 8, 1, f);
  }
  fclose(f);
  printf("wrote %s (%d c8)\n", path.c_str(), x.rows());
}

static void save_u8(const std::string &path, const std::vector<uint8_t> &x)
{
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path.c_str()); exit(1); }
  npy_write_header(f, "|u1", x.size());
  fwrite(x.data(), 1, x.size(), f);
  fclose(f);
  printf("wrote %s (%zu u8)\n", path.c_str(), x.size());
}

// Deterministic bit source shared with tests/test_golden_ref8.py.
static std::vector<uint8_t> lcg_bits(uint32_t seed, int n)
{
  std::vector<uint8_t> out;
  uint32_t s = seed;
  for (int i = 0; i < n; i++) {
    s = s * 1103515245u + 12345u;
    out.push_back((s >> 16) & 1);
  }
  return out;
}

static BitStream to_bs(const std::vector<uint8_t> &bits)
{
  BitStream bs;
  for (auto b : bits) bs.push(b);
  return bs;
}

// Impairment chain: FFT fractional delay, then gain * e^{jθ}
// (tsd::fourier::délais — deterministic, no RNG).
static Veccf impair(const Veccf &x, float delay, float gain, float theta)
{
  Veccf y = délais(x, delay);
  std::complex<float> g = std::polar(gain, theta);
  for (auto i = 0; i < y.rows(); i++) y(i) *= g;
  return y;
}

// Build a multi-frame signal: gaps of zeros interleaved with frames.
static Veccf build_signal(sptr<Émetteur> em,
                          const std::vector<std::vector<uint8_t>> &payloads,
                          const std::vector<int> &gaps, int tail)
{
  std::vector<Veccf> parts;
  int total = 0;
  for (size_t i = 0; i < payloads.size(); i++) {
    Veccf z = Veccf::zeros(gaps[i]);
    parts.push_back(z);
    total += gaps[i];
    Veccf fr = em->step(to_bs(payloads[i]));
    parts.push_back(fr);
    total += fr.rows();
  }
  parts.push_back(Veccf::zeros(tail));
  total += tail;
  Veccf out(total);
  int off = 0;
  for (auto &p : parts) {
    for (auto i = 0; i < p.rows(); i++) out(off + i) = p(i);
    off += p.rows();
  }
  return out;
}

// Run a receiver over the signal and dump everything under `tag`.
static void run_rx(const std::string &dir, const std::string &tag,
                   const RécepteurConfig &rc, const Veccf &y)
{
  soit rec = récepteur_création(rc);
  soit trames = rec->step(y);
  printf("%s: %zu frames decoded\n", tag.c_str(), trames.size());
  Vecf meta(8 * (int) trames.size());
  for (size_t i = 0; i < trames.size(); i++) {
    soit &t = trames[i];
    meta(8 * i + 0) = t.det.position;
    meta(8 * i + 1) = t.det.position_prec;
    meta(8 * i + 2) = t.det.gain;
    meta(8 * i + 3) = t.det.θ;
    meta(8 * i + 4) = t.det.SNR_dB;
    meta(8 * i + 5) = t.det.score;
    meta(8 * i + 6) = t.EbN0;
    meta(8 * i + 7) = t.bs.lon();
    std::vector<uint8_t> bits;
    for (auto j = 0; j < t.bs.lon(); j++) bits.push_back(t.bs[j] ? 1 : 0);
    save_u8(dir + "/" + tag + "_bits_f" + std::to_string(i) + ".npy", bits);
    save_c64(dir + "/" + tag + "_x1_f" + std::to_string(i) + ".npy", t.x1);
  }
  save_f32(dir + "/" + tag + "_meta.npy", meta);
}

int main(int argc, char **argv)
{
  std::string dir = argc > 1 ? argv[1] : ".";
  auto P = [&](const char *n) { return dir + "/" + n; };

  soit filtre = SpecFiltreMiseEnForme::rcs(0.25f);
  soit hdr_bits = lcg_bits(0xACE1u, 64);

  // ------------------------------------------------ R1/R2: QPSK receiver
  {
    TrameFormat fmt;
    fmt.modulation.forme_onde = forme_onde_qpsk(filtre);
    fmt.modulation.fe = 4;
    fmt.modulation.fsymb = 1;
    fmt.modulation.sortie_reelle = non;
    fmt.entete = to_bs(hdr_bits);
    fmt.nbits = 512;

    ÉmetteurConfig ec;
    ec.format = fmt;
    soit em = émetteur_création(ec);

    std::vector<std::vector<uint8_t>> payloads = {
      lcg_bits(1001u, 512), lcg_bits(1002u, 512), lcg_bits(1003u, 512)};
    for (size_t i = 0; i < payloads.size(); i++)
      save_u8(P(("g8_rx1_tx_f" + std::to_string(i) + ".npy").c_str()),
              payloads[i]);

    soit x = build_signal(em, payloads, {600, 900, 1300}, 4000);
    soit y = impair(x, 0.35f, 0.8f, 0.4f);
    save_c64(P("g8_rx1_x.npy"), y);

    RécepteurConfig rc;
    rc.format = fmt;
    rc.seuil = 0.6f;
    run_rx(dir, "g8_rx1", rc, y);

    RécepteurConfig rc2 = rc;
    rc2.config_demod.architecture = DemodConfig::ARCHI_SANS_DECISION;
    run_rx(dir, "g8_rx2", rc2, y);
  }

  // ------------------------------------------------ R3: QAM-16 receiver
  {
    TrameFormat fmt;
    fmt.modulation.forme_onde = forme_onde_qam(16, filtre);
    fmt.modulation.fe = 4;
    fmt.modulation.fsymb = 1;
    fmt.modulation.sortie_reelle = non;
    fmt.entete = to_bs(hdr_bits);
    fmt.nbits = 512;

    ÉmetteurConfig ec;
    ec.format = fmt;
    soit em = émetteur_création(ec);

    std::vector<std::vector<uint8_t>> payloads = {
      lcg_bits(2001u, 512), lcg_bits(2002u, 512)};
    for (size_t i = 0; i < payloads.size(); i++)
      save_u8(P(("g8_rx3_tx_f" + std::to_string(i) + ".npy").c_str()),
              payloads[i]);

    soit x = build_signal(em, payloads, {700, 1100}, 4000);
    soit y = impair(x, 0.35f, 0.9f, -0.3f);
    save_c64(P("g8_rx3_x.npy"), y);

    RécepteurConfig rc;
    rc.format = fmt;
    rc.seuil = 0.6f;
    run_rx(dir, "g8_rx3", rc, y);
  }

  // --------------------- RH: distinct header waveform (fo_entete)
  {
    TrameFormat fmt;
    fmt.modulation.forme_onde = forme_onde_qam(16, filtre);
    fmt.modulation.fe = 4;
    fmt.modulation.fsymb = 1;
    fmt.modulation.sortie_reelle = non;
    fmt.entete = to_bs(hdr_bits);
    fmt.fo_entete = forme_onde_bpsk(filtre);
    fmt.nbits = 512;

    ÉmetteurConfig ec;
    ec.format = fmt;
    soit em = émetteur_création(ec);

    // clean single-frame TX (emitter golden for the TX-side parity test)
    soit pay0 = lcg_bits(3001u, 512);
    save_u8(P("g8_rxh_tx_f0.npy"), pay0);
    soit fr0 = em->step(to_bs(pay0));
    save_c64(P("g8_rxh_txwave.npy"), fr0);

    // impaired two-frame receiver pass (second emitter: em->step holds
    // modulator state across calls; a fresh one keeps frames identical
    // to what the receiver expects)
    soit em2 = émetteur_création(ec);
    std::vector<std::vector<uint8_t>> payloads = {pay0, lcg_bits(3002u, 512)};
    soit x = build_signal(em2, payloads, {800, 1200}, 4000);
    soit y = impair(x, 0.35f, 0.85f, 0.2f);
    save_c64(P("g8_rxh_x.npy"), y);

    RécepteurConfig rc;
    rc.format = fmt;
    rc.seuil = 0.6f;
    run_rx(dir, "g8_rxh", rc, y);
  }

  // ------------------- RP: pi/4-QPSK framed receiver (rotation parity)
  {
    TrameFormat fmt;
    fmt.modulation.forme_onde = forme_onde_π4_qpsk(filtre);
    fmt.modulation.fe = 4;
    fmt.modulation.fsymb = 1;
    fmt.modulation.sortie_reelle = non;
    fmt.entete = to_bs(hdr_bits);
    fmt.nbits = 512;
    ÉmetteurConfig ec;
    ec.format = fmt;
    soit em = émetteur_création(ec);
    std::vector<std::vector<uint8_t>> payloads = {
      lcg_bits(5001u, 512), lcg_bits(5002u, 512)};
    for (size_t i = 0; i < payloads.size(); i++)
      save_u8(P(("g8_rxp_tx_f" + std::to_string(i) + ".npy").c_str()),
              payloads[i]);
    soit x = build_signal(em, payloads, {650, 1000}, 4000);
    soit y = impair(x, 0.25f, 0.85f, 0.3f);
    save_c64(P("g8_rxp_x.npy"), y);
    RécepteurConfig rc;
    rc.format = fmt;
    rc.seuil = 0.6f;
    run_rx(dir, "g8_rxp", rc, y);
  }

  // ------------------- RF: 2-FSK framed receiver (discriminator branch)
  {
    TrameFormat fmt;
    fmt.modulation.forme_onde = forme_onde_fsk(2, 1.0f,
                                               SpecFiltreMiseEnForme::nrz());
    fmt.modulation.fe = 4;
    fmt.modulation.fsymb = 1;
    fmt.modulation.sortie_reelle = non;
    fmt.entete = to_bs(hdr_bits);
    fmt.nbits = 512;
    ÉmetteurConfig ec;
    ec.format = fmt;
    soit em = émetteur_création(ec);
    std::vector<std::vector<uint8_t>> payloads = {
      lcg_bits(6001u, 512), lcg_bits(6002u, 512)};
    for (size_t i = 0; i < payloads.size(); i++)
      save_u8(P(("g8_rxf_tx_f" + std::to_string(i) + ".npy").c_str()),
              payloads[i]);
    soit x = build_signal(em, payloads, {700, 1100}, 4000);
    // FSK decodes FREQUENCY: amplitude/phase impairments are benign by
    // construction; keep the fractional delay to exercise the timing
    soit y = impair(x, 0.3f, 1.0f, 0.0f);
    save_c64(P("g8_rxf_x.npy"), y);
    RécepteurConfig rc;
    rc.format = fmt;
    rc.seuil = 0.55f;
    run_rx(dir, "g8_rxf", rc, y);
  }

  // -------- RN: NOISY statistical receiver comparison (identical data)
  // 12 QPSK frames under deterministic (seeded) AWGN at sigma=0.35 —
  // Es/N0 ~ 4 dB at the 0.8 gain, Eb/N0 ~ 7 dB: the reference receiver
  // decodes most-but-not-all frames cleanly; the comparison test runs
  // OUR receiver on the SAME noisy samples and gates on at-least-parity
  // clean-frame count.
  {
    TrameFormat fmt;
    fmt.modulation.forme_onde = forme_onde_qpsk(filtre);
    fmt.modulation.fe = 4;
    fmt.modulation.fsymb = 1;
    fmt.modulation.sortie_reelle = non;
    fmt.entete = to_bs(hdr_bits);
    fmt.nbits = 512;
    ÉmetteurConfig ec;
    ec.format = fmt;
    soit em = émetteur_création(ec);
    std::vector<std::vector<uint8_t>> payloads;
    std::vector<int> gaps;
    for (int f = 0; f < 12; f++) {
      payloads.push_back(lcg_bits(7001u + f, 512));
      gaps.push_back(600 + 37 * f);
      save_u8(P(("g8_rxn_tx_f" + std::to_string(f) + ".npy").c_str()),
              payloads.back());
    }
    soit x = build_signal(em, payloads, gaps, 4000);
    soit y = impair(x, 0.35f, 0.8f, 0.4f);
    tsd::generateur_aleatoire.seed(0xC0FFEE);
    y = bruit_awgn(y, 0.35f);
    save_c64(P("g8_rxn_x.npy"), y);
    RécepteurConfig rc;
    rc.format = fmt;
    rc.seuil = 0.5f;
    run_rx(dir, "g8_rxn", rc, y);
  }

  // ----------------- D1/D2: stand-alone demodulator architectures
  {
    ModConfig mc;
    mc.forme_onde = forme_onde_qpsk(filtre);
    mc.fe = 4;
    mc.fsymb = 1;
    mc.sortie_reelle = non;
    soit mod = modulateur_création(mc);

    soit bits = lcg_bits(4001u, 2048);
    save_u8(P("g8_d_bits.npy"), bits);
    soit x = mod->step(to_bs(bits));
    soit x2 = mod->flush(0);
    Veccf xt(x.rows() + x2.rows());
    for (auto i = 0; i < x.rows(); i++) xt(i) = x(i);
    for (auto i = 0; i < x2.rows(); i++) xt(x.rows() + i) = x2(i);
    soit y = impair(xt, 0.3f, 1.3f, 0.25f);
    save_c64(P("g8_d_x.npy"), y);

    for (int archi = 0; archi < 2; archi++) {
      DemodConfig dc;
      dc.architecture = archi == 0 ? DemodConfig::ARCHI_AVEC_DECISION
                                   : DemodConfig::ARCHI_SANS_DECISION;
      soit dem = démodulateur_création(mc, dc);
      BitStream bs;
      Tabf llr;
      dem->step(y, bs, llr);
      std::vector<uint8_t> ob;
      for (auto i = 0; i < bs.lon(); i++) ob.push_back(bs[i] ? 1 : 0);
      std::string tag = archi == 0 ? "g8_d1" : "g8_d2";
      save_u8(P((tag + "_bits.npy").c_str()), ob);
      // LLR matrix flattened row-major (n_symbols x k)
      Vecf lf(llr.rows() * llr.cols());
      for (auto i = 0; i < llr.rows(); i++)
        for (auto j = 0; j < llr.cols(); j++)
          lf(i * llr.cols() + j) = llr(i, j);
      save_f32(P((tag + "_llr.npy").c_str()), lf);
    }
  }

  return 0;
}
