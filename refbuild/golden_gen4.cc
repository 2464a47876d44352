// Golden-output generator #4: widens the reference-binary numerical diff
// to the last untested composites: the broadcast FM
// demodulation chain (mono path), adaptive equalizer trajectories
// (FFE/DFE x DEC/CMA), the dispersive (Rayleigh/Rice) channel process,
// the real-time spectrum sweep composite, and the MDL auto source-count
// branch of subspace_spectrum.
//
// All inputs are deterministic; the dispersive channel seeds the global
// RNG so its golden is bit-reproducible (the comparison on our side is
// STATISTICAL — the noise streams differ by construction).
// Compared in tests/test_golden_ref4.py.
//
// REFERENCE DEFECTS found while generating (verified on the binary):
//  * FMDemod (analogique.cc:381-658) stereo path: the pilot RPLL is
//    configured from an UNINITIALIZED RPLLConfig::freq (telecom.hpp:1682
//    has no default member initializer; analogique.cc:497-500 sets only
//    pll_interne.*) — UB, so FMDemod::step cannot be golden-diffed end
//    to end.  The mono chain below reproduces FMDemod's own
//    sub-component calls exactly, which IS deterministic.
//  * subspace_spectrum's MDL auto branch (stats.cc:148-187) mis-expands
//    Williams' criterion and takes index_max of it (MDL selects a
//    minimum); g4_mdl_ns pins what the binary actually selects.
#include "tsd/tsd-all.hpp"
#include "tsd/telecom.hpp"
#include "tsd/stats.hpp"
#include <cstdio>
#include <cstdint>
#include <string>
#include <vector>
#include <complex>

using namespace tsd;
using namespace tsd::filtrage;
using namespace tsd::fourier;
using namespace tsd::telecom;

// REFERENCE DEFECT: Tab::operator+=(cfloat) is declared
// (tableau.hpp:228, DEC_OP(cfloat)) but never defined — tableau.cc:1392+
// instantiates the complex scalar ops only in their non-compound form
// and the compound ones only for entier/float/double.  Consequence:
// CanalDispersif's RICE branch (simulation.cc:81 `b += sqrt(config.K)`)
// does not LINK against the shipped library (undefined reference), so
// the Rice channel is unusable as shipped.  Define the operator here,
// via the existing operator+, so the Rice golden can be generated.
namespace tsd {
Tab &Tab::operator +=(const cfloat &x) { *this = *this + x; return *this; }
}

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
  if (!f) {
    fprintf(stderr, "cannot open %s for writing\n", path.c_str());
    exit(1);
  }
  npy_write_header(f, "<f4", x.rows());
  for (auto i = 0; i < x.rows(); i++) {
    float v = x(i);
    fwrite(&v, 4, 1, f);
  }
  fclose(f);
  printf("wrote %s (%d f32)\n", path.c_str(), x.rows());
}

static void save_f32v(const std::string &path, const std::vector<float> &x)
{
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) {
    fprintf(stderr, "cannot open %s for writing\n", path.c_str());
    exit(1);
  }
  npy_write_header(f, "<f4", x.size());
  fwrite(x.data(), 4, x.size(), f);
  fclose(f);
  printf("wrote %s (%zu f32)\n", path.c_str(), x.size());
}

static void save_c64(const std::string &path, const Veccf &x)
{
  FILE *f = fopen(path.c_str(), "wb");
  if (!f) {
    fprintf(stderr, "cannot open %s for writing\n", path.c_str());
    exit(1);
  }
  npy_write_header(f, "<c8", x.rows());
  for (auto i = 0; i < x.rows(); i++) {
    std::complex<float> v = x(i);
    fwrite(&v, 8, 1, f);
  }
  fclose(f);
  printf("wrote %s (%d c8)\n", path.c_str(), x.rows());
}

int main(int argc, char **argv)
{
  std::string dir = argc > 1 ? argv[1] : ".";
  auto P = [&](const char *name) { return dir + "/" + name; };

  // keep any debug figures out of the golden directory
  tsd::vue::stdo.def_dossier_sortie("/tmp/g4figs");

  // ---- Broadcast FM mono chain (FMDemod's deterministic sub-chain,
  // analogique.cc:460-478, 515-527, 583): wideband RC FIR -> polar
  // discriminator (/75 kHz) -> 65 kHz lowpass -> sousech(R) -> 15 kHz
  // audio lowpass.  fe = 600 kHz => R = floor(600/130) = 4.
  {
    float fe = 600e3f;
    soit n = 16384;
    // stereo multiplex: L/R tones, 19 kHz pilot, 38 kHz DSB subcarrier
    soit L = sigcos(1000.0f / fe, n) * 0.8f,
         R = sigcos(2500.0f / fe, n) * 0.6f;
    soit m = 0.5f * (L + R) + 0.1f * sigcos(19000.0f / fe, n)
           + 0.5f * (L - R) * sigcos(38000.0f / fe, n);
    // FM: phase = 2 pi (75e3/fe) cumsum(m)
    soit ph = cumsum(m) * (2 * π_f * 75000.0f / fe);
    Veccf x(n);
    pour (auto i = 0; i < n; i++)
      x(i) = std::polar(1.0f, ph(i));
    save_c64(P("g4_fm_x.npy"), x);

    soit h_wb = design_rif_cs(255, 0.2, 100e3f / fe);
    soit rif_wb = filtre_rif<float, cfloat>(h_wb);
    soit y1 = rif_wb->step(x);
    soit discri = discriminateur_fm();
    soit a = discri->step(y1);
    a /= 75e3f;
    soit h_fm = design_rif_cs(255, 0.1, 65e3f / fe);
    soit rif_fm = filtre_rif<float, float>(h_fm);
    soit a2 = rif_fm->step(a);
    entier R2 = (entier) floor(fe / (65e3f * 2));
    soit a3 = sousech(a2, R2);
    float fech2 = fe / R2;
    soit h_au = design_rif_cs(255, 0.1, 15e3f / fech2);
    soit rif_au = filtre_rif<float, float>(h_au);
    soit lpr = rif_au->step(a3);
    save_f32(P("g4_fm_a3.npy"), a3);
    save_f32(P("g4_fm_lpr.npy"), lpr);
  }

  // ---- Adaptive equalizer trajectories (egalisation.cc:29-178):
  // deterministic QPSK symbols through a 3-tap channel, FFE/DEC,
  // FFE/CMA and DFE/DEC runs; the full output trajectory is the golden
  // (it pins the update equations, gains and the REAL-tap structure).
  {
    soit fo = forme_onde_qpsk();
    soit n = 2000;
    Veccf s(n);
    pour (auto i = 0; i < n; i++)
      s(i) = fo->lis_symbole((unsigned int) ((i * 7919 + i / 7) % 4));
    soit h = Vecf::valeurs({1.0f, 0.4f, -0.2f});
    soit canal = filtre_rif<float, cfloat>(h);
    soit xs = canal->step(s);
    save_c64(P("g4_eq_x.npy"), xs);

    soit eq1 = égaliseur_rif_création(fo, "FFE", "DEC", 1, 0.01f, 11, 11);
    save_c64(P("g4_eq_ffe_dec.npy"), eq1->step(xs));
    soit eq2 = égaliseur_rif_création(fo, "FFE", "CMA", 1, 0.002f, 11, 11);
    save_c64(P("g4_eq_ffe_cma.npy"), eq2->step(xs));
    soit eq3 = égaliseur_rif_création(fo, "DFE", "DEC", 1, 0.01f, 11, 7);
    save_c64(P("g4_eq_dfe_dec.npy"), eq3->step(xs));
  }

  // ---- Dispersive channel (simulation.cc:44-140): seeded global RNG,
  // constant input => the output IS the fading process.  Our side
  // compares STATISTICS (power, envelope law, Doppler bandwidth).
  //
  // canal_dispersif() itself cannot run in this headless build: its
  // constructor UNCONDITIONALLY renders debug figures
  // (plot_filtre(hd).afficher(), simulation.cc:65) which segfaults with
  // the FreeType-stubbed vue stack — a design wart (a simulation
  // component hard-wired to the plotting backend).  The block below
  // replays CanalDispersif::step's exact math and RNG stream through
  // the same reference calls, minus the plot.
  {
    soit fd = 50.0f, fe = 10000.0f;
    soit n = 40000;
    // doppler_filtre (simulation.cc:31-41)
    soit ntaps = 512;
    soit fgrid = linspace(0, 2 * fd, ntaps / 2).as<double>();
    soit Sd = doppler_distri(fgrid, fd, 0);
    soit hd = tsd::filtrage::design_rif_freq(ntaps, Sd);
    hd /= hd.somme();
    soit fs2 = 4 * fd;

    auto run = [&](bouléen rice, float K, unsigned seed) {
      tsd::generateur_aleatoire.seed(seed);
      soit rif     = filtre_rif<float, cfloat>(hd);
      soit reechan = filtre_reechan<cfloat>(fe / fs2);
      auto gen_bruit = [&](entier nn) {
        // the reference's CanalDispersif uses its FILE-LOCAL randnc
        // (simulation.cc:14-20): all n real parts drawn first, then all
        // n imaginary parts, each scaled 1/sqrt(2) (unit TOTAL
        // variance).  The public randcn draws interleaved unit-variance
        // pairs — different stream AND 2x the power, which halved the
        // effective Rice K in the originally committed golden.
        Veccf b(nn);
        b.set_real(randn(nn) / sqrt(2.0f));
        b.set_imag(randn(nn) / sqrt(2.0f));
        si (rice) {
          b += cfloat(sqrt(K), 0.0f);
          b /= sqrt(square(b).moyenne());
        }
        retourne b;
      };
      // premier_appel warmup (simulation.cc:100-104)
      reechan->step(rif->step(gen_bruit(hd.rows())));
      soit m = (entier) ceil((n + 1) * fs2 / fe);
      soit x2 = reechan->step(rif->step(gen_bruit(m)));
      Veccf y(n);
      pour (auto i = 0; i < n; i++)
        y(i) = x2(i);               // input = ones
      retourne y;
    };
    save_c64(P("g4_disp_y.npy"), run(non, 0.0f, 42));
    save_c64(P("g4_disp_rice_y.npy"), run(oui, 4.0f, 43));
  }

  // ---- Real-time spectrum sweep composite (fourier.cc:1150-1337):
  // nsubs captures per block, per-capture masking, composite span.
  {
    SpectrumConfig cfg;
    cfg.BS     = 4 * 256;
    cfg.nsubs  = 4;
    cfg.nmeans = 2;
    cfg.sweep.active    = oui;
    cfg.sweep.step      = 128;
    cfg.sweep.masque_hf = 8;
    cfg.sweep.masque_bf = 4;
    soit sp = rt_spectrum(cfg);
    soit Nf = cfg.Nf();
    soit n = cfg.BS;
    // two deterministic blocks (nmeans = 2): tones at different
    // per-capture frequencies + a ramp so every capture differs
    Veccf x1(n), x2(n);
    pour (auto i = 0; i < n; i++) {
      float t = (float) i;
      x1(i) = std::polar(1.0f, 2 * π_f * 0.11f * t)
            + std::polar(0.5f, 2 * π_f * 0.27f * t);
      x2(i) = std::polar(1.0f, 2 * π_f * 0.11f * t)
            + std::polar(0.25f, -2 * π_f * 0.05f * t);
    }
    save_c64(P("g4_spec_x1.npy"), x1);
    save_c64(P("g4_spec_x2.npy"), x2);
    soit y0 = sp->step(x1);       // empty (nmeans not reached)
    soit y  = sp->step(x2);       // composite spectrum, dB
    save_f32v(P("g4_spec_sizes.npy"),
              {(float) Nf, (float) cfg.Ns(), (float) y0.rows()});
    save_f32(P("g4_spec_y.npy"), y);
  }

  // ---- MDL auto source count (stats.cc:148-187, Ns = -1 branch):
  // two tones + deterministic broadband chirp "noise"; pins the
  // binary's actual selection and the spectrum it then computes.
  {
    soit n = 1024, m = 8;
    soit x = sigexp(0.1f, n) + sigexp(0.27f, n) * 0.7f
           + sigchirp(-0.45f, 0.45f, n, 'l') * 0.05f;
    soit R = tsd::stats::covmtx(x, m);
    tsd::stats::SubSpaceSpectrumConfig cfg;
    cfg.Ns = -1;
    cfg.Nf = 256;
    soit r = tsd::stats::subspace_spectrum(R, cfg);
    Veccf Rf(m * m);
    pour (auto i = 0; i < m; i++)
      pour (auto j = 0; j < m; j++)
        Rf(i * m + j) = R(i, j);
    save_c64(P("g4_mdl_R.npy"), Rf);
    save_f32v(P("g4_mdl_ns.npy"), {(float) r.Ns});
    save_f32(P("g4_mdl_spectrum.npy"), r.spectrum);
  }

  printf("golden_gen4 done\n");
  retourne 0;
}
