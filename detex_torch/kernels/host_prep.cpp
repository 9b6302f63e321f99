// Host preparation of one engine chunk in one native call: linear detrend,
// the SOS band-pass (obspy-style zero phase: forward, then over the reversed
// signal, without padding) and the cast and layout the engine scans, over
// every channel of the chunk at once.
//
// The arithmetic is that of native/detex_host.cpp, step for step, so that
// the output has the same bits as detex_detrend_linear, detex_sosfilt and a
// numpy cast and interleave one after the other: each channel's detrend
// sums run in the same order, each sample and section computes
//   out = b0*v + z0; z0 = b1*v - a1*out + z1; z1 = b2*v - a2*out
// and the backward pass runs by descending index, which is what filtering
// the reversed signal and reversing back computes. What changes is the
// memory traffic and the parallelism: the input is read in its own type (no
// float64 copy), the channels' recursions run side by side, two channels to
// a two-lane vector (each lane one channel's scalar arithmetic), with
// coefficients and section states in locals; the forward pass lands in one
// float64 work buffer and the backward pass writes the output (float32 or
// float64; multiplexed, out[i * nc + c], or a channel stack,
// out[c * n + i]) directly.
//
// Built by detex_torch/host_prep.py with g++ and native.CXX_FLAGS (-O3
// -shared -fPIC): no flag that reorders or contracts the arithmetic.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr int kMaxChannels = 16;
constexpr int kMaxPairs = kMaxChannels / 2;
constexpr int kMaxSections = 16;

// two channels' float64 samples, one a lane
typedef double v2 __attribute__((vector_size(16)));

struct Line {
    double a;
    double b;
};

// the least-squares lines of detex_detrend_linear, the channels' sums side
// by side (each channel's in its own order); false for a NaN sum
template <typename T>
bool fit_lines(const T* const* x, int nc, int64_t n, Line* line) {
    const double nn = static_cast<double>(n);
    const double st = (nn - 1.0) * nn / 2.0;
    const double stt = (nn - 1.0) * nn * (2.0 * nn - 1.0) / 6.0;
    double sy[kMaxChannels], sty[kMaxChannels];
    for (int c = 0; c < nc; ++c) sy[c] = sty[c] = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double t = static_cast<double>(i);
        for (int c = 0; c < nc; ++c) {
            const double v = static_cast<double>(x[c][i]);
            sy[c] += v;
            sty[c] += v * t;
        }
    }
    const double det = nn * stt - st * st;
    for (int c = 0; c < nc; ++c) {
        if (std::isnan(sy[c])) return false;
        line[c].b = (nn * sty[c] - st * sy[c]) / det;
        line[c].a = (sy[c] - line[c].b * st) / nn;
    }
    return true;
}

template <typename O>
inline void store(O* out, int nc, int64_t n, int c, int64_t i, bool mux,
                  double v) {
    if (mux)
        out[i * nc + c] = static_cast<O>(v);
    else
        out[static_cast<int64_t>(c) * n + i] = static_cast<O>(v);
}

// detrend only: the detrended samples straight to the output
template <typename T, typename O>
void detrend_out(const T* const* x, const Line* line, int nc, int64_t n,
                 O* out, bool mux) {
    for (int c = 0; c < nc; ++c) {
        const T* xc = x[c];
        const double a = line[c].a, b = line[c].b;
        for (int64_t i = 0; i < n; ++i)
            store(out, nc, n, c, i, mux,
                  static_cast<double>(xc[i]) -
                      (a + b * static_cast<double>(i)));
    }
}

// The section coefficients and states of NP channel pairs (runtime np and
// nsec where NP or NSEC is 0), in locals, and one sample of one pair
// through every section.
template <int NP, int NSEC>
struct Sos {
    static constexpr int kP = NP ? NP : kMaxPairs;
    static constexpr int kS = NSEC ? NSEC : kMaxSections;
    const int np, ns;
    v2 c[6 * kS];
    v2 z0[kP * kS], z1[kP * kS];

    Sos(const double* sos, int np_rt, int nsec_rt)
        : np(NP ? NP : np_rt), ns(NSEC ? NSEC : nsec_rt) {
        for (int k = 0; k < 6 * ns; ++k) c[k] = v2{sos[k], sos[k]};
        for (int k = 0; k < np * ns; ++k) z0[k] = z1[k] = v2{0.0, 0.0};
    }

    inline v2 step(int p, v2 v) {
        v2* zp0 = z0 + p * ns;
        v2* zp1 = z1 + p * ns;
        for (int s = 0; s < ns; ++s) {
            const v2* cs = c + 6 * s;
            const v2 out = cs[0] * v + zp0[s];
            zp0[s] = cs[1] * v - cs[4] * out + zp1[s];
            zp1[s] = cs[2] * v - cs[5] * out;
            v = out;
        }
        return v;
    }
};

// detrend and the forward pass of every pair, side by side, into the work
// buffer w (a v2 a pair a sample); x and line hold 2 * np entries, the
// last channel twice over when nc is odd
template <int NP, int NSEC, typename T>
void forward(const T* const* x, const Line* line, int np, int64_t n,
             const double* sos, int nsec, v2* w) {
    Sos<NP, NSEC> f(sos, np, nsec);
    const int P = f.np;
    v2 a[Sos<NP, NSEC>::kP], b[Sos<NP, NSEC>::kP];
    for (int p = 0; p < P; ++p) {
        a[p] = v2{line[2 * p].a, line[2 * p + 1].a};
        b[p] = v2{line[2 * p].b, line[2 * p + 1].b};
    }
    for (int64_t i = 0; i < n; ++i) {
        const double t = static_cast<double>(i);
        const v2 tv = v2{t, t};
        for (int p = 0; p < P; ++p) {
            const v2 v = v2{static_cast<double>(x[2 * p][i]),
                            static_cast<double>(x[2 * p + 1][i])} -
                         (a[p] + b[p] * tv);
            w[i * P + p] = f.step(p, v);
        }
    }
}

template <typename O>
inline void store_pair(O* out, int nc, int64_t n, int p, int64_t i, bool mux,
                       v2 v) {
    store(out, nc, n, 2 * p, i, mux, v[0]);
    if (2 * p + 1 < nc) store(out, nc, n, 2 * p + 1, i, mux, v[1]);
}

// the backward pass over w by descending index, into the output
template <int NP, int NSEC, typename O>
void backward(const v2* w, int nc, int np, int64_t n, const double* sos,
              int nsec, O* out, bool mux) {
    Sos<NP, NSEC> f(sos, np, nsec);
    const int P = f.np;
    for (int64_t i = n - 1; i >= 0; --i)
        for (int p = 0; p < P; ++p)
            store_pair(out, nc, n, p, i, mux, f.step(p, w[i * P + p]));
}

// w to the output, for the one-pass filter
template <typename O>
void copy_out(const v2* w, int nc, int np, int64_t n, O* out, bool mux) {
    for (int64_t i = 0; i < n; ++i)
        for (int p = 0; p < np; ++p)
            store_pair(out, nc, n, p, i, mux, w[i * np + p]);
}

template <typename O>
void filter_out(const v2* w, int nc, int np, int64_t n, const double* sos,
                int nsec, int zerophase, O* out, bool mux) {
    if (!zerophase)
        copy_out(w, nc, np, n, out, mux);
    else if (nsec == 2 && np == 1)
        backward<1, 2>(w, nc, np, n, sos, nsec, out, mux);
    else if (nsec == 2 && np == 2)
        backward<2, 2>(w, nc, np, n, sos, nsec, out, mux);
    else
        backward<0, 0>(w, nc, np, n, sos, nsec, out, mux);
}

template <typename T>
int prep(const void* const* chans, int nc, int64_t n, const double* sos,
         int nsec, int zerophase, void* out, int out_f32, bool mux) {
    const T* x[kMaxChannels];
    Line line[kMaxChannels];
    for (int c = 0; c < nc; ++c) x[c] = static_cast<const T*>(chans[c]);
    if (!fit_lines(x, nc, n, line)) return 1;
    if (nsec == 0) {
        if (out_f32)
            detrend_out(x, line, nc, n, static_cast<float*>(out), mux);
        else
            detrend_out(x, line, nc, n, static_cast<double*>(out), mux);
        return 0;
    }
    const int np = (nc + 1) / 2;
    if (nc & 1) {
        x[nc] = x[nc - 1];
        line[nc] = line[nc - 1];
    }
    static thread_local std::vector<v2> work;
    if (work.size() < static_cast<size_t>(np * n)) work.resize(np * n);
    v2* w = work.data();
    // one or two pairs (one to four channels) and two sections (the
    // band-pass of two corners) unrolled; any other shape in loops
    if (nsec == 2 && np == 1)
        forward<1, 2>(x, line, np, n, sos, nsec, w);
    else if (nsec == 2 && np == 2)
        forward<2, 2>(x, line, np, n, sos, nsec, w);
    else
        forward<0, 0>(x, line, np, n, sos, nsec, w);
    if (out_f32)
        filter_out(w, nc, np, n, sos, nsec, zerophase,
                   static_cast<float*>(out), mux);
    else
        filter_out(w, nc, np, n, sos, nsec, zerophase,
                   static_cast<double*>(out), mux);
    return 0;
}

}  // namespace

extern "C" {

// Input types of detex_host_prep's channels.
enum { PREP_INT32 = 0, PREP_INT64 = 1, PREP_FLOAT32 = 2, PREP_FLOAT64 = 3 };

// Detrend, band-pass (nsec sections of sos [nsec][6] = b0 b1 b2 a0 a1 a2,
// a0 == 1; nsec 0 for none) and write one chunk of nc channels of n
// samples each (chans[c], all of type in_type) to out: float32 when
// out_f32, else float64; multiplexed when mux, else a [nc, n] stack.
// Returns 0, 1 when a channel holds NaN (nothing of it is usable: the
// caller takes its general path), -1 for arguments out of range.
int detex_host_prep(const void* const* chans, int in_type, int nc, int64_t n,
                    const double* sos, int nsec, int zerophase, void* out,
                    int out_f32, int mux) {
    if (nc < 1 || nc > kMaxChannels || n < 2 || nsec < 0 ||
        nsec > kMaxSections)
        return -1;
    switch (in_type) {
        case PREP_INT32:
            return prep<int32_t>(chans, nc, n, sos, nsec, zerophase, out,
                                 out_f32, mux != 0);
        case PREP_INT64:
            return prep<int64_t>(chans, nc, n, sos, nsec, zerophase, out,
                                 out_f32, mux != 0);
        case PREP_FLOAT32:
            return prep<float>(chans, nc, n, sos, nsec, zerophase, out,
                               out_f32, mux != 0);
        case PREP_FLOAT64:
            return prep<double>(chans, nc, n, sos, nsec, zerophase, out,
                                out_f32, mux != 0);
        default:
            return -1;
    }
}

int detex_host_prep_abi_version() { return 1; }

}  // extern "C"
