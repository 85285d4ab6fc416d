// C++-API parity harness (BASELINE.md config 5): the README filterFFT
// pipeline through dsc::tensor<T>, cross-checked against a direct
// time-domain convolution computed in C++.

#include <cmath>
#include <complex>
#include <cstdio>
#include <random>
#include <vector>

#include "../include/dsc_api.h"

static int failures = 0;

#define CHECK(cond, msg)                                       \
    do {                                                       \
        if (!(cond)) {                                         \
            std::printf("FAIL: %s\n", msg);                    \
            ++failures;                                        \
        }                                                      \
    } while (0)

int main() {
    dsc::init(1ull << 30);

    const int n = 4096;
    const int taps = 65;

    std::mt19937 rng(42);
    std::normal_distribution<float> dist(0.f, 1.f);
    std::vector<float> sig(n), ker(taps);
    for (auto &v : sig) v = dist(rng);
    for (int i = 0; i < taps; ++i)
        ker[i] = 0.42f - 0.5f * std::cos(2 * M_PI * i / (taps - 1)) +
                 0.08f * std::cos(4 * M_PI * i / (taps - 1));  // blackman

    // -- filterFFT via the dsc C++ API ------------------------------------
    const int out_len = n + taps - 1;
    int fft_n = 1;
    while (fft_n < out_len) fft_n <<= 1;

    dsc::tensor<float> s({n}, sig.data());
    dsc::tensor<float> k({taps}, ker.data());

    auto spec = dsc::rfft(s, fft_n) * dsc::rfft(k, fft_n);
    auto conv = dsc::irfft(spec);
    auto out = conv.get_slice({DSC_SLICE_TO(out_len)});

    CHECK(out.ndim() == 1 && out.dim(0) == out_len, "filterFFT output shape");
    std::vector<float> got = out.to_vector();

    // -- oracle: direct convolution ----------------------------------------
    std::vector<float> ref(out_len, 0.f);
    for (int i = 0; i < n; ++i)
        for (int j = 0; j < taps; ++j) ref[i + j] += sig[i] * ker[j];

    float max_err = 0.f, max_ref = 0.f;
    for (int i = 0; i < out_len; ++i) {
        max_err = std::max(max_err, std::fabs(got[i] - ref[i]));
        max_ref = std::max(max_ref, std::fabs(ref[i]));
    }
    std::printf("filterFFT rel err: %.3e\n", max_err / max_ref);
    CHECK(max_err / max_ref < 1e-4f, "filterFFT matches direct convolution");

    // -- op surface smoke through the same front door ----------------------
    auto a = dsc::arange<float>(8);
    auto b = a * 2.0f + 1.0f;
    auto bv = b.to_vector();
    CHECK(std::fabs(bv[3] - 7.0f) < 1e-6, "arange * 2 + 1");

    auto sq = dsc::sqrt(dsc::clip(a, 1.0, 4.0));
    CHECK(std::fabs(sq.to_vector()[7] - 2.0f) < 1e-6, "clip+sqrt");

    // in-place operators (reference dsc_api.h:148-189 incl. /=)
    auto ip = dsc::arange<float>(8);
    ip += 1.0f;
    ip *= 2.0f;
    ip /= 4.0f;
    ip -= 0.5f;
    CHECK(std::fabs(ip.to_vector()[3] - 1.5f) < 1e-6, "in-place scalar ops");
    auto ip2 = dsc::arange<float>(8);
    ip2 += ip2;
    CHECK(std::fabs(ip2.to_vector()[3] - 6.0f) < 1e-6, "in-place tensor add");

    auto total = dsc::sum(a, -1, false);
    CHECK(std::fabs(total.to_vector()[0] - 28.0f) < 1e-5, "sum");

    auto m = dsc::tensor<float>({2, 3});  // zeros
    m.set_slice({DSC_SLICE_IDX(1), DSC_SLICE_ALL},
                dsc::tensor<float>(std::vector<float>{5, 6, 7}, {3}));
    CHECK(std::fabs(m.get(1, 2) - 7.0f) < 1e-6, "set_slice/get");

    auto mt = dsc::transpose(m);
    CHECK(mt.dim(0) == 3 && mt.dim(1) == 2, "transpose shape");

    // complex round trip
    std::vector<std::complex<float>> cv = {{1, 2}, {3, -4}, {0, 1}, {2, 0}};
    dsc::tensor<std::complex<float>> c({4}, cv.data());
    auto cr = dsc::ifft(dsc::fft(c));
    auto crv = cr.to_vector();
    CHECK(std::abs(crv[1] - cv[1]) < 1e-5, "fft/ifft round trip");

    // window generators + 2-D fft (dsc_tpu extensions)
    auto w = dsc::kaiser<float>(65, 8.6);
    std::vector<float> wv = w.to_vector();
    CHECK(w.dim(0) == 65 && std::fabs(wv[32] - 1.0f) < 1e-6 &&
              wv[0] < 0.02f && std::fabs(wv[0] - wv[64]) < 1e-6,
          "kaiser window (peak 1 at center, symmetric)");
    auto bw = dsc::blackman<float>(taps);
    std::vector<float> bwv = bw.to_vector();
    float werr = 0.f;
    for (int i = 0; i < taps; ++i)
        werr = std::max(werr, std::fabs(bwv[i] - ker[i]));
    CHECK(werr < 1e-6f, "blackman matches the hand-rolled taps");

    std::vector<float> img(16 * 32);
    for (auto &v : img) v = dist(rng);
    dsc::tensor<float> im({16, 32}, img.data());
    auto z2 = dsc::rfft2(im);
    CHECK(z2.dim(0) == 16 && z2.dim(1) == 17, "rfft2 shape (n0, n1/2+1)");
    auto im2 = dsc::irfft2(z2);
    std::vector<float> imv = im2.to_vector();
    float e2 = 0.f;
    for (int i = 0; i < 16 * 32; ++i)
        e2 = std::max(e2, std::fabs(imv[i] - img[i]));
    CHECK(e2 < 1e-5f, "irfft2(rfft2) round trip");

    CHECK(dsc_used_mem() > 0, "used_mem accounting");

    if (failures == 0) {
        std::printf("C++ parity harness: ALL OK\n");
        return 0;
    }
    std::printf("C++ parity harness: %d failures\n", failures);
    return 1;
}
