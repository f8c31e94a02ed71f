// Host half of the low-link LL-domain transport (pipeline/lowlink.py).
//
// The flagship codec reads only the LL band of one YUV channel and writes
// only a delta to that band, so the transport moves LL data over the link
// instead of frames.  These functions are the host's share of that work:
//
//   vfpio_host_ll      u8 BGR frames -> f16 LL band of one channel
//   vfpio_reconstruct  frames + int8 LL delta -> marked u8 frames
//   vfpio_qim_dll      f16 LL -> int8 QIM LL delta per bit plane (host wire)
//   vfpio_qim_bits     f16 LL -> decoded QIM bits (host wire)
//   vfpio_qim_repair   exact-triplet delta of flagged blocks (u8 wire)
//   vfpio_recentre2    u8-wire delta rescale onto the true LL's QIM centre
//
// Each has a NumPy twin in native/lowlink.py.  Built with its own flags
// (native/build.py): -ffp-contract=off keeps the float association of the
// source order, and on x86 -mf16c gives _Float16 its hardware conversions.
// Every loop is single-threaded; ctypes releases the GIL around each call.

#include <algorithm>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

// ops/soa._V0 ([1, 0.93, 1.08, 1.02] normalized), the same f32 values
const float kV0[4] = {0.4955781102180481f, 0.4608876407146454f,
                      0.5352243781089783f, 0.5054896473884583f};

// Dominant triplet of one 4x4 block x (row-major): returns s0, fills u[4]
// and v[4].  Gram matrix, 5 Frobenius-normalized squarings (the squaring
// count of ops/soa.top_triplet_soa), v = normalize(G v0), u = x v / s0.
inline float triplet4(const float x[16], float* u, float* v) {
    const float eps = 1e-20f;
    float g[16], h[16];
    for (int a = 0; a < 4; ++a)
        for (int b = a; b < 4; ++b) {
            float s = x[0 * 4 + a] * x[0 * 4 + b];
            for (int r = 1; r < 4; ++r) s += x[r * 4 + a] * x[r * 4 + b];
            g[a * 4 + b] = s;
            g[b * 4 + a] = s;
        }
    for (int it = 0; it < 5; ++it) {
        float n2 = 0.f;
        for (int i = 0; i < 16; ++i) n2 += g[i] * g[i];
        float inv = 1.0f / std::max(std::sqrt(n2), eps);
        for (int i = 0; i < 16; ++i) g[i] *= inv;
        for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) {
                float s = g[i * 4 + 0] * g[0 * 4 + j];
                for (int k2 = 1; k2 < 4; ++k2) s += g[i * 4 + k2] * g[k2 * 4 + j];
                h[i * 4 + j] = s;
            }
        std::memcpy(g, h, sizeof(g));
    }
    float vn2 = 0.f;
    for (int i = 0; i < 4; ++i) {
        float s = 0.f;
        for (int j = 0; j < 4; ++j) s += g[i * 4 + j] * kV0[j];
        v[i] = s;
        vn2 += s * s;
    }
    float vn = std::sqrt(vn2);
    if (vn > eps) {
        for (int i = 0; i < 4; ++i) v[i] /= vn;
    } else {
        for (int i = 0; i < 4; ++i) v[i] = kV0[i];
    }
    float s0sq = 0.f;
    for (int r = 0; r < 4; ++r) {
        float s = 0.f;
        for (int c = 0; c < 4; ++c) s += x[r * 4 + c] * v[c];
        u[r] = s;
        s0sq += s * s;
    }
    float s0 = std::sqrt(s0sq);
    if (s0 > eps) {
        for (int r = 0; r < 4; ++r) u[r] /= s0;
    } else {
        u[0] = 1.f;
        u[1] = u[2] = u[3] = 0.f;
    }
    return s0;
}

// Block (bi, bj) of one frame's f16 LL [hc, wc] as f32, row-major.
inline void load_block(const _Float16* lf, long wc, long bi, long bj, float x[16]) {
    for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c)
            x[r * 4 + c] = (float)lf[(bi * 4 + r) * wc + bj * 4 + c];
}

// o[r * wc + c] = clip(rint(ds * u[r] * v[c] * 8), -127, 127): the rank-1
// delta in int8 fixed point (DLL_Q = 8); nearbyint under the default FP
// environment rounds half to even, as np.rint does.
inline void write_delta(signed char* o, long wc, float ds, const float* u,
                        const float* v) {
    for (int r = 0; r < 4; ++r)
        for (int c = 0; c < 4; ++c) {
            float q = std::nearbyint(ds * u[r] * v[c] * 8.0f);
            q = q < -127.f ? -127.f : (q > 127.f ? 127.f : q);
            o[r * wc + c] = (signed char)q;
        }
}

}  // namespace

extern "C" {

// Marked frames from the int8 LL delta: out = clip(src + lut_c[dll + 128])
// over the [2*hc, 2*wc] region (each LL entry covers a 2x2 pixel quad);
// channels with a null LUT, and pixels outside the region, are copied.
// The per-channel delta row is built once per row pair, so the hot loop is
// a contiguous saturating add.
void vfpio_reconstruct(const unsigned char* src, const signed char* dll,
                       const short* lut_b, const short* lut_g,
                       const short* lut_r, unsigned char* out,
                       long k, long h, long w, long hc, long wc) {
    const long w2 = 2 * wc, h2 = 2 * hc;
    const long row_bytes = w * 3;
    const long n = w2 * 3;
    std::vector<short> drow(n, 0);  // null-LUT channels stay 0
    const short* luts[3] = {lut_b, lut_g, lut_r};
    for (long f = 0; f < k; ++f) {
        const unsigned char* s = src + f * h * row_bytes;
        unsigned char* o = out + f * h * row_bytes;
        const signed char* d = dll + f * hc * wc;
        for (long y = 0; y < h; ++y) {
            const unsigned char* sr = s + y * row_bytes;
            unsigned char* orow = o + y * row_bytes;
            if (y >= h2) {
                std::memcpy(orow, sr, row_bytes);
                continue;
            }
            if ((y & 1) == 0) {
                const signed char* dr = d + (y >> 1) * wc;
                for (int c = 0; c < 3; ++c) {
                    const short* lut = luts[c];
                    if (!lut) continue;
                    for (long x = 0; x < wc; ++x) {
                        short v = lut[(int)dr[x] + 128];
                        drow[(2 * x) * 3 + c] = v;
                        drow[(2 * x + 1) * 3 + c] = v;
                    }
                }
            }
            for (long i = 0; i < n; ++i) {
                int v = (int)sr[i] + (int)drow[i];
                orow[i] = (unsigned char)(v < 0 ? 0 : (v > 255 ? 255 : v));
            }
            if (w2 < w) std::memcpy(orow + n, sr + n, (w - w2) * 3);
        }
    }
}

// u8 BGR frames [k, h, w, 3] -> f16 LL [k, h4/2, w4/2] of one YUV channel:
//   c  = ((m0*B + m1*G) + m2*R) + off        per pixel, f32
//   ll = (((c00 + c01) + c10) + c11) * 0.5   per 2x2 quad (Haar LL)
// reading each u8 row pair once.  f32 -> f16 rounds to nearest even.
void vfpio_host_ll(const unsigned char* src, _Float16* out,
                   long k, long h, long w, long h4, long w4,
                   float m0, float m1, float m2, float off) {
    const long hc = h4 / 2, wc = w4 / 2;
    const long row_bytes = w * 3;
    std::vector<float> c0(w4), c1(w4);
    for (long f = 0; f < k; ++f) {
        const unsigned char* base = src + f * h * row_bytes;
        _Float16* ofr = out + f * hc * wc;
        for (long y = 0; y < hc; ++y) {
            const unsigned char* r0 = base + (2 * y) * row_bytes;
            const unsigned char* r1 = r0 + row_bytes;
            for (long x = 0; x < w4; ++x) {
                c0[x] = m0 * r0[3 * x] + m1 * r0[3 * x + 1] + m2 * r0[3 * x + 2] + off;
                c1[x] = m0 * r1[3 * x] + m1 * r1[3 * x + 1] + m2 * r1[3 * x + 2] + off;
            }
            _Float16* orow = ofr + y * wc;
            for (long x = 0; x < wc; ++x) {
                float s = ((c0[2 * x] + c0[2 * x + 1]) + c1[2 * x]) + c1[2 * x + 1];
                orow[x] = (_Float16)(s * 0.5f);
            }
        }
    }
}

// f16 LL [k, hc, wc] + per-plane block bits [P, nbh*nbw] (u8 0/1, blocks
// row-major) -> int8 QIM LL delta [P, k, hc, wc]: per 4x4 block the target
// s0' = (floor(s0 / scale) + 0.25 + 0.5 * bit) * scale, delta
// (s0' - s0) u v^T.  Entries outside the block grid are 0.
void vfpio_qim_dll(const _Float16* ll, const unsigned char* bits,
                   signed char* out, long P, long k, long hc, long wc,
                   float scale) {
    const long nbh = hc / 4, nbw = wc / 4, nb = nbh * nbw;
    std::memset(out, 0, (size_t)(P * k * hc * wc));
    for (long f = 0; f < k; ++f) {
        const _Float16* lf = ll + f * hc * wc;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                float x[16], u[4], v[4];
                load_block(lf, wc, bi, bj, x);
                float s0 = triplet4(x, u, v);
                float cell = std::floor(s0 / scale);
                for (long p = 0; p < P; ++p) {
                    float bit = (float)bits[p * nb + bi * nbw + bj];
                    float ds = (cell + 0.25f + 0.5f * bit) * scale - s0;
                    write_delta(out + ((p * k + f) * hc + bi * 4) * wc + bj * 4, wc, ds,
                                u, v);
                }
            }
    }
}

// Exact-triplet repair for the u8-wire recentring: for each block flagged
// in mask [P, k, nbh, nbw], the QIM delta recomputed from the true f16 LL
// overwrites that block of out [P, k, hc, wc].  The triplet is solved once
// per frame block and shared by the flagged planes.
void vfpio_qim_repair(const _Float16* ll, const unsigned char* mask,
                      const unsigned char* bits, signed char* out,
                      long P, long k, long hc, long wc, float scale) {
    const long nbh = hc / 4, nbw = wc / 4, nb = nbh * nbw;
    for (long f = 0; f < k; ++f) {
        const _Float16* lf = ll + f * hc * wc;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                bool any = false;
                for (long p = 0; p < P && !any; ++p)
                    any = mask[((p * k + f) * nbh + bi) * nbw + bj] != 0;
                if (!any) continue;
                float x[16], u[4], v[4];
                load_block(lf, wc, bi, bj, x);
                const float s0 = triplet4(x, u, v);
                const float base = std::floor(s0 / scale) + 0.25f;
                for (long p = 0; p < P; ++p) {
                    if (!mask[((p * k + f) * nbh + bi) * nbw + bj]) continue;
                    const float bit = (float)bits[p * nb + bi * nbw + bj];
                    const float ds = (base + 0.5f * bit) * scale - s0;
                    write_delta(out + ((p * k + f) * hc + bi * 4) * wc + bj * 4, wc, ds,
                                u, v);
                }
            }
    }
}

// f16 LL [k, hc, wc] -> decoded bits u8 [k, nbh*nbw] (blocks row-major):
// bit = (s0 mod scale) > scale / 2.
void vfpio_qim_bits(const _Float16* ll, unsigned char* out,
                    long k, long hc, long wc, float scale) {
    const long nbh = hc / 4, nbw = wc / 4;
    for (long f = 0; f < k; ++f) {
        const _Float16* lf = ll + f * hc * wc;
        unsigned char* of = out + f * nbh * nbw;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                float x[16], u[4], v[4];
                load_block(lf, wc, bi, bj, x);
                float s0 = triplet4(x, u, v);
                float m = std::fmod(s0, scale);
                of[bi * nbw + bj] = (unsigned char)(m > scale * 0.5f);
            }
    }
}

// u8-wire recentring: for each blk x blk block of the int8 wire delta q
// (fixed point x qscale), num = <q, E>, den = ||q||^2, and the block is
// rescaled by alpha = 1 - qscale * num / den, which moves the marked s0
// from the quantized LL's QIM centre onto the true LL's (E = true LL minus
// the device's wire-decoded LL; pipeline/lowlink.py derives it).  Blocks
// whose delta is below the direction floor (den / qscale^2 < du_min^2), or
// whose true content X fails the direction gate AC(X) < gamma2 * AC(E)
// (the device's singular direction is then the dither pattern's), keep
// their input values and are flagged in small_mask [P, k, nbh, nbw] for the
// caller's exact-triplet repair.  out enters as a copy of q; rows and
// columns past the block grid are not touched.
void vfpio_recentre2(const signed char* q, const float* E, const float* X,
                     signed char* out, unsigned char* small_mask, long P,
                     long k, long hc, long wc, long blk, float qscale,
                     float du_min, float gamma2) {
    const long nbh = hc / blk, nbw = wc / blk;
    const float den_floor = du_min * du_min * qscale * qscale;
    const float inv_n = 1.0f / (float)(blk * blk);
    for (long f = 0; f < k; ++f) {
        const float* Ef = E + f * hc * wc;
        const float* Xf = X ? X + f * hc * wc : nullptr;
        for (long bi = 0; bi < nbh; ++bi)
            for (long bj = 0; bj < nbw; ++bj) {
                const long r0 = bi * blk, c0 = bj * blk;
                // the direction gate does not depend on the plane
                bool flat = false;
                if (Xf) {
                    float sx = 0.f, sx2 = 0.f, se = 0.f, se2 = 0.f;
                    for (long r = 0; r < blk; ++r) {
                        const float* xr = Xf + (r0 + r) * wc + c0;
                        const float* er = Ef + (r0 + r) * wc + c0;
                        for (long c = 0; c < blk; ++c) {
                            sx += xr[c];
                            sx2 += xr[c] * xr[c];
                            se += er[c];
                            se2 += er[c] * er[c];
                        }
                    }
                    flat = (sx2 - sx * sx * inv_n)
                           < gamma2 * (se2 - se * se * inv_n);
                }
                for (long p = 0; p < P; ++p) {
                    const signed char* qf = q + (p * k + f) * hc * wc;
                    signed char* of = out + (p * k + f) * hc * wc;
                    unsigned char* sm = small_mask + (p * k + f) * nbh * nbw;
                    if (flat) {
                        sm[bi * nbw + bj] = 1;
                        continue;
                    }
                    float num = 0.f, den = 0.f;
                    for (long r = 0; r < blk; ++r) {
                        const signed char* qr = qf + (r0 + r) * wc + c0;
                        const float* er = Ef + (r0 + r) * wc + c0;
                        for (long c = 0; c < blk; ++c) {
                            const float v = (float)qr[c];
                            num += v * er[c];
                            den += v * v;
                        }
                    }
                    if (den < den_floor) {
                        sm[bi * nbw + bj] = 1;
                        continue;
                    }
                    const float alpha = 1.0f - qscale * num / den;
                    for (long r = 0; r < blk; ++r) {
                        const signed char* qr = qf + (r0 + r) * wc + c0;
                        signed char* orow = of + (r0 + r) * wc + c0;
                        for (long c = 0; c < blk; ++c) {
                            float w = std::nearbyint((float)qr[c] * alpha);
                            w = w < -127.f ? -127.f : (w > 127.f ? 127.f : w);
                            orow[c] = (signed char)w;
                        }
                    }
                }
            }
    }
}

}  // extern "C"
