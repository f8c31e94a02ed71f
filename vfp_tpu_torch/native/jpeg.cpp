// jpeg: baseline JPEG for vfp_tpu_torch's MJPEG-AVI files, equal to
// libjpeg-turbo under OpenCV's defaults (cv2.imencode('.jpg', ...,
// [IMWRITE_JPEG_QUALITY, q]) and cv2.imdecode(..., IMREAD_COLOR)).
//
// Encoder: baseline sequential, 8-bit, three components, 4:2:0 (Y 2x2,
// Cb/Cr 1x1), or one (grayscale, as cv2 writes an [H, W] image), the standard Annex K Huffman tables, no optimisation, no
// restart markers; markers SOI, APP0 JFIF 1.01, DQT x2, SOF0, DHT x4, SOS,
// EOI.  Each stage follows the libjpeg-turbo source file named at it:
// jcparam.c (quality scaling, baseline-clamped tables), jccolor.c (16-bit
// fixed-point RGB->YCbCr), jcsample.c / jcprepct.c (h2v2 downsampling with
// the 1,2 bias; right and bottom edges replicated), jccoefct.c (dummy blocks
// at the last MCU column and row), jfdctint.c (islow FDCT), jcdctmgr.c (the
// reciprocal quantiser), jchuff.c (entropy coding, 0xFF00 stuffing,
// 1-padding).
//
// Decoder: baseline (SOF0) and extended-sequential Huffman (SOF1) 8-bit
// files of three components in one interleaved scan, 4:2:0 or 4:4:4, the
// file's Huffman tables or the standard ones where it has none (the AVI1
// MJPEG convention), restart markers honoured; jidctint.c (islow IDCT and
// its range limit), jdsample.c (h2v2 fancy upsampling, box upsampling where
// the chroma is 2 or fewer samples wide), jdcolor.c (YCbCr->RGB tables).
// Everything else is refused with a message naming it.
//
// C ABI (ctypes-friendly, thread-safe, frames are RGB in file byte order):
//   long vfpjpeg_encode_bound(int width, int height)
//   long vfpjpeg_encode(const unsigned char* rgb, int width, int height,
//                       int quality, unsigned char* out, long cap)
//        -> bytes written, or -1 on bad arguments / too small a buffer
//   long vfpjpeg_encode_gray(const unsigned char* gray, int width, int height,
//                            int quality, unsigned char* out, long cap)
//        -> the same, for one component (a grayscale JPEG; the bound above holds)
//   int  vfpjpeg_decode_header(const unsigned char* data, long len,
//                              int* width, int* height, char* err, int errlen)
//   int  vfpjpeg_decode(const unsigned char* data, long len, unsigned char* rgb,
//                       int width, int height, char* err, int errlen)
//        -> 0, or 1 with a message in err
//   int  vfpjpeg_decode_gray(const unsigned char* data, long len, unsigned char* gray,
//                            int width, int height, char* err, int errlen)
//        -> the same, writing the Y component alone ([H, W]): what libjpeg gives
//           for JCS_GRAYSCALE output of a YCbCr file (jdcolor.c grayscale_convert),
//           as cv2.imread(..., IMREAD_GRAYSCALE) reads a JPEG

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

// zig-zag index -> natural index, with 16 extra entries for corrupt runs
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jcparam.c: the Annex K tables in natural order
const int kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// jstdhuff.c: code counts for lengths 1..16, then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
    0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
    0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
    0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56,
    0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
    0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba,
    0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6,
    0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jfdctint.c / jidctint.c constants: CONST_BITS 13, PASS1_BITS 2
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// ---------------------------------------------------------------------------
// encoder

// jccolor.c rgb_ycc_start: SCALEBITS 16, the B->Cb and R->Cr entries with
// ONE_HALF - 1 so the largest output rounds to 255
struct ColorTables {
    int32_t t[8 * 256];
    ColorTables() {
        const int32_t one_half = 1 << 15, cbcr_offset = 128 << 16;
        auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
        for (int i = 0; i < 256; i++) {
            t[i] = fix(0.29900) * i;
            t[i + 256] = fix(0.58700) * i;
            t[i + 512] = fix(0.11400) * i + one_half;
            t[i + 768] = -fix(0.16874) * i;
            t[i + 1024] = -fix(0.33126) * i;
            t[i + 1280] = fix(0.50000) * i + cbcr_offset + one_half - 1;  // B->Cb, R->Cr
            t[i + 1536] = -fix(0.41869) * i;
            t[i + 1792] = -fix(0.08131) * i;
        }
    }
};
const ColorTables kColor;

struct Divisor {
    uint32_t recip, corr;
    int shift;
};

// a quantiser's 64 divisors as arrays, so its loop vectorises
struct Divisors {
    uint32_t recip[64], corr[64], shift[64];
};

// jcdctmgr.c flss / compute_reciprocal with a 16-bit DCTELEM
int flss(unsigned val) {
    int bit = 16;
    if (!val) return 0;
    if (!(val & 0xff00)) { bit -= 8; val <<= 8; }
    if (!(val & 0xf000)) { bit -= 4; val <<= 4; }
    if (!(val & 0xc000)) { bit -= 2; val <<= 2; }
    if (!(val & 0x8000)) { bit -= 1; }
    return bit;
}

Divisor compute_reciprocal(unsigned divisor) {
    int b = flss(divisor) - 1;
    int r = 16 + b;
    uint32_t fq = (uint32_t)((1ull << r) / divisor);
    uint32_t fr = (uint32_t)((1ull << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {  // a power of two
        fq >>= 1;
        r--;
    } else if (fr <= divisor / 2u) {
        c++;
    } else {
        fq++;
    }
    return {fq & 0xFFFFu, c, r};
}

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table(force_baseline)
void quant_table(const int* basic, int quality, int* out) {
    if (quality <= 0) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int i = 0; i < 64; i++) {
        long temp = ((long)basic[i] * scale + 50L) / 100L;
        if (temp <= 0L) temp = 1L;
        if (temp > 32767L) temp = 32767L;
        if (temp > 255L) temp = 255L;
        out[i] = (int)temp;
    }
}

// jfdctint.c jpeg_fdct_islow, in place on 64 level-shifted samples
void fdct_islow(int32_t* data) {
    int32_t* p = data;
    for (int ctr = 0; ctr < 8; ctr++, p += 8) {
        int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
        int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
        int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
        int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = (tmp10 + tmp11) * (1 << kPass1Bits);
        p[4] = (tmp10 - tmp11) * (1 << kPass1Bits);
        int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[2] = descale(z1 + tmp13 * FIX_0_765366865, kConstBits - kPass1Bits);
        p[6] = descale(z1 + tmp12 * -FIX_1_847759065, kConstBits - kPass1Bits);
        z1 = tmp4 + tmp7;
        int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[7] = descale(tmp4 + z1 + z3, kConstBits - kPass1Bits);
        p[5] = descale(tmp5 + z2 + z4, kConstBits - kPass1Bits);
        p[3] = descale(tmp6 + z2 + z3, kConstBits - kPass1Bits);
        p[1] = descale(tmp7 + z1 + z4, kConstBits - kPass1Bits);
    }
    p = data;
    for (int ctr = 0; ctr < 8; ctr++, p++) {
        int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
        int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
        int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
        int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        p[0] = descale(tmp10 + tmp11, kPass1Bits);
        p[32] = descale(tmp10 - tmp11, kPass1Bits);
        int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
        p[16] = descale(z1 + tmp13 * FIX_0_765366865, kConstBits + kPass1Bits);
        p[48] = descale(z1 + tmp12 * -FIX_1_847759065, kConstBits + kPass1Bits);
        z1 = tmp4 + tmp7;
        int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
        int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp4 *= FIX_0_298631336;
        tmp5 *= FIX_2_053119869;
        tmp6 *= FIX_3_072711026;
        tmp7 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        p[56] = descale(tmp4 + z1 + z3, kConstBits + kPass1Bits);
        p[40] = descale(tmp5 + z2 + z4, kConstBits + kPass1Bits);
        p[24] = descale(tmp6 + z2 + z3, kConstBits + kPass1Bits);
        p[8] = descale(tmp7 + z1 + z4, kConstBits + kPass1Bits);
    }
}

struct EncTable {
    uint16_t code[256];
    uint8_t size[256];
};

// jchuff.c jpeg_make_c_derived_tbl: canonical codes in order of length
EncTable make_enc_table(const uint8_t* bits, const uint8_t* vals) {
    EncTable t;
    std::memset(&t, 0, sizeof(t));
    unsigned code = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
        for (int i = 0; i < bits[l - 1]; i++, p++) {
            t.code[vals[p]] = (uint16_t)code++;
            t.size[vals[p]] = (uint8_t)l;
        }
        code <<= 1;
    }
    return t;
}

struct EncTables {
    EncTable dc[2], ac[2];
    EncTables() {
        dc[0] = make_enc_table(kDcLumBits, kDcVals);
        ac[0] = make_enc_table(kAcLumBits, kAcLumVals);
        dc[1] = make_enc_table(kDcChrBits, kDcVals);
        ac[1] = make_enc_table(kAcChrBits, kAcChrVals);
    }
};
const EncTables kEnc;

struct Overflow {};

struct ByteSink {
    uint8_t* out;
    long cap, pos = 0;
    void byte(uint8_t b) {
        if (pos >= cap) throw Overflow();
        out[pos++] = b;
    }
    void word(unsigned v) {
        byte((uint8_t)(v >> 8));
        byte((uint8_t)v);
    }
    void bytes(const uint8_t* p, int n) {
        for (int i = 0; i < n; i++) byte(p[i]);
    }
};

// Entropy-coded bytes go straight to the output: the caller makes room for a
// whole block (kBlockBytes) before each one.
constexpr long kBlockBytes = 430;

struct BitWriter {
    ByteSink& sink;
    uint8_t* o;
    uint64_t acc = 0;
    int nbits = 0;
    explicit BitWriter(ByteSink& s) : sink(s), o(s.out + s.pos) {}
    void reserve_block() {
        if (sink.cap - (o - sink.out) < kBlockBytes) throw Overflow();
    }
    void put(uint32_t bits, int size) {
        acc = (acc << size) | (bits & ((1u << size) - 1u));
        nbits += size;
        if (nbits < 32) return;
        nbits -= 32;
        uint32_t word = (uint32_t)(acc >> nbits);
        // no 0xFF byte in the word: store it whole; else byte by byte, stuffing
        uint32_t inv = ~word;  // a 0xFF byte of word is a zero byte of inv
        if (((inv - 0x01010101u) & ~inv & 0x80808080u) == 0) {
            o[0] = (uint8_t)(word >> 24);
            o[1] = (uint8_t)(word >> 16);
            o[2] = (uint8_t)(word >> 8);
            o[3] = (uint8_t)word;
            o += 4;
        } else {
            for (int k = 24; k >= 0; k -= 8) {
                uint8_t b = (uint8_t)(word >> k);
                *o++ = b;
                if (b == 0xFF) *o++ = 0;
            }
        }
    }
    void flush() {  // jchuff.c flush_bits: pad the last byte with ones
        while (nbits >= 8) {
            nbits -= 8;
            uint8_t b = (uint8_t)(acc >> nbits);
            *o++ = b;
            if (b == 0xFF) *o++ = 0;
        }
        if (nbits > 0) {
            uint8_t b = (uint8_t)((acc << (8 - nbits)) | (0xFFu >> nbits));
            *o++ = b;
            if (b == 0xFF) *o++ = 0;
        }
        acc = 0;
        nbits = 0;
        sink.pos = o - sink.out;
    }
};

inline int nbits_of(int v) {  // JPEG_NBITS: bits in |v|
    return v ? 32 - __builtin_clz((unsigned)v) : 0;
}

// jchuff.c encode_one_block
void encode_block(BitWriter& bw, const int16_t* block, int& last_dc, const EncTable& dc,
                  const EncTable& ac) {
    bw.reserve_block();
    int temp = block[0] - last_dc;
    last_dc = block[0];
    int temp2 = temp;
    if (temp < 0) {
        temp = -temp;
        temp2--;
    }
    int nbits = nbits_of(temp);
    bw.put(dc.code[nbits], dc.size[nbits]);
    if (nbits) bw.put((uint32_t)temp2, nbits);
    // the AC run: visit the nonzero coefficients in zig-zag order through a
    // bit mask, so the zero runs cost no branches
    int16_t zz[64];
    for (int k = 1; k < 64; k++) zz[k] = block[kNatural[k]];
    uint64_t mask = 0;
    for (int k = 1; k < 64; k++) mask |= (uint64_t)(zz[k] != 0) << k;
    int last = 0;
    while (mask) {
        int k = __builtin_ctzll(mask);
        mask &= mask - 1;
        int r = k - last - 1;
        last = k;
        while (r > 15) {
            bw.put(ac.code[0xF0], ac.size[0xF0]);
            r -= 16;
        }
        temp = temp2 = zz[k];
        if (temp < 0) {
            temp = -temp;
            temp2--;
        }
        nbits = nbits_of(temp);
        int sym = (r << 4) + nbits;
        bw.put(ac.code[sym], ac.size[sym]);
        bw.put((uint32_t)temp2, nbits);
    }
    if (last != 63) bw.put(ac.code[0], ac.size[0]);  // EOB
}

// level shift, FDCT and quantisation (jcdctmgr.c quantize, branch-free: the
// magnitude is quantised and the sign put back) of the 8x8 block at (x0, y0)
void forward_block(const uint8_t* plane, int stride, int x0, int y0, const Divisors& div,
                   int16_t* out) {
    int32_t ws[64];
    for (int r = 0; r < 8; r++) {
        const uint8_t* row = plane + (long)(y0 + r) * stride + x0;
        for (int c = 0; c < 8; c++) ws[r * 8 + c] = (int32_t)row[c] - 128;
    }
    fdct_islow(ws);
    for (int i = 0; i < 64; i++) {
        int32_t temp = ws[i];
        int32_t sign = temp >> 31;
        uint32_t mag = (uint32_t)((temp ^ sign) - sign);
        int32_t q = (int32_t)(((mag + div.corr[i]) * div.recip[i]) >> div.shift[i]);
        out[i] = (int16_t)((q ^ sign) - sign);
    }
}

void write_dqt(ByteSink& s, int index, const int* q) {
    s.word(0xFFDB);
    s.word(67);
    s.byte((uint8_t)index);
    for (int i = 0; i < 64; i++) s.byte((uint8_t)q[kNatural[i]]);
}

void write_dht(ByteSink& s, int index, const uint8_t* bits, const uint8_t* vals) {
    int count = 0;
    for (int i = 0; i < 16; i++) count += bits[i];
    s.word(0xFFC4);
    s.word((unsigned)(2 + 1 + 16 + count));
    s.byte((uint8_t)index);
    s.bytes(bits, 16);
    s.bytes(vals, count);
}

long encode(const uint8_t* rgb, int W, int H, int quality, uint8_t* out, long cap) {
    int lq[64], cq[64];
    quant_table(kStdLumaQ, quality, lq);
    quant_table(kStdChromaQ, quality, cq);
    Divisors ldiv, cdiv;
    for (int i = 0; i < 64; i++) {
        Divisor l = compute_reciprocal((unsigned)lq[i] << 3);
        Divisor c = compute_reciprocal((unsigned)cq[i] << 3);
        ldiv.recip[i] = l.recip, ldiv.corr[i] = l.corr, ldiv.shift[i] = (uint32_t)l.shift;
        cdiv.recip[i] = c.recip, cdiv.corr[i] = c.corr, cdiv.shift[i] = (uint32_t)c.shift;
    }

    // planes: Y to a whole number of blocks, the chroma to one block per MCU
    const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;
    const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
    const int ystride = ybw * 8, cstride = mcux * 8;
    const int chroma_rows = (H + 1) / 2;  // rows the downsampler makes before the bottom pad
    std::vector<uint8_t> yplane((size_t)ystride * ybh * 8);
    std::vector<uint8_t> cbplane((size_t)cstride * mcuy * 8), crplane(cbplane.size());
    const int in_w = cstride * 2;  // jcsample.c expand_right_edge target of the chroma input
    std::vector<uint8_t> cbrow(2 * (size_t)in_w), crrow(2 * (size_t)in_w);
    const int32_t* t = kColor.t;
    for (int i = 0; i < chroma_rows; i++) {
        for (int k = 0; k < 2; k++) {
            int y = 2 * i + k < H ? 2 * i + k : H - 1;  // jcprepct.c expand_bottom_edge
            const uint8_t* px = rgb + (size_t)y * W * 3;
            uint8_t* cb = cbrow.data() + (size_t)k * in_w;
            uint8_t* cr = crrow.data() + (size_t)k * in_w;
            uint8_t* yrow = 2 * i + k < ybh * 8 ? yplane.data() + (size_t)(2 * i + k) * ystride
                                                  : nullptr;
            for (int x = 0; x < W; x++) {
                int r = px[3 * x], g = px[3 * x + 1], b = px[3 * x + 2];
                if (yrow) yrow[x] = (uint8_t)((t[r] + t[g + 256] + t[b + 512]) >> 16);
                cb[x] = (uint8_t)((t[r + 768] + t[g + 1024] + t[b + 1280]) >> 16);
                cr[x] = (uint8_t)((t[r + 1280] + t[g + 1536] + t[b + 1792]) >> 16);
            }
            if (yrow)
                for (int x = W; x < ystride; x++) yrow[x] = yrow[W - 1];
            for (int x = W; x < in_w; x++) {
                cb[x] = cb[W - 1];
                cr[x] = cr[W - 1];
            }
        }
        // jcsample.c h2v2_downsample: bias 1, 2, 1, 2, ... along the row
        uint8_t* cbo = cbplane.data() + (size_t)i * cstride;
        uint8_t* cro = crplane.data() + (size_t)i * cstride;
        const uint8_t *cb0 = cbrow.data(), *cb1 = cbrow.data() + in_w;
        const uint8_t *cr0 = crrow.data(), *cr1 = crrow.data() + in_w;
        for (int j = 0; j < cstride; j++) {
            int bias = 1 + (j & 1);
            cbo[j] = (uint8_t)((cb0[2 * j] + cb0[2 * j + 1] + cb1[2 * j] + cb1[2 * j + 1] + bias) >> 2);
            cro[j] = (uint8_t)((cr0[2 * j] + cr0[2 * j + 1] + cr1[2 * j] + cr1[2 * j + 1] + bias) >> 2);
        }
    }
    // bottom edges: Y rows past the image repeat its last row, chroma rows past
    // the downsampled ones repeat the last of those
    for (int y = H; y < ybh * 8; y++)
        std::memcpy(&yplane[(size_t)y * ystride], &yplane[(size_t)(H - 1) * ystride], ystride);
    for (int y = chroma_rows; y < mcuy * 8; y++) {
        std::memcpy(&cbplane[(size_t)y * cstride], &cbplane[(size_t)(chroma_rows - 1) * cstride],
                    cstride);
        std::memcpy(&crplane[(size_t)y * cstride], &crplane[(size_t)(chroma_rows - 1) * cstride],
                    cstride);
    }

    ByteSink s{out, cap};
    s.word(0xFFD8);
    const uint8_t app0[16] = {0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01, 0x00,
                              0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    s.word(0xFFE0);
    s.bytes(app0, 16);
    write_dqt(s, 0, lq);
    write_dqt(s, 1, cq);
    const uint8_t sof[17] = {0x00, 0x11, 8, (uint8_t)(H >> 8), (uint8_t)H, (uint8_t)(W >> 8),
                             (uint8_t)W, 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
    s.word(0xFFC0);
    s.bytes(sof, 17);
    write_dht(s, 0x00, kDcLumBits, kDcVals);
    write_dht(s, 0x10, kAcLumBits, kAcLumVals);
    write_dht(s, 0x01, kDcChrBits, kDcVals);
    write_dht(s, 0x11, kAcChrBits, kAcChrVals);
    const uint8_t sos[12] = {0x00, 0x0C, 3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0};
    s.word(0xFFDA);
    s.bytes(sos, 12);

    BitWriter bw(s);
    int last_dc[3] = {0, 0, 0};
    int16_t blk[4][64], cblk[64];
    for (int my = 0; my < mcuy; my++) {
        for (int mx = 0; mx < mcux; mx++) {
            // jccoefct.c compress_data: a dummy block has zero AC and the DC of
            // the block before it (right edge) or of the last block of the row
            // above it in the MCU (bottom edge)
            for (int yy = 0; yy < 2; yy++) {
                int by = 2 * my + yy;
                for (int xx = 0; xx < 2; xx++) {
                    int bx = 2 * mx + xx;
                    int16_t* b = blk[2 * yy + xx];
                    if (by < ybh && bx < ybw) {
                        forward_block(yplane.data(), ystride, bx * 8, by * 8, ldiv, b);
                    } else {
                        std::memset(b, 0, sizeof(blk[0]));
                        b[0] = by < ybh ? blk[2 * yy + xx - 1][0] : blk[1][0];
                    }
                }
            }
            for (int k = 0; k < 4; k++) encode_block(bw, blk[k], last_dc[0], kEnc.dc[0], kEnc.ac[0]);
            forward_block(cbplane.data(), cstride, mx * 8, my * 8, cdiv, cblk);
            encode_block(bw, cblk, last_dc[1], kEnc.dc[1], kEnc.ac[1]);
            forward_block(crplane.data(), cstride, mx * 8, my * 8, cdiv, cblk);
            encode_block(bw, cblk, last_dc[2], kEnc.dc[1], kEnc.ac[1]);
        }
    }
    bw.flush();
    s.word(0xFFD9);
    return s.pos;
}

// one component (cv2.imencode of an [H, W] image: JCS_GRAYSCALE in and out):
// the samples are Y as they are, one non-interleaved scan of whole blocks
// (jcmaster.c per_scan_setup: no dummy blocks), edges replicated as above,
// the luminance DQT and DHTs alone (jcmarker.c emits the tables in use)
long encode_gray(const uint8_t* gray, int W, int H, int quality, uint8_t* out, long cap) {
    int lq[64];
    quant_table(kStdLumaQ, quality, lq);
    Divisors ldiv;
    for (int i = 0; i < 64; i++) {
        Divisor l = compute_reciprocal((unsigned)lq[i] << 3);
        ldiv.recip[i] = l.recip, ldiv.corr[i] = l.corr, ldiv.shift[i] = (uint32_t)l.shift;
    }
    const int ybw = (W + 7) / 8, ybh = (H + 7) / 8;
    const int ystride = ybw * 8;
    std::vector<uint8_t> yplane((size_t)ystride * ybh * 8);
    for (int y = 0; y < ybh * 8; y++) {
        uint8_t* row = yplane.data() + (size_t)y * ystride;
        std::memcpy(row, gray + (size_t)(y < H ? y : H - 1) * W, W);
        for (int x = W; x < ystride; x++) row[x] = row[W - 1];
    }

    ByteSink s{out, cap};
    s.word(0xFFD8);
    const uint8_t app0[16] = {0x00, 0x10, 'J', 'F', 'I', 'F', 0x00, 0x01, 0x01, 0x00,
                              0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    s.word(0xFFE0);
    s.bytes(app0, 16);
    write_dqt(s, 0, lq);
    const uint8_t sof[11] = {0x00, 0x0B, 8, (uint8_t)(H >> 8), (uint8_t)H, (uint8_t)(W >> 8),
                             (uint8_t)W, 1, 1, 0x11, 0};
    s.word(0xFFC0);
    s.bytes(sof, 11);
    write_dht(s, 0x00, kDcLumBits, kDcVals);
    write_dht(s, 0x10, kAcLumBits, kAcLumVals);
    const uint8_t sos[8] = {0x00, 0x08, 1, 1, 0x00, 0, 63, 0};
    s.word(0xFFDA);
    s.bytes(sos, 8);

    BitWriter bw(s);
    int last_dc = 0;
    int16_t blk[64];
    for (int by = 0; by < ybh; by++) {
        for (int bx = 0; bx < ybw; bx++) {
            forward_block(yplane.data(), ystride, bx * 8, by * 8, ldiv, blk);
            encode_block(bw, blk, last_dc, kEnc.dc[0], kEnc.ac[0]);
        }
    }
    bw.flush();
    s.word(0xFFD9);
    return s.pos;
}

// ---------------------------------------------------------------------------
// decoder

struct JpegError : std::runtime_error {
    using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& what) { throw JpegError(what); }

struct DecTable {
    bool defined = false;
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t fast[1 << 9];  // (length << 8) | symbol for codes of 9 bits or fewer; 0: slow path
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_dec_table(DecTable& t, const uint8_t* bits, const uint8_t* vals, bool dc) {
    int count = 0;
    for (int i = 0; i < 16; i++) count += bits[i];
    if (count > 256) fail("corrupt JPEG data: bad Huffman table");
    int huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; l++)
        for (int i = 0; i < bits[l - 1]; i++) huffsize[p++] = l;
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1u << si)) fail("corrupt JPEG data: bad Huffman table");
        code <<= 1;
        si++;
    }
    p = 0;
    for (int l = 1; l <= 16; l++) {
        if (bits[l - 1]) {
            t.valoffset[l] = p - (int32_t)huffcode[p];
            p += bits[l - 1];
            t.maxcode[l] = (int32_t)huffcode[p - 1];
        } else {
            t.maxcode[l] = -1;
        }
    }
    t.maxcode[17] = 0x7FFFFFFF;
    std::memcpy(t.vals, vals, count);
    for (int i = 0; i < count; i++)
        if (dc && vals[i] > 15) fail("corrupt JPEG data: bad Huffman table");
    std::memset(t.fast, 0, sizeof(t.fast));
    p = 0;
    for (int l = 1; l <= 9; l++) {
        for (int i = 0; i < bits[l - 1]; i++, p++) {
            uint32_t lookbits = huffcode[p] << (9 - l);
            for (int ctr = 1 << (9 - l); ctr > 0; ctr--)
                t.fast[lookbits++] = (uint16_t)((l << 8) | vals[p]);
        }
    }
    t.defined = true;
}

struct BitReader {
    const uint8_t* p;
    const uint8_t* end;
    uint64_t buf = 0;
    int cnt = 0;      // bits in buf, from the top
    int phantom = 0;  // zero bits appended past a marker or the end of the data
    bool at_marker = false;

    void fill() {
        while (cnt <= 56) {
            unsigned b = 0;
            bool real = false;
            if (!at_marker && p < end) {
                if (*p != 0xFF) {
                    b = *p++;
                    real = true;
                } else if (p + 1 < end && p[1] == 0x00) {  // a stuffed 0xFF
                    b = 0xFF;
                    p += 2;
                    real = true;
                } else {
                    at_marker = true;
                }
            }
            if (!real) phantom += 8;
            buf |= (uint64_t)b << (56 - cnt);
            cnt += 8;
        }
    }
    uint32_t peek(int n) {
        if (cnt < n) fill();
        return (uint32_t)(buf >> (64 - n));
    }
    void skip(int n) {
        buf <<= n;
        cnt -= n;
        if (cnt < phantom) fail("truncated JPEG data");
    }
    uint32_t get(int n) {
        uint32_t v = peek(n);
        skip(n);
        return v;
    }
    void reset() {
        buf = 0;
        cnt = 0;
        phantom = 0;
        at_marker = false;
    }
};


inline int decode_symbol(BitReader& br, const DecTable& t) {
    uint32_t look = br.peek(16);
    uint16_t f = t.fast[look >> 7];
    if (f) {
        br.skip(f >> 8);
        return f & 0xFF;
    }
    for (int l = 10; l <= 16; l++) {
        int32_t code = (int32_t)(look >> (16 - l));
        if (code <= t.maxcode[l]) {
            br.skip(l);
            return t.vals[code + t.valoffset[l]];
        }
    }
    fail("corrupt JPEG data: bad Huffman code");
}

inline int receive_extend(BitReader& br, int s) {
    if (s == 0) return 0;
    int v = (int)br.get(s);
    return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jdmaster.c prepare_range_limit_table, the post-IDCT half: x & 1023 ->
// clamp(x + 128) for |x| < 512, wrapping beyond as libjpeg does
struct IdctLimit {
    uint8_t t[1024];
    IdctLimit() {
        for (int v = 0; v < 1024; v++)
            t[v] = (uint8_t)(v < 128 ? v + 128 : v < 512 ? 255 : v < 896 ? 0 : v - 896);
    }
};
const IdctLimit kIdctLimit;

// jidctint.c jpeg_idct_islow: dequantise, IDCT, range-limit into 8 rows of out
void idct_islow(const int16_t* coef, const int* q, uint8_t* out, int stride) {
    int32_t ws[64];
    for (int c = 0; c < 8; c++) {
        const int16_t* in = coef + c;
        const int* qp = q + c;
        int32_t* w = ws + c;
        if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
            in[48] == 0 && in[56] == 0) {
            int32_t dcval = (in[0] * qp[0]) * (1 << kPass1Bits);
            for (int r = 0; r < 8; r++) w[8 * r] = dcval;
            continue;
        }
        int32_t z2 = in[16] * qp[16], z3 = in[48] * qp[48];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        z2 = in[0] * qp[0];
        z3 = in[32] * qp[32];
        int32_t tmp0 = (z2 + z3) * (1 << kConstBits);
        int32_t tmp1 = (z2 - z3) * (1 << kConstBits);
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = in[56] * qp[56];
        tmp1 = in[40] * qp[40];
        tmp2 = in[24] * qp[24];
        tmp3 = in[8] * qp[8];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int32_t z4 = tmp1 + tmp3;
        int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = kConstBits - kPass1Bits;
        w[0] = descale(tmp10 + tmp3, sh);
        w[56] = descale(tmp10 - tmp3, sh);
        w[8] = descale(tmp11 + tmp2, sh);
        w[48] = descale(tmp11 - tmp2, sh);
        w[16] = descale(tmp12 + tmp1, sh);
        w[40] = descale(tmp12 - tmp1, sh);
        w[24] = descale(tmp13 + tmp0, sh);
        w[32] = descale(tmp13 - tmp0, sh);
    }
    const uint8_t* lim = kIdctLimit.t;
    for (int r = 0; r < 8; r++) {
        const int32_t* w = ws + 8 * r;
        uint8_t* o = out + (long)r * stride;
        if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
            w[7] == 0) {
            uint8_t dcval = lim[descale(w[0], kPass1Bits + 3) & 1023];
            for (int c = 0; c < 8; c++) o[c] = dcval;
            continue;
        }
        int32_t z2 = w[2], z3 = w[6];
        int32_t z1 = (z2 + z3) * FIX_0_541196100;
        int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
        int32_t tmp3 = z1 + z2 * FIX_0_765366865;
        int32_t tmp0 = (w[0] + w[4]) * (1 << kConstBits);
        int32_t tmp1 = (w[0] - w[4]) * (1 << kConstBits);
        int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
        int32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
        tmp0 = w[7];
        tmp1 = w[5];
        tmp2 = w[3];
        tmp3 = w[1];
        z1 = tmp0 + tmp3;
        z2 = tmp1 + tmp2;
        z3 = tmp0 + tmp2;
        int32_t z4 = tmp1 + tmp3;
        int32_t z5 = (z3 + z4) * FIX_1_175875602;
        tmp0 *= FIX_0_298631336;
        tmp1 *= FIX_2_053119869;
        tmp2 *= FIX_3_072711026;
        tmp3 *= FIX_1_501321110;
        z1 *= -FIX_0_899976223;
        z2 *= -FIX_2_562915447;
        z3 *= -FIX_1_961570560;
        z4 *= -FIX_0_390180644;
        z3 += z5;
        z4 += z5;
        tmp0 += z1 + z3;
        tmp1 += z2 + z4;
        tmp2 += z2 + z3;
        tmp3 += z1 + z4;
        const int sh = kConstBits + kPass1Bits + 3;
        o[0] = lim[descale(tmp10 + tmp3, sh) & 1023];
        o[7] = lim[descale(tmp10 - tmp3, sh) & 1023];
        o[1] = lim[descale(tmp11 + tmp2, sh) & 1023];
        o[6] = lim[descale(tmp11 - tmp2, sh) & 1023];
        o[2] = lim[descale(tmp12 + tmp1, sh) & 1023];
        o[5] = lim[descale(tmp12 - tmp1, sh) & 1023];
        o[3] = lim[descale(tmp13 + tmp0, sh) & 1023];
        o[4] = lim[descale(tmp13 - tmp0, sh) & 1023];
    }
}

// jdcolor.c ycc_rgb_convert: its tables' entries computed in place (the same
// integers: FIX() at SCALEBITS 16, ONE_HALF folded into the Cr->R, Cb->B and
// Cb->G terms)
constexpr int32_t fix16(double x) { return (int32_t)(x * 65536.0 + 0.5); }

void ycc_row_to_rgb(const uint8_t* yrow, const uint8_t* cbrow, const uint8_t* crrow,
                    uint8_t* out, int W) {
    for (int x = 0; x < W; x++) {
        int32_t y = yrow[x], cb = cbrow[x] - 128, cr = crrow[x] - 128;
        int32_t r = y + ((fix16(1.40200) * cr + (1 << 15)) >> 16);
        int32_t g = y + ((-fix16(0.34414) * cb + (1 << 15) - fix16(0.71414) * cr) >> 16);
        int32_t b = y + ((fix16(1.77200) * cb + (1 << 15)) >> 16);
        out[3 * x] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
        out[3 * x + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
        out[3 * x + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
    }
}

// jdsample.c h2v2_fancy_upsample, one output row: colsum j = 3 * near + far,
// output pair (2j, 2j+1) from colsum j and its left or right neighbour; the
// first and last columns use themselves as neighbour (dw > 2)
void fancy_row(const uint8_t* near, const uint8_t* far, int* cs, uint8_t* u, int dw, int W) {
    for (int j = 0; j < dw; j++) cs[j] = near[j] * 3 + far[j];
    u[0] = (uint8_t)((cs[0] * 4 + 8) >> 4);
    u[1] = (uint8_t)((cs[0] * 3 + cs[1] + 7) >> 4);
    for (int j = 1; j < dw - 1; j++) {
        u[2 * j] = (uint8_t)((cs[j] * 3 + cs[j - 1] + 8) >> 4);
        u[2 * j + 1] = (uint8_t)((cs[j] * 3 + cs[j + 1] + 7) >> 4);
    }
    int j = dw - 1;
    if (2 * j < W) u[2 * j] = (uint8_t)((cs[j] * 3 + cs[j - 1] + 8) >> 4);
    if (2 * j + 1 < W) u[2 * j + 1] = (uint8_t)((cs[j] * 4 + 7) >> 4);
}

struct Component {
    int id = 0, h = 1, v = 1, tq = 0, dc = 0, ac = 0;
    int stride = 0;
    std::vector<uint8_t> plane;
};

std::string fmt(const char* f, int a = 0, int b = 0, int c = 0, int d = 0) {
    char buf[160];
    std::snprintf(buf, sizeof(buf), f, a, b, c, d);
    return buf;
}

struct Decoder {
    const uint8_t* data;
    long len, pos = 0;
    int qt[4][64];
    bool qt_defined[4] = {false, false, false, false};
    DecTable dc[4], ac[4];
    int width = 0, height = 0, restart_interval = 0;
    bool sof = false, jfif = false, adobe = false;
    int adobe_transform = -1;
    Component comp[3];
    int scan[3] = {0, 1, 2};  // frame component index of each scan member

    Decoder(const uint8_t* d, long n) : data(d), len(n) {
        // jstdhuff.c: the standard tables stand in where a file defines none
        build_dec_table(dc[0], kDcLumBits, kDcVals, true);
        build_dec_table(ac[0], kAcLumBits, kAcLumVals, false);
        build_dec_table(dc[1], kDcChrBits, kDcVals, true);
        build_dec_table(ac[1], kAcChrBits, kAcChrVals, false);
    }

    unsigned u8() {
        if (pos >= len) fail("truncated JPEG header");
        return data[pos++];
    }
    unsigned u16() {
        unsigned hi = u8();
        return (hi << 8) | u8();
    }

    int next_marker() {
        while (pos < len && data[pos] != 0xFF) pos++;  // libjpeg skips stray bytes too
        while (pos < len && data[pos] == 0xFF) pos++;
        if (pos >= len) fail("truncated JPEG header");
        return data[pos++];
    }

    void read_header() {
        if (len < 2 || data[0] != 0xFF || data[1] != 0xD8)
            fail(fmt("not a JPEG: starts with 0x%02x%02x", len > 0 ? data[0] : 0,
                     len > 1 ? data[1] : 0));
        pos = 2;
        for (;;) {
            int m = next_marker();
            if (m == 0xC0 || m == 0xC1) {
                read_sof();
            } else if (m == 0xC2) {
                fail("unsupported JPEG: progressive (SOF2)");
            } else if (m == 0xC3) {
                fail("unsupported JPEG: lossless (SOF3)");
            } else if (m >= 0xC5 && m <= 0xC7) {
                fail(fmt("unsupported JPEG: hierarchical (SOF%d)", m - 0xC0));
            } else if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF)) {
                fail(fmt("unsupported JPEG: arithmetic coding (SOF%d)", m - 0xC0));
            } else if (m == 0xCC) {
                fail("unsupported JPEG: arithmetic coding (DAC)");
            } else if (m == 0xC4) {
                read_dht();
            } else if (m == 0xDB) {
                read_dqt();
            } else if (m == 0xDD) {
                if (u16() != 4) fail("corrupt JPEG: bad DRI length");
                restart_interval = (int)u16();
            } else if (m == 0xDA) {
                read_sos();
                return;
            } else if (m == 0xD9) {
                fail("JPEG has no image data (EOI before SOS)");
            } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
                // standalone markers
            } else {
                long start = pos;
                long n = (long)u16();
                if (n < 2 || start + n > len) fail("truncated JPEG header");
                const uint8_t* body = data + start + 2;
                if (m == 0xE0 && n >= 7 && std::memcmp(body, "JFIF\0", 5) == 0) jfif = true;
                if (m == 0xEE && n >= 14 && std::memcmp(body, "Adobe", 5) == 0) {
                    adobe = true;
                    adobe_transform = body[11];
                }
                pos = start + n;
            }
        }
    }

    void read_sof() {
        long start = pos;
        long n = (long)u16();
        int precision = (int)u8();
        height = (int)u16();
        width = (int)u16();
        int nf = (int)u8();
        if (precision != 8)
            fail(fmt("unsupported JPEG: %d-bit samples (only 8-bit)", precision));
        if (nf != 3) fail(fmt("unsupported JPEG: %d components (only 3)", nf));
        if (height == 0) fail("unsupported JPEG: height defined by a DNL marker");
        if (width == 0) fail("corrupt JPEG: zero width");
        if (n != 8 + 3 * nf) fail("corrupt JPEG: bad SOF length");
        for (int i = 0; i < 3; i++) {
            comp[i].id = (int)u8();
            unsigned hv = u8();
            comp[i].h = (int)(hv >> 4);
            comp[i].v = (int)(hv & 15);
            comp[i].tq = (int)u8();
            if (comp[i].tq > 3) fail("corrupt JPEG: bad quantisation table index");
        }
        bool s420 = comp[0].h == 2 && comp[0].v == 2;
        bool s444 = comp[0].h == 1 && comp[0].v == 1;
        for (int i = 1; i < 3; i++) s420 = s420 && comp[i].h == 1 && comp[i].v == 1;
        s444 = s444 && comp[1].h == 1 && comp[1].v == 1 && comp[2].h == 1 && comp[2].v == 1;
        if (!s420 && !s444) {
            char buf[160];
            std::snprintf(buf, sizeof(buf),
                          "unsupported JPEG: sampling factors %dx%d,%dx%d,%dx%d "
                          "(only 4:2:0 and 4:4:4)",
                          comp[0].h, comp[0].v, comp[1].h, comp[1].v, comp[2].h, comp[2].v);
            fail(buf);
        }
        pos = start + n;
        sof = true;
    }

    void read_dqt() {
        long start = pos;
        long n = (long)u16();
        long end = start + n;
        if (n < 2 || end > len) fail("truncated JPEG header");
        while (pos < end) {
            unsigned b = u8();
            int pq = (int)(b >> 4), tq = (int)(b & 15);
            if (tq > 3 || pq > 1) fail("corrupt JPEG: bad DQT");
            for (int i = 0; i < 64; i++) qt[tq][kNatural[i]] = (int)(pq ? u16() : u8());
            qt_defined[tq] = true;
        }
        if (pos != end) fail("corrupt JPEG: bad DQT length");
    }

    void read_dht() {
        long start = pos;
        long n = (long)u16();
        long end = start + n;
        if (n < 2 || end > len) fail("truncated JPEG header");
        while (pos < end) {
            unsigned b = u8();
            int tc = (int)(b >> 4), th = (int)(b & 15);
            if (tc > 1 || th > 3) fail("corrupt JPEG: bad DHT");
            uint8_t bits[16], vals[256];
            int count = 0;
            for (int i = 0; i < 16; i++) count += bits[i] = (uint8_t)u8();
            if (count > 256 || pos + count > end) fail("corrupt JPEG: bad DHT");
            for (int i = 0; i < count; i++) vals[i] = (uint8_t)u8();
            build_dec_table(tc ? ac[th] : dc[th], bits, vals, tc == 0);
        }
        if (pos != end) fail("corrupt JPEG: bad DHT length");
    }

    void read_sos() {
        if (!sof) fail("corrupt JPEG: SOS before SOF");
        long start = pos;
        long n = (long)u16();
        int ns = (int)u8();
        if (ns != 3)
            fail(fmt("unsupported JPEG: a scan of %d components (only one interleaved scan "
                     "of 3)", ns));
        if (n != 6 + 2 * ns) fail("corrupt JPEG: bad SOS length");
        for (int i = 0; i < ns; i++) {
            int id = (int)u8();
            unsigned t = u8();
            int k = -1;
            for (int c = 0; c < 3; c++)
                if (comp[c].id == id) k = c;
            if (k < 0) fail("corrupt JPEG: SOS names an unknown component");
            comp[k].dc = (int)(t >> 4);
            comp[k].ac = (int)(t & 15);
            if (comp[k].dc > 3 || comp[k].ac > 3) fail("corrupt JPEG: bad table index");
            scan[i] = k;
        }
        int ss = (int)u8(), se = (int)u8(), ahal = (int)u8();
        if (ss != 0 || se != 63 || ahal != 0)
            fail("unsupported JPEG: a scan that is not baseline sequential");
        for (int c = 0; c < 3; c++) {
            if (!qt_defined[comp[c].tq]) fail("corrupt JPEG: undefined quantisation table");
            if (!dc[comp[c].dc].defined || !ac[comp[c].ac].defined)
                fail("corrupt JPEG: undefined Huffman table");
        }
        bool rgb = jfif ? false
                   : adobe ? adobe_transform == 0
                           : comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
        if (rgb) fail("unsupported JPEG: RGB-coded components (no YCbCr transform)");
        pos = start + n;
    }

    void decode(uint8_t* rgb) {
        decode_planes();
        convert(rgb);
    }

    // the Y plane, cropped to the image: libjpeg's grayscale output of a YCbCr file
    void decode_gray(uint8_t* gray) {
        decode_planes();
        for (int y = 0; y < height; y++)
            std::memcpy(gray + (size_t)y * width,
                        comp[0].plane.data() + (size_t)y * comp[0].stride, (size_t)width);
    }

    void decode_planes() {
        const int hmax = comp[0].h, vmax = comp[0].v;  // Y carries the largest factors
        const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
        const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (auto& c : comp) {
            c.stride = mcux * c.h * 8;
            c.plane.assign((size_t)c.stride * mcuy * c.v * 8, 0);
        }
        BitReader br{data + pos, data + len};
        int pred[3] = {0, 0, 0};
        int restarts_to_go = restart_interval, next_rst = 0;
        alignas(16) int16_t block[64];
        for (int my = 0; my < mcuy; my++) {
            for (int mx = 0; mx < mcux; mx++) {
                if (restart_interval) {
                    if (restarts_to_go == 0) {
                        process_restart(br, next_rst);
                        pred[0] = pred[1] = pred[2] = 0;
                        restarts_to_go = restart_interval;
                    }
                    restarts_to_go--;
                }
                for (int si = 0; si < 3; si++) {
                    Component& c = comp[scan[si]];
                    const DecTable& dct = dc[c.dc];
                    const DecTable& act = ac[c.ac];
                    for (int by = 0; by < c.v; by++) {
                        for (int bx = 0; bx < c.h; bx++) {
                            std::memset(block, 0, sizeof(block));
                            int s = decode_symbol(br, dct);
                            long long dcval = (long long)pred[scan[si]] + receive_extend(br, s);
                            if (dcval > 32767 || dcval < -32768)  // jdhuff.c JERR_BAD_DCT_COEF
                                fail("corrupt JPEG data: DC coefficient out of range");
                            pred[scan[si]] = (int)dcval;
                            block[0] = (int16_t)dcval;
                            for (int k = 1; k < 64; k++) {
                                int rs = decode_symbol(br, act);
                                int r = rs >> 4;
                                s = rs & 15;
                                if (s) {
                                    k += r;
                                    block[kNatural[k]] = (int16_t)receive_extend(br, s);
                                } else if (r == 15) {
                                    k += 15;
                                } else {
                                    break;
                                }
                            }
                            long x0 = (long)(mx * c.h + bx) * 8, y0 = (long)(my * c.v + by) * 8;
                            idct_islow(block, qt[c.tq], c.plane.data() + y0 * c.stride + x0,
                                       c.stride);
                        }
                    }
                }
            }
        }
    }

    void process_restart(BitReader& br, int& next_rst) {
        // the interval's bits end at a byte boundary; the RST marker follows
        const uint8_t* p = br.p;
        const uint8_t* end = data + len;
        while (p < end && *p != 0xFF) p++;
        while (p < end && *p == 0xFF) p++;
        if (p >= end) fail("truncated JPEG data");
        if (*p != 0xD0 + next_rst)
            fail(fmt("corrupt JPEG data: expected RST%d, found marker 0x%02x", next_rst, *p));
        br.p = p + 1;
        br.reset();
        next_rst = (next_rst + 1) & 7;
    }

    // jdsample.c h2v2_fancy_upsample (or h2v2_upsample where the chroma is 2
    // samples wide or less) and jdcolor.c ycc_rgb_convert, a row at a time
    void convert(uint8_t* rgb) {
        const int W = width, H = height;
        const bool sub = comp[0].h == 2;
        const int dw = sub ? (W + 1) / 2 : W, dh = sub ? (H + 1) / 2 : H;
        const bool fancy = sub && dw > 2;
        std::vector<uint8_t> up[2] = {std::vector<uint8_t>(W), std::vector<uint8_t>(W)};
        std::vector<int> colsum(dw);
        for (int y = 0; y < H; y++) {
            const uint8_t* yrow = comp[0].plane.data() + (size_t)y * comp[0].stride;
            const uint8_t* crow[2];
            for (int k = 0; k < 2; k++) {
                const Component& c = comp[1 + k];
                if (!sub) {
                    crow[k] = c.plane.data() + (size_t)y * c.stride;
                    continue;
                }
                const int i = y >> 1;
                const uint8_t* near = c.plane.data() + (size_t)i * c.stride;
                uint8_t* u = up[k].data();
                if (!fancy) {
                    for (int x = 0; x < W; x++) u[x] = near[x >> 1];
                } else {
                    int far_i = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
                    fancy_row(near, c.plane.data() + (size_t)far_i * c.stride, colsum.data(), u,
                              dw, W);
                }
                crow[k] = u;
            }
            ycc_row_to_rgb(yrow, crow[0], crow[1], rgb + (size_t)y * W * 3, W);
        }
    }
};

void set_error(char* err, int errlen, const char* msg) {
    if (err && errlen > 0) {
        std::strncpy(err, msg, (size_t)errlen - 1);
        err[errlen - 1] = 0;
    }
}

}  // namespace

extern "C" {

long vfpjpeg_encode_bound(int width, int height) {
    if (width < 1 || height < 1 || width > 65535 || height > 65535) return -1;
    long mcus = (long)((width + 15) / 16) * ((height + 15) / 16);
    // headers, then per block a DC and 63 AC codes of at most 27 and 26 bits,
    // an EOB, every byte possibly stuffed
    return 1024 + mcus * 6 * 430;
}

long vfpjpeg_encode(const unsigned char* rgb, int width, int height, int quality,
                    unsigned char* out, long cap) {
    if (!rgb || !out || width < 1 || height < 1 || width > 65535 || height > 65535) return -1;
    try {
        return encode(rgb, width, height, quality, out, cap);
    } catch (...) {
        return -1;
    }
}

long vfpjpeg_encode_gray(const unsigned char* gray, int width, int height, int quality,
                         unsigned char* out, long cap) {
    if (!gray || !out || width < 1 || height < 1 || width > 65535 || height > 65535) return -1;
    try {
        return encode_gray(gray, width, height, quality, out, cap);
    } catch (...) {
        return -1;
    }
}

int vfpjpeg_decode_header(const unsigned char* data, long len, int* width, int* height,
                          char* err, int errlen) {
    try {
        Decoder d(data, len);
        d.read_header();
        *width = d.width;
        *height = d.height;
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
        return 1;
    }
}

int vfpjpeg_decode(const unsigned char* data, long len, unsigned char* rgb, int width,
                   int height, char* err, int errlen) {
    try {
        Decoder d(data, len);
        d.read_header();
        if (d.width != width || d.height != height) {
            char buf[128];
            std::snprintf(buf, sizeof(buf), "JPEG is %dx%d, expected %dx%d", d.width, d.height,
                          width, height);
            fail(buf);
        }
        d.decode(rgb);
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
        return 1;
    }
}

int vfpjpeg_decode_gray(const unsigned char* data, long len, unsigned char* gray, int width,
                        int height, char* err, int errlen) {
    try {
        Decoder d(data, len);
        d.read_header();
        if (d.width != width || d.height != height) {
            char buf[128];
            std::snprintf(buf, sizeof(buf), "JPEG is %dx%d, expected %dx%d", d.width, d.height,
                          width, height);
            fail(buf);
        }
        d.decode_gray(gray);
        return 0;
    } catch (const std::exception& e) {
        set_error(err, errlen, e.what());
        return 1;
    }
}

}  // extern "C"
