// Shared device code of the hash kernels in this directory: the MD5, MD4
// and SHA-1 compressions, the per-slot digit decodes (mixed radix by
// multiply-high, the windowed DP walk) and the cascade closure's joint
// index, the in-order message appender over shared-memory slabs, the
// length words with the per-lane padding-block select, and the state
// store.  Included by piece_hash.cu (the per-slot piece kernels),
// bytescan_hash.cu (the byte-scan kernels) and buffer_hash.cu (the
// buffer hash); every function is
// __device__ __forceinline__, so each library compiles its own copy.
//
// Counterparts in the reference package
// (hashcat_a5_table_generator_tpu/ops/pallas_expand.py): `_md5_rounds`,
// `_md4_rounds` (:1129), `_sha1_rounds` (:1162), `_decode_tile` (:773),
// `_decode_tile_windowed` (:333), `_length_words` (:949) and the state
// select of `_compress_message` (:1231).
//
// Types: torch tensors are int32; the kernels reinterpret them as
// uint32_t.
//
// The host builds of these sources (tests/test_torch_*.py) compile
// everything from the ALGO_* defines on with CUDA keywords stubbed, and
// give DYN_SMEM a host meaning of their own.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// A kernel's dynamic shared memory (sized at launch).
#define DYN_SMEM(name) extern __shared__ __align__(16) uint8_t name[]

#define ALGO_MD5 0
#define ALGO_MD4 1
#define ALGO_SHA1 2
#define ALGO_NTLM 3

#define DECODE_SCALAR 0
#define DECODE_DIGITS 1
#define DECODE_WINDOWED 2

#define MAX_SLOTS 24

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int s) {
    return __funnelshift_l(x, x, s);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
    return ((x & 0xFFu) << 24) | ((x & 0xFF00u) << 8)
        | ((x >> 8) & 0xFF00u) | (x >> 24);
}

// ---------------------------------------------------------------------------
// Compressions
// ---------------------------------------------------------------------------

#define MD5_F(x, y, z) ((z) ^ ((x) & ((y) ^ (z))))
#define MD5_G(x, y, z) ((y) ^ ((z) & ((x) ^ (y))))
#define MD5_H(x, y, z) ((x) ^ (y) ^ (z))
#define MD5_I(x, y, z) ((y) ^ ((x) | ~(z)))
#define MD5_STEP(f, a, b, x, t, s) (a) = (b) + rotl32((a) + (f) + (x) + (t), (s))

__device__ __forceinline__ void md5_compress(uint32_t* st,
                                             const uint32_t* m) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    MD5_STEP(MD5_F(b, c, d), a, b, m[ 0], 0xd76aa478u,  7);
    MD5_STEP(MD5_F(a, b, c), d, a, m[ 1], 0xe8c7b756u, 12);
    MD5_STEP(MD5_F(d, a, b), c, d, m[ 2], 0x242070dbu, 17);
    MD5_STEP(MD5_F(c, d, a), b, c, m[ 3], 0xc1bdceeeu, 22);
    MD5_STEP(MD5_F(b, c, d), a, b, m[ 4], 0xf57c0fafu,  7);
    MD5_STEP(MD5_F(a, b, c), d, a, m[ 5], 0x4787c62au, 12);
    MD5_STEP(MD5_F(d, a, b), c, d, m[ 6], 0xa8304613u, 17);
    MD5_STEP(MD5_F(c, d, a), b, c, m[ 7], 0xfd469501u, 22);
    MD5_STEP(MD5_F(b, c, d), a, b, m[ 8], 0x698098d8u,  7);
    MD5_STEP(MD5_F(a, b, c), d, a, m[ 9], 0x8b44f7afu, 12);
    MD5_STEP(MD5_F(d, a, b), c, d, m[10], 0xffff5bb1u, 17);
    MD5_STEP(MD5_F(c, d, a), b, c, m[11], 0x895cd7beu, 22);
    MD5_STEP(MD5_F(b, c, d), a, b, m[12], 0x6b901122u,  7);
    MD5_STEP(MD5_F(a, b, c), d, a, m[13], 0xfd987193u, 12);
    MD5_STEP(MD5_F(d, a, b), c, d, m[14], 0xa679438eu, 17);
    MD5_STEP(MD5_F(c, d, a), b, c, m[15], 0x49b40821u, 22);
    MD5_STEP(MD5_G(b, c, d), a, b, m[ 1], 0xf61e2562u,  5);
    MD5_STEP(MD5_G(a, b, c), d, a, m[ 6], 0xc040b340u,  9);
    MD5_STEP(MD5_G(d, a, b), c, d, m[11], 0x265e5a51u, 14);
    MD5_STEP(MD5_G(c, d, a), b, c, m[ 0], 0xe9b6c7aau, 20);
    MD5_STEP(MD5_G(b, c, d), a, b, m[ 5], 0xd62f105du,  5);
    MD5_STEP(MD5_G(a, b, c), d, a, m[10], 0x02441453u,  9);
    MD5_STEP(MD5_G(d, a, b), c, d, m[15], 0xd8a1e681u, 14);
    MD5_STEP(MD5_G(c, d, a), b, c, m[ 4], 0xe7d3fbc8u, 20);
    MD5_STEP(MD5_G(b, c, d), a, b, m[ 9], 0x21e1cde6u,  5);
    MD5_STEP(MD5_G(a, b, c), d, a, m[14], 0xc33707d6u,  9);
    MD5_STEP(MD5_G(d, a, b), c, d, m[ 3], 0xf4d50d87u, 14);
    MD5_STEP(MD5_G(c, d, a), b, c, m[ 8], 0x455a14edu, 20);
    MD5_STEP(MD5_G(b, c, d), a, b, m[13], 0xa9e3e905u,  5);
    MD5_STEP(MD5_G(a, b, c), d, a, m[ 2], 0xfcefa3f8u,  9);
    MD5_STEP(MD5_G(d, a, b), c, d, m[ 7], 0x676f02d9u, 14);
    MD5_STEP(MD5_G(c, d, a), b, c, m[12], 0x8d2a4c8au, 20);
    MD5_STEP(MD5_H(b, c, d), a, b, m[ 5], 0xfffa3942u,  4);
    MD5_STEP(MD5_H(a, b, c), d, a, m[ 8], 0x8771f681u, 11);
    MD5_STEP(MD5_H(d, a, b), c, d, m[11], 0x6d9d6122u, 16);
    MD5_STEP(MD5_H(c, d, a), b, c, m[14], 0xfde5380cu, 23);
    MD5_STEP(MD5_H(b, c, d), a, b, m[ 1], 0xa4beea44u,  4);
    MD5_STEP(MD5_H(a, b, c), d, a, m[ 4], 0x4bdecfa9u, 11);
    MD5_STEP(MD5_H(d, a, b), c, d, m[ 7], 0xf6bb4b60u, 16);
    MD5_STEP(MD5_H(c, d, a), b, c, m[10], 0xbebfbc70u, 23);
    MD5_STEP(MD5_H(b, c, d), a, b, m[13], 0x289b7ec6u,  4);
    MD5_STEP(MD5_H(a, b, c), d, a, m[ 0], 0xeaa127fau, 11);
    MD5_STEP(MD5_H(d, a, b), c, d, m[ 3], 0xd4ef3085u, 16);
    MD5_STEP(MD5_H(c, d, a), b, c, m[ 6], 0x04881d05u, 23);
    MD5_STEP(MD5_H(b, c, d), a, b, m[ 9], 0xd9d4d039u,  4);
    MD5_STEP(MD5_H(a, b, c), d, a, m[12], 0xe6db99e5u, 11);
    MD5_STEP(MD5_H(d, a, b), c, d, m[15], 0x1fa27cf8u, 16);
    MD5_STEP(MD5_H(c, d, a), b, c, m[ 2], 0xc4ac5665u, 23);
    MD5_STEP(MD5_I(b, c, d), a, b, m[ 0], 0xf4292244u,  6);
    MD5_STEP(MD5_I(a, b, c), d, a, m[ 7], 0x432aff97u, 10);
    MD5_STEP(MD5_I(d, a, b), c, d, m[14], 0xab9423a7u, 15);
    MD5_STEP(MD5_I(c, d, a), b, c, m[ 5], 0xfc93a039u, 21);
    MD5_STEP(MD5_I(b, c, d), a, b, m[12], 0x655b59c3u,  6);
    MD5_STEP(MD5_I(a, b, c), d, a, m[ 3], 0x8f0ccc92u, 10);
    MD5_STEP(MD5_I(d, a, b), c, d, m[10], 0xffeff47du, 15);
    MD5_STEP(MD5_I(c, d, a), b, c, m[ 1], 0x85845dd1u, 21);
    MD5_STEP(MD5_I(b, c, d), a, b, m[ 8], 0x6fa87e4fu,  6);
    MD5_STEP(MD5_I(a, b, c), d, a, m[15], 0xfe2ce6e0u, 10);
    MD5_STEP(MD5_I(d, a, b), c, d, m[ 6], 0xa3014314u, 15);
    MD5_STEP(MD5_I(c, d, a), b, c, m[13], 0x4e0811a1u, 21);
    MD5_STEP(MD5_I(b, c, d), a, b, m[ 4], 0xf7537e82u,  6);
    MD5_STEP(MD5_I(a, b, c), d, a, m[11], 0xbd3af235u, 10);
    MD5_STEP(MD5_I(d, a, b), c, d, m[ 2], 0x2ad7d2bbu, 15);
    MD5_STEP(MD5_I(c, d, a), b, c, m[ 9], 0xeb86d391u, 21);
    st[0] += a;
    st[1] += b;
    st[2] += c;
    st[3] += d;
}

// MD4 (RFC 1320), the NTLM core: three rounds of 16 steps; each step
// rotates the (a, b, c, d) roles as `_md4_rounds` does.
#define MD4_STEP(f, k, add, s)                                  \
    {                                                           \
        const uint32_t t_ = rotl32(a + (f) + m[k] + (add), s);  \
        a = d;                                                  \
        d = c;                                                  \
        c = b;                                                  \
        b = t_;                                                 \
    }
#define MD4_F (d ^ (b & (c ^ d)))
#define MD4_G ((b & (c | d)) | (c & d))
#define MD4_H (b ^ c ^ d)

__device__ __forceinline__ void md4_compress(uint32_t* st,
                                             const uint32_t* m) {
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
    MD4_STEP(MD4_F, 0, 0u, 3) MD4_STEP(MD4_F, 1, 0u, 7)
    MD4_STEP(MD4_F, 2, 0u, 11) MD4_STEP(MD4_F, 3, 0u, 19)
    MD4_STEP(MD4_F, 4, 0u, 3) MD4_STEP(MD4_F, 5, 0u, 7)
    MD4_STEP(MD4_F, 6, 0u, 11) MD4_STEP(MD4_F, 7, 0u, 19)
    MD4_STEP(MD4_F, 8, 0u, 3) MD4_STEP(MD4_F, 9, 0u, 7)
    MD4_STEP(MD4_F, 10, 0u, 11) MD4_STEP(MD4_F, 11, 0u, 19)
    MD4_STEP(MD4_F, 12, 0u, 3) MD4_STEP(MD4_F, 13, 0u, 7)
    MD4_STEP(MD4_F, 14, 0u, 11) MD4_STEP(MD4_F, 15, 0u, 19)
    MD4_STEP(MD4_G, 0, 0x5A827999u, 3) MD4_STEP(MD4_G, 4, 0x5A827999u, 5)
    MD4_STEP(MD4_G, 8, 0x5A827999u, 9) MD4_STEP(MD4_G, 12, 0x5A827999u, 13)
    MD4_STEP(MD4_G, 1, 0x5A827999u, 3) MD4_STEP(MD4_G, 5, 0x5A827999u, 5)
    MD4_STEP(MD4_G, 9, 0x5A827999u, 9) MD4_STEP(MD4_G, 13, 0x5A827999u, 13)
    MD4_STEP(MD4_G, 2, 0x5A827999u, 3) MD4_STEP(MD4_G, 6, 0x5A827999u, 5)
    MD4_STEP(MD4_G, 10, 0x5A827999u, 9) MD4_STEP(MD4_G, 14, 0x5A827999u, 13)
    MD4_STEP(MD4_G, 3, 0x5A827999u, 3) MD4_STEP(MD4_G, 7, 0x5A827999u, 5)
    MD4_STEP(MD4_G, 11, 0x5A827999u, 9) MD4_STEP(MD4_G, 15, 0x5A827999u, 13)
    MD4_STEP(MD4_H, 0, 0x6ED9EBA1u, 3) MD4_STEP(MD4_H, 8, 0x6ED9EBA1u, 9)
    MD4_STEP(MD4_H, 4, 0x6ED9EBA1u, 11) MD4_STEP(MD4_H, 12, 0x6ED9EBA1u, 15)
    MD4_STEP(MD4_H, 2, 0x6ED9EBA1u, 3) MD4_STEP(MD4_H, 10, 0x6ED9EBA1u, 9)
    MD4_STEP(MD4_H, 6, 0x6ED9EBA1u, 11) MD4_STEP(MD4_H, 14, 0x6ED9EBA1u, 15)
    MD4_STEP(MD4_H, 1, 0x6ED9EBA1u, 3) MD4_STEP(MD4_H, 9, 0x6ED9EBA1u, 9)
    MD4_STEP(MD4_H, 5, 0x6ED9EBA1u, 11) MD4_STEP(MD4_H, 13, 0x6ED9EBA1u, 15)
    MD4_STEP(MD4_H, 3, 0x6ED9EBA1u, 3) MD4_STEP(MD4_H, 11, 0x6ED9EBA1u, 9)
    MD4_STEP(MD4_H, 7, 0x6ED9EBA1u, 11) MD4_STEP(MD4_H, 15, 0x6ED9EBA1u, 15)
    st[0] += a;
    st[1] += b;
    st[2] += c;
    st[3] += d;
}

// SHA-1 (RFC 3174) over the shared little-endian message layout: each
// word is byte-swapped into the big-endian schedule, expanded in a rolling
// 16-word window (`_sha1_rounds`).
__device__ __forceinline__ void sha1_compress(uint32_t* st,
                                              const uint32_t* m) {
    uint32_t w[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) w[t] = bswap32(m[t]);
    uint32_t a = st[0], b = st[1], c = st[2], d = st[3], e = st[4];
#pragma unroll
    for (int t = 0; t < 80; ++t) {
        if (t >= 16) {
            w[t & 15] = rotl32(w[(t - 3) & 15] ^ w[(t - 8) & 15]
                               ^ w[(t - 14) & 15] ^ w[t & 15], 1);
        }
        uint32_t f, k;
        if (t < 20) {
            f = d ^ (b & (c ^ d));
            k = 0x5A827999u;
        } else if (t < 40) {
            f = b ^ c ^ d;
            k = 0x6ED9EBA1u;
        } else if (t < 60) {
            f = (b & (c | d)) | (c & d);
            k = 0x8F1BBCDCu;
        } else {
            f = b ^ c ^ d;
            k = 0xCA62C1D6u;
        }
        const uint32_t tmp = rotl32(a, 5) + f + e + k + w[t & 15];
        e = d;
        d = c;
        c = rotl32(b, 30);
        b = a;
        a = tmp;
    }
    st[0] += a;
    st[1] += b;
    st[2] += c;
    st[3] += d;
    st[4] += e;
}

template <int ALGO>
struct Hash {
    static constexpr int WORDS = ALGO == ALGO_SHA1 ? 5 : 4;
    static constexpr int SCALE = ALGO == ALGO_NTLM ? 2 : 1;
};

template <int ALGO>
__device__ __forceinline__ void compress(uint32_t* st, const uint32_t* m) {
    if (ALGO == ALGO_MD5) {
        md5_compress(st, m);
    } else if (ALGO == ALGO_SHA1) {
        sha1_compress(st, m);
    } else {
        md4_compress(st, m);
    }
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

// One slot's row of the digit decode, staged once a word: x = the radix
// d, and the reciprocal y and shift z that divide an in-block rank by it
// (rank_div).  A power of two (1 included) divides by a shift alone (y =
// 0); any other d by y = ceil(2^(31+s) / d), s = ceil(log2 d), z = s - 1,
// which is exact for ranks below 2^31: y * d - 2^(31+s) < d <= 2^s.
__device__ __forceinline__ int4 radix_row(int d) {
    d = d > 1 ? d : 1;
    int s = 0;
    while ((1u << s) < (uint32_t)d) ++s;
    if ((d & (d - 1)) == 0) return make_int4(d, 0, s, 0);
    const uint64_t y = ((1ull << (31 + s)) + (uint64_t)d - 1u) / (uint64_t)d;
    return make_int4(d, (int)(uint32_t)y, s - 1, 0);
}

// n / d for 0 <= n < 2^31, from d's radix_row.
__device__ __forceinline__ int rank_div(int n, const int4& rr) {
    const uint32_t q = rr.y ? __umulhi((uint32_t)n, (uint32_t)rr.y)
                            : (uint32_t)n;
    return (int)(q >> rr.z);
}

// Mixed-radix digits of the in-block rank `r` added to the block's base
// digits with carry (slot 0 least significant), each slot's divide a
// multiply-high or a shift (radix_row); each digit goes to `put(s, d)`.
template <class Put>
__device__ __forceinline__ void digits_walk(int r, const int32_t* base,
                                            const int4* rows, int m,
                                            Put&& put) {
    int carry = 0;
    for (int s = 0; s < m; ++s) {
        const int4 rr = rows[s];
        const int q = rank_div(r, rr);
        const int v = base[s] + (r - q * rr.x) + carry;
        const int ge = v >= rr.x ? 1 : 0;
        put(s, v - ge * rr.x);
        carry = ge;
        r = q;
    }
}

// The joint closure index of slot q chosen with digit d >= 1 (the
// cascade closure of substitute-all plans): (d - 1) * mul[0] + sum_i
// dg[nxt[i]] * mul[1 + i] over its successor slots later than q (`nxt`:
// the slot's `close_s` successors, -1 none; `mul`: its close_s + 1
// multipliers).
template <class Dig>
__device__ __forceinline__ int closure_index(int q, int d, Dig dg, int m,
                                             const int32_t* nxt,
                                             const int32_t* mul,
                                             int close_s) {
    int k = (d - 1) * mul[0];
    for (int i = 0; i < close_s; ++i) {
        const int nt = nxt[i];
        if (nt > q && nt < m) k += dg[nt] * mul[1 + i];
    }
    return k;
}

// The windowed rank `big_r` unranked through the suffix-count DP rows
// `v[(M+1) * K2]` of its word: per slot, "skip" covers v[s+1][j]
// completions and each option v[s+1][j+1]; the option quotient comes from
// a (k_opts - 1)-step subtractive chain (digits run 1..radix-1 <= k_opts).
// Digits are clipped to radix - 1 (lanes past the block's count decode
// garbage; emit masks them).  big_r stays below 2^30 + stride.  Each
// slot's digit goes to `put(s, digit)`, so a caller may keep the digits
// where it likes (an array, a shared-memory slab) or fold them straight
// into a chosen-bit vector.
template <class Put>
__device__ __forceinline__ void windowed_walk(int big_r, const int32_t* v,
                                              const int32_t* radix, int m,
                                              int k2, int k_opts,
                                              Put&& put) {
    int jcnt = 0;
    for (int s = 0; s < m; ++s) {
        const int32_t* row = v + (s + 1) * k2;
        const int vn0 = jcnt < k2 ? row[jcnt] : 0;
        const bool not_chosen = big_r < vn0;
        int q = 0;
        int rr = big_r - vn0;
        if (k_opts > 1) {
            const int vn1 = jcnt + 1 < k2 ? row[jcnt + 1] : 0;
            const int safe = vn1 > 1 ? vn1 : 1;
            for (int i = 0; i < k_opts - 1; ++i) {
                const int ge = rr >= safe ? 1 : 0;
                rr -= ge * safe;
                q += ge;
            }
        }
        const int d = not_chosen ? 0 : 1 + q;
        big_r = not_chosen ? big_r : rr;
        put(s, min(max(d, 0), radix[s] - 1));
        jcnt += not_chosen ? 0 : 1;
    }
}

// ---------------------------------------------------------------------------
// Message placement, length words, compression chain, state store
// ---------------------------------------------------------------------------

// Word j of a per-thread array kept in a shared-memory slab laid out
// [word][thread] (`n` threads): neighbouring threads touch neighbouring
// banks, and the array stays out of local memory though it is indexed by
// data-dependent offsets.
template <class T>
struct Slab {
    T* p;
    int n;
    __device__ __forceinline__ T& operator[](int j) const { return p[j * n]; }
};

// One message being written in order: the pending bits `lo` (`nb` of
// them, the bits above zero), the next word and the byte offset.
struct MsgState {
    uint32_t lo;
    int nb, widx, off;
};

// Append the `nbytes` low bytes of `x` (its bytes above them zero) to a
// message: each word that fills is stored once, past the data area
// dropped.
template <int NW_DATA, class Msg>
__device__ __forceinline__ void tile_put(Msg m, MsgState& st, uint32_t x,
                                         int nbytes) {
    const uint32_t hi = __funnelshift_l(x, 0u, st.nb);  // x >> (32 - nb)
    st.lo |= x << st.nb;
    st.nb += 8 * nbytes;
    if (st.nb >= 32) {
        if (st.widx < NW_DATA) m[st.widx] = st.lo;
        ++st.widx;
        st.lo = hi;
        st.nb -= 32;
    }
}

// Store a message's pending bits (the end of its data); returns the
// words it spans within the data area.
template <int NW_DATA, class Msg>
__device__ __forceinline__ int tile_end(Msg m, MsgState& st) {
    if (st.nb > 0 || st.lo != 0u) {
        if (st.widx < NW_DATA) m[st.widx] = st.lo;
        ++st.widx;
    }
    return st.widx < NW_DATA ? st.widx : NW_DATA;
}

// Rows of one table for the CTA's `nu` distinct words (`uw`), `len` words
// each, into field `off` of their records.
__device__ __forceinline__ void stage_rows(int32_t* recs, int rec, int off,
                                           const int32_t* src, int len,
                                           const int32_t* uw, int nu) {
    if (len <= 0 || src == nullptr) return;
    const int nt = blockDim.x;
    int u = threadIdx.x / len, j = threadIdx.x - u * len;
    while (u < nu) {
        recs[u * rec + off + j] = src[(size_t)uw[u] * len + j];
        j += nt;
        while (j >= len) {
            j -= len;
            ++u;
        }
    }
}

// How a launch's blocks are cut into CTAs (plain C++: the host launches
// and the host test builds call it): `g` whole blocks a CTA, as many as
// `lmax` lanes and `fit` staged word records allow (at most `gmax`); or,
// when a block's stride is wider than lmax, `c` chunks of `lc` lanes of
// one block.  `shift`: log2 of a power-of-two stride of whole blocks (a
// lane's block is then a shift), else -1.
struct TileCut {
    int g, c, lc, shift;
};

static inline TileCut tile_cut(int stride, int fit, int gmax, int lmax) {
    TileCut k;
    fit = fit < 1 ? 1 : (fit < gmax ? fit : gmax);
    if (stride <= lmax) {
        const int per = lmax / (stride > 0 ? stride : 1);
        k.g = per < fit ? per : fit;
        k.c = 1;
        k.lc = stride;
    } else {
        k.g = 1;
        k.c = (stride + lmax - 1) / lmax;
        k.lc = (stride + k.c - 1) / k.c;
    }
    k.shift = -1;
    for (int s = 0; k.c == 1 && s < 31; ++s) {
        if (stride == 1 << s) k.shift = s;
    }
    return k;
}

// A tile CTA's phase 1, run by one thread: numbers the distinct words of
// its G blocks (`bw`, -1 past the launch) into `bs` (each block's slot)
// and `bu` (each slot's word), and takes the prefix `bp[0..G]` of the
// lanes each block has below its count (`lanes(i)`) inside the CTA's
// lanes [lane0, lane1).  Returns the number of distinct words.
template <class Lanes>
__device__ __forceinline__ int tile_words(const int32_t* bw, Lanes&& lanes,
                                          int32_t* bs, int32_t* bu,
                                          int32_t* bp, int G, int lane0,
                                          int lane1) {
    int u = -1, pre = 0;
    for (int i = 0; i < G; ++i) {
        if (bw[i] >= 0 && (u < 0 || bw[i] != bu[u])) bu[++u] = bw[i];
        bs[i] = u < 0 ? 0 : u;
        bp[i] = pre;
        pre += max(min(lanes(i), lane1) - lane0, 0);
    }
    bp[G] = pre;
    return u + 1;
}

// The block of prefix index `i`: the last block whose prefix is <= i.
__device__ __forceinline__ int tile_block(const int32_t* bp, int G, int i) {
    int lo = 0, hi = G;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (bp[mid] <= i) lo = mid; else hi = mid;
    }
    return lo;
}

// Pack the live lanes of a warp into `list` (the CTA's live-lane list):
// one shared atomic a warp on `*n`, each live thread's place from the popc
// of the live lanes below it.  Every thread of the warp calls it.
__device__ __forceinline__ void pack_live(bool live, int entry, int* n,
                                          int32_t* list) {
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, live);
    if (mask != 0u) {
        const int lane = threadIdx.x & 31;
        const int leader = __ffs(mask) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(n, __popc(mask));
        at = __shfl_sync(0xFFFFFFFFu, at, leader);
        if (live) list[at + __popc(mask & ((1u << lane) - 1u))] = entry;
    }
}

// Length words + chained compressions up to the lane's own padding block.
// `end` is the message length in bytes (NTLM: twice the candidate's).
template <int ALGO, int HB>
__device__ __forceinline__ void hash_message(uint32_t* m, int end,
                                             uint32_t* st) {
    const uint32_t bits = (uint32_t)end * 8u;
#pragma unroll
    for (int k = 0; k < HB; ++k) {
        if (k + 1 == HB || end <= 64 * (k + 1) - 9) {
            if (ALGO == ALGO_SHA1) {
                m[16 * k + 15] |= bswap32(bits);
            } else {
                m[16 * k + 14] |= bits;
            }
        }
    }
    st[0] = 0x67452301u;
    st[1] = 0xefcdab89u;
    st[2] = 0x98badcfeu;
    st[3] = 0x10325476u;
    if (ALGO == ALGO_SHA1) st[Hash<ALGO>::WORDS - 1] = 0xc3d2e1f0u;
#pragma unroll
    for (int k = 0; k < HB; ++k) {
        compress<ALGO>(st, m + 16 * k);
        if (end <= 64 * (k + 1) - 9) break;
    }
}

// One 16-byte store per 4-word state (the rows are 16-byte aligned);
// SHA-1's 20-byte rows take five word stores.
template <int ALGO>
__device__ __forceinline__ void store_state(int32_t* state, long long row,
                                            const uint32_t* st) {
    constexpr int W = Hash<ALGO>::WORDS;
    if (W == 4) {
        reinterpret_cast<int4*>(state)[row] =
            make_int4((int)st[0], (int)st[1], (int)st[2], (int)st[3]);
    } else {
#pragma unroll
        for (int i = 0; i < W; ++i) state[row * W + i] = (int32_t)st[i];
    }
}

// Compress a slab's message of `end` bytes (NTLM: twice the candidate's)
// and store the state at `row`.  The slab's words past the message's end
// must be zero; those past the data area are never read.
template <int ALGO, int HB>
__device__ __forceinline__ void hash_slab(const Slab<uint32_t>& msg, int end,
                                          int32_t* state, long long row) {
    constexpr int NW_DATA = 16 * HB - 2;
    uint32_t mr[16 * HB];
#pragma unroll
    for (int j = 0; j < 16 * HB; ++j) mr[j] = j < NW_DATA ? msg[j] : 0u;
    uint32_t st[Hash<ALGO>::WORDS];
    hash_message<ALGO, HB>(mr, end, st);
    store_state<ALGO>(state, row, st);
}
