// Piece-emission hash kernels for Hopper (sm_90a): decode + splice + hash
// of one (K=1) or two (pair) candidates per thread, straight from the
// sweep-resident piece tables, for MD5, MD4, SHA-1 and NTLM.
//
// Replaces the TPU kernel body `_make_piece_kernel` of the reference
// package (hashcat_a5_table_generator_tpu/ops/pallas_expand.py:1303,
// launched through `_launch_fused` / `pl.pallas_call` at :1961) in every
// tier that body has, for match plans (`fused_expand_md5` :2019: default
// and reverse mode) and substitute-all plans (`kind="suball"`, through
// `fused_expand_suball_md5` :2373: `-s` and `-s -r`):
//   DECODE_SCALAR    the scalar-units full enumeration (cb = pbase + rank;
//                    `scalar and not windowed`, :1415-1421);
//   DECODE_DIGITS    the general tier: mixed-radix digits from per-block
//                    base digits + the in-block rank with carries
//                    (`_decode_tile` :773 / `_decode_tile_radix2` :380),
//                    variants from `col_variant` (:1478) with the padding
//                    clamp (:1557-1564) and merged binary columns
//                    (:1565-1570);
//   DECODE_WINDOWED  the count-windowed tier: the suffix-count DP walk over
//                    `win_v[M+1, K2]` with its subtractive quotient chain
//                    (`_decode_tile_windowed` :333), optionally packing the
//                    chosen bits into cb for the scalar selectors
//                    (:1436-1446);
// the substitute-all selectors (KIND_SUBALL, :1384-1390): a column is one
// pattern OCCURRENCE, driven by its pattern slot — scalar decodes test bit
// `sel_bit[w, c]` of cb (`selbit` :1553-1555), digit decodes read the digit
// of slot `sel_slot[w, c]` (`selslot` in `col_variant` :1482-1491), and
// the windowed decode packs slot s's chosen bit at `bitpos[w, s]`
// (:1443-1446); the cascade closure (CLOSED, :1462-1476, :1488-1491): a
// chosen closed slot's variant is 1 + its joint index over its own digit
// and up to three later successor slots' digits, addressing pre-cascaded
// value rows;
// and, per hash, `_md5_rounds`, `_md4_rounds` (:1129), `_sha1_rounds`
// (:1162), the NTLM code-unit split of `split_pieces` (:1601-1629), the
// length words of `_length_words` (:949) and the per-lane padding-block
// select of `_compress_message` (:1231).  The pair tier (pair=True,
// :1401-1460, :1571-1579) runs the scalar or the digit decode with one
// hash block.
//
// One device body, templated on ALGO (md5, md4, sha1, ntlm), KIND (match,
// suball), DECODE (scalar, digits, windowed), HB (hash blocks, 1-3) and
// CLOSED (the joint closure index; suball digit and windowed decodes).
// Each shared library built from this file holds one ALGO
// (`-DPIECE_ALGO=n`), so the four hashes build in parallel.
//
// What one lane computes (block b, in-block lane r, word w = blk_word[b]):
//   decode   scalar: cb = base[b] + r (pair: base[b] + 2r, partner cb | 1);
//            digits: digit[s] from base[b, s] + mixed-radix(r) with carry;
//            windowed: digit vector of the windowed rank base[b] + r.
//   emit     r < count[b] && min <= chosen count <= max
//            (pair partner: 2r + 1 < count[b], chosen count of cb | 1, or
//            of the digits with slot 0's digit + 1).
//   splice   For each PieceSchema group, in emission order: the variant
//            index (a bit-field of cb, or the group's column variant
//            clamped to its rows, or the merged columns' chosen bits;
//            a match column's variant is its slot's digit, a suball
//            column's that of its owning pattern slot, or 1 + the slot's
//            joint closure index when the slot is closed) picks the
//            variant's pre-masked word(s), OR-ed into the message at the
//            lane's running byte offset; the offset advances by the
//            group's placed length.  The tail group carries the 0x80
//            terminator, so the candidate is `off - 1` bytes.  NTLM places
//            each byte as a UTF-16LE code unit (the byte, then 00) at
//            doubled offsets: a u32 piece becomes two code-unit words.
//   hash     The bit length goes to the lane's own padding block k (word
//            16k+14; SHA-1: byte-swapped into word 16k+15); the lane
//            compresses blocks 0..k and outputs the state after block k.
// Non-emitted lanes may hold garbage state (the reference's contract);
// their bytes never land outside their own message.
//
// What bounds it on the H100: integer throughput.  Per candidate one
// compression costs ~320 INT32 instructions for MD5, ~176 for MD4/NTLM and
// ~608 for SHA-1 (chip_smoke.py derives the counts), against 17-21 output
// bytes and a few table words read through L1/L2, so every instantiation
// sits far on the operations side of the roofline.  The digit decodes add
// one integer divide per slot (digits) or the DP walk's table reads
// (windowed); both are small beside a compression.  The substitute-all
// selectors add one table read per selector column (sel_bit or sel_slot,
// by word index) and, when closed, a joint index of at most three
// multiply-adds per column.
//
// What this design does about it, first version: one thread per lane, no
// shared state between lanes except the group descriptors (copied once per
// CTA into shared memory), radix / win_v / piece rows read by word index
// from the resident tables (no per-launch gather), the substitute-all
// selector and closure tables read the same way, rotates as funnel
// shifts, round functions in their 3-input forms.  The message
// (`uint32_t[16 * HB]`) and the digit vector (`int[24]`) are indexed by
// data-dependent offsets and columns, so they live in local memory
// (`-Xptxas -v` reports the stack frame); the pair kernel builds the
// partner's message independently instead of sharing the prefix.  Those
// are levers for a later change, not correctness matters.
//
// Shifts by 32 are undefined in C++ and CUDA: placement shifts only by
// 8..24 when the spill word is written, and the scalar selectors test the
// bit position (a match column, or a suball column's sel_bit) against 32
// before shifting.
//
// Types: torch tensors are int32; the kernel reinterprets them as
// uint32_t.  `gw16` and `gl` arrive widened to int32.

#include <cuda_runtime.h>
#include <stdint.h>

#define ALGO_MD5 0
#define ALGO_MD4 1
#define ALGO_SHA1 2
#define ALGO_NTLM 3

#define KIND_MATCH 0
#define KIND_SUBALL 1

#define DECODE_SCALAR 0
#define DECODE_DIGITS 1
#define DECODE_WINDOWED 2

#define DESC_WIDTH 16
#define MAX_GROUPS 256
#define MAX_SEL 4
#define MAX_SLOTS 24

// Group descriptor fields (int32, DESC_WIDTH per group; built by
// ops/fused_expand.py::group_descriptors — keep the two in step).
#define D_NSEL 0        // number of selector columns
#define D_SEL 1         // selector columns, MAX_SEL (match: slots;
                        // suball: pattern occurrences)
#define D_NVAR 5        // variants
#define D_NWORDS 6      // u32 words per variant
#define D_FLOOR 7       // static lower bound of the group's byte offset
#define D_CAP 8         // static upper bound of the group's byte offset
#define D_LEN_FIXED 9   // placed length when static, else -1
#define D_PACKED16 10   // variant words live in gw16
#define D_TAB 11        // row of gw / gw16
#define D_GL 12         // row of gl (dynamic-length groups)
#define D_TERM 13       // the group carries the 0x80 terminator

struct PieceTables {
    const uint32_t* gw;    // [B, ngw, vm, nw]
    const int32_t* gw16;   // [B, ng16, vm]
    const int32_t* gl;     // [B, ngd, vm]
    int ngw, ng16, ngd, vm, nw;
};

// Everything one launch reads besides the piece tables.
struct LaunchArgs {
    const int32_t* blk_word;   // [NB]
    const int32_t* blk_count;  // [NB] candidates in each block
    const int32_t* blk_base;   // [NB] pbase / windowed rank, or [NB, M]
    const int32_t* radix;      // [B, M] (digits, windowed)
    const int32_t* win_v;      // [B, M+1, K2] (windowed)
    int nb, stride, m, k2, k_opts, pack;
    const int32_t* desc;       // [ngroups, DESC_WIDTH]
    int ngroups, min_sub, max_sub;
    int32_t* state;            // [rows, state words]
    uint8_t* emit;             // [rows]
    // Substitute-all selector and closure tables (null for match plans).
    const int32_t* sel_bit;    // [B, C] chosen-bit position of column c
    const int32_t* sel_slot;   // [B, C] pattern slot driving column c
    const int32_t* bitpos;     // [B, M] chosen-bit position of slot s
    const int32_t* cnext;      // [B, M, S] successor slots (-1 none)
    const int32_t* cmul;       // [B, M, S+1] joint index multipliers
    int ncols, close_s;
};

// One word's rows of the substitute-all tables.
struct SelRows {
    const int32_t* sel_bit;
    const int32_t* sel_slot;
    const int32_t* cnext;
    const int32_t* cmul;
    int m, close_s;
};

__device__ __forceinline__ SelRows sel_rows(const LaunchArgs& a, int w) {
    SelRows r;
    r.sel_bit = a.sel_bit ? a.sel_bit + (size_t)w * a.ncols : nullptr;
    r.sel_slot = a.sel_slot ? a.sel_slot + (size_t)w * a.ncols : nullptr;
    r.cnext = a.cnext ? a.cnext + (size_t)w * a.m * a.close_s : nullptr;
    r.cmul = a.cmul ? a.cmul + (size_t)w * a.m * (a.close_s + 1) : nullptr;
    r.m = a.m;
    r.close_s = a.close_s;
    return r;
}

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

// Mixed-radix digits of `r` added to the block's base digits with carry
// (slot 0 least significant); exact integer division — in-block ranks are
// below the block stride.
__device__ __forceinline__ void decode_digits(int* dg, int r,
                                              const int32_t* base,
                                              const int32_t* radix, int m) {
    int carry = 0;
    for (int s = 0; s < m; ++s) {
        const int rs = radix[s];
        const int q = r / rs;
        const int t = base[s] + (r - q * rs) + carry;
        const int ge = t >= rs ? 1 : 0;
        dg[s] = t - ge * rs;
        carry = ge;
        r = q;
    }
}

// The windowed rank `big_r` unranked through the suffix-count DP rows
// `v[(M+1) * K2]` of its word: per slot, "skip" covers v[s+1][j]
// completions and each option v[s+1][j+1]; the option quotient comes from
// a (k_opts - 1)-step subtractive chain (digits run 1..radix-1 <= k_opts).
// Digits are clipped to radix - 1 (lanes past the block's count decode
// garbage; emit masks them).  big_r stays below 2^30 + stride.
__device__ __forceinline__ void decode_windowed(int* dg, int big_r,
                                                const int32_t* v,
                                                const int32_t* radix, int m,
                                                int k2, int k_opts) {
    int jcnt = 0;
    for (int s = 0; s < m; ++s) {
        const int32_t* row = v + (s + 1) * k2;
        const int vn0 = jcnt < k2 ? row[jcnt] : 0;
        const int vn1 = jcnt + 1 < k2 ? row[jcnt + 1] : 0;
        const bool not_chosen = big_r < vn0;
        const int r2 = big_r - vn0;
        const int safe = vn1 > 1 ? vn1 : 1;
        int q = 0;
        int rr = r2;
        for (int i = 0; i < k_opts - 1; ++i) {
            const int ge = rr >= safe ? 1 : 0;
            rr -= ge * safe;
            q += ge;
        }
        const int d = not_chosen ? 0 : 1 + q;
        big_r = not_chosen ? big_r : rr;
        dg[s] = min(max(d, 0), radix[s] - 1);
        jcnt += not_chosen ? 0 : 1;
    }
}

// ---------------------------------------------------------------------------
// Splice + hash
// ---------------------------------------------------------------------------

// OR one piece word into the message at byte offset `o`: a (lo, hi) pair
// straddling words o/4 and o/4 + 1.  Words past the data area (the last
// block's length words) are never written.
template <int NW_DATA>
__device__ __forceinline__ void place(uint32_t* m, int o, uint32_t wd) {
    const int q = o >> 2;
    const int sh = (o & 3) * 8;
    if (q < NW_DATA) m[q] |= wd << sh;
    if (sh != 0 && q + 1 < NW_DATA) m[q + 1] |= wd >> (32 - sh);
}

// The variant a digit-decoded column selects (0 = the span's own bytes):
// match plans, its slot's digit; suball plans, the digit of the pattern
// slot that owns the occurrence — or, for a chosen slot of a closed plan,
// 1 + its joint index (d - 1) * cmul[sl, 0] + sum_s d[cnext[sl, s]] *
// cmul[sl, 1 + s] over its successor slots (always later slots).
template <int KIND, bool CLOSED>
__device__ __forceinline__ int col_variant(int c, const int* dg,
                                           const SelRows& sr) {
    if (KIND == KIND_MATCH) return dg[c];
    const int sl = sr.sel_slot[c];
    const int d = (unsigned)sl < (unsigned)sr.m ? dg[sl] : 0;
    if (!CLOSED || d <= 0) return d;
    const int* mul = sr.cmul + sl * (sr.close_s + 1);
    int jc = (d - 1) * mul[0];
    for (int i = 0; i < sr.close_s; ++i) {
        const int nt = sr.cnext[sl * sr.close_s + i];
        if (nt > sl && nt < sr.m) jc += dg[nt] * mul[1 + i];
    }
    return 1 + jc;
}

// Splice one candidate's bytes (terminator included) into m[0..16*HB) and
// return its length in bytes.  CB: variant indices are bit-fields of the
// packed chosen vector `cb` (a match column c is bit c; a suball column
// bit sel_bit[c], 31 on padding columns, which no cb sets); otherwise they
// come from the digit vector `dg` (one column: its variant clamped to the
// group's rows; merged binary columns: their chosen bits).
template <int ALGO, int HB, int KIND, bool CB, bool CLOSED>
__device__ __forceinline__ int build_message(uint32_t* m, uint32_t cb,
                                             const int* dg, int w,
                                             const int* desc, int ngroups,
                                             const PieceTables& t,
                                             const SelRows& sr) {
    constexpr int NW_DATA = 16 * HB - 2;
#pragma unroll
    for (int j = 0; j < 16 * HB; ++j) m[j] = 0u;
    int off = 0;
    for (int gi = 0; gi < ngroups; ++gi) {
        const int* g = desc + gi * DESC_WIDTH;
        const int len_fixed = g[D_LEN_FIXED];
        if (len_fixed == 0) continue;  // empty in every launched word
        const int nvar = g[D_NVAR];
        int idx = 0;
        if (nvar > 1) {
            const int nsel = g[D_NSEL];
            if (CB) {
                for (int i = 0; i < nsel; ++i) {
                    const int c = g[D_SEL + i];
                    const int bit = KIND == KIND_MATCH ? c : sr.sel_bit[c];
                    idx |= (int)(((unsigned)bit < 32u ? (cb >> bit) : 0u)
                                 & 1u) << i;
                }
            } else if (nsel == 1) {
                idx = col_variant<KIND, CLOSED>(g[D_SEL], dg, sr);
            } else {
                for (int i = 0; i < nsel; ++i) {
                    idx |= (col_variant<KIND, CLOSED>(g[D_SEL + i], dg, sr)
                            > 0 ? 1 : 0) << i;
                }
            }
            idx = min(max(idx, 0), nvar - 1);
        }
        const int nwords = g[D_NWORDS];
        for (int wi = 0; wi < nwords; ++wi) {
            uint32_t wd;
            if (g[D_PACKED16]) {
                wd = (uint32_t)t.gw16[((size_t)w * t.ng16 + g[D_TAB]) * t.vm
                                      + idx];
            } else {
                wd = t.gw[(((size_t)w * t.ngw + g[D_TAB]) * t.vm + idx)
                          * t.nw + wi];
            }
            const int o = off + 4 * wi;
            if (ALGO == ALGO_NTLM) {
                // Bytes b0..b3 become code units (b0 | b1 << 16) at 2o and
                // (b2 | b3 << 16) at 2o + 4; the terminator byte becomes
                // the padded message's 80 00.  u16 rows have no b2, b3.
                place<NW_DATA>(m, 2 * o,
                               (wd & 0xFFu) | ((wd & 0xFF00u) << 8));
                if (!g[D_PACKED16]) {
                    place<NW_DATA>(m, 2 * o + 4,
                                   ((wd >> 16) & 0xFFu) | ((wd >> 24) << 16));
                }
            } else {
                place<NW_DATA>(m, o, wd);
            }
        }
        off += len_fixed >= 0
            ? len_fixed
            : t.gl[((size_t)w * t.ngd + g[D_GL]) * t.vm + idx];
    }
    return off - 1;
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

__device__ __forceinline__ void load_desc(int* sdesc, const int* desc,
                                          int ngroups) {
    for (int i = threadIdx.x; i < ngroups * DESC_WIDTH; i += blockDim.x) {
        sdesc[i] = desc[i];
    }
    __syncthreads();
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

template <int ALGO, int HB>
__device__ __forceinline__ void hash_lane(uint32_t* m, int len,
                                          const LaunchArgs& a,
                                          long long row) {
    uint32_t st[Hash<ALGO>::WORDS];
    hash_message<ALGO, HB>(m, len * Hash<ALGO>::SCALE, st);
    store_state<ALGO>(a.state, row, st);
}

__device__ __forceinline__ bool in_window(int cc, const LaunchArgs& a) {
    return cc >= a.min_sub && cc <= a.max_sub;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// One candidate per thread: lane r of block b is candidate rank r of the
// block, row b * stride + r.
template <int ALGO, int KIND, int DECODE, int HB, bool CLOSED>
__global__ void piece_kernel(LaunchArgs a, PieceTables t) {
    __shared__ int sdesc[MAX_GROUPS * DESC_WIDTH];
    load_desc(sdesc, a.desc, a.ngroups);
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (long long)a.nb * a.stride) return;
    const int blk = (int)(lane / a.stride);
    const int r = (int)(lane - (long long)blk * a.stride);
    const int w = a.blk_word[blk];
    const SelRows sr = sel_rows(a, w);
    uint32_t m[16 * HB];
    int len, cc;
    if (DECODE == DECODE_SCALAR) {
        const uint32_t cb = (uint32_t)(a.blk_base[blk] + r);
        cc = __popc(cb);
        len = build_message<ALGO, HB, KIND, true, false>(
            m, cb, nullptr, w, sdesc, a.ngroups, t, sr);
    } else {
        int dg[MAX_SLOTS];
        const int32_t* radix = a.radix + (size_t)w * a.m;
        if (DECODE == DECODE_DIGITS) {
            decode_digits(dg, r, a.blk_base + (size_t)blk * a.m, radix, a.m);
        } else {
            decode_windowed(dg, a.blk_base[blk] + r,
                            a.win_v + (size_t)w * (a.m + 1) * a.k2, radix,
                            a.m, a.k2, a.k_opts);
        }
        if (DECODE == DECODE_WINDOWED && !CLOSED && a.pack) {
            // Scalar selectors over the walk's chosen bits: match slot s
            // is bit s of cb, suball slot s bit bitpos[w, s].
            uint32_t cb = 0u;
            for (int s = 0; s < a.m; ++s) {
                const int bit = KIND == KIND_MATCH
                    ? s : a.bitpos[(size_t)w * a.m + s];
                cb |= (dg[s] > 0 ? 1u : 0u) << (bit & 31);
            }
            cc = __popc(cb);
            len = build_message<ALGO, HB, KIND, true, false>(
                m, cb, nullptr, w, sdesc, a.ngroups, t, sr);
        } else {
            cc = 0;
            for (int s = 0; s < a.m; ++s) cc += dg[s] > 0 ? 1 : 0;
            len = build_message<ALGO, HB, KIND, false, CLOSED>(
                m, 0u, dg, w, sdesc, a.ngroups, t, sr);
        }
    }
    hash_lane<ALGO, HB>(m, len, a, lane);
    a.emit[lane] = (r < a.blk_count[blk] && in_window(cc, a));
}

// Pair tier (one hash block): lane r of block b owns candidate ranks 2r
// and 2r + 1 of a block spanning 2 * stride ranks; the outputs land in
// rank order, row b * 2 * stride + 2r + p.  The schema's pair gate
// guarantees slot 0's radix is even on every launched word (and, for
// suball plans, that slot 0 drives column 0 and no other), so the partner
// differs from rank 2r only in slot 0: cb | 1 (scalar), or slot 0's digit
// + 1, which never carries (digits; clamped for garbage lanes).
template <int ALGO, int KIND, int DECODE>
__global__ void piece_pair_kernel(LaunchArgs a, PieceTables t) {
    __shared__ int sdesc[MAX_GROUPS * DESC_WIDTH];
    load_desc(sdesc, a.desc, a.ngroups);
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (long long)a.nb * a.stride) return;
    const int blk = (int)(lane / a.stride);
    const int r = (int)(lane - (long long)blk * a.stride);
    const int w = a.blk_word[blk];
    const SelRows sr = sel_rows(a, w);
    const int count = a.blk_count[blk];
    const long long row = 2 * lane;  // == b * 2 * stride + 2r
    if (DECODE == DECODE_SCALAR) {
        const uint32_t cb = (uint32_t)(a.blk_base[blk] + 2 * r);
        const int cc = __popc(cb);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            uint32_t m[16];
            const int len = build_message<ALGO, 1, KIND, true, false>(
                m, p ? (cb | 1u) : cb, nullptr, w, sdesc, a.ngroups, t, sr);
            hash_lane<ALGO, 1>(m, len, a, row + p);
            a.emit[row + p] = (2 * r + p < count && in_window(cc + p, a));
        }
    } else {
        int dg[MAX_SLOTS];
        const int32_t* radix = a.radix + (size_t)w * a.m;
        decode_digits(dg, 2 * r, a.blk_base + (size_t)blk * a.m, radix, a.m);
        int cc = 0;
        for (int s = 0; s < a.m; ++s) cc += dg[s] > 0 ? 1 : 0;
        const int d0 = dg[0];
        const int d0p = min(d0 + 1, radix[0] - 1);
        const int cc1 = cc + (d0p > 0 ? 1 : 0) - (d0 > 0 ? 1 : 0);
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            if (p) dg[0] = d0p;
            uint32_t m[16];
            const int len = build_message<ALGO, 1, KIND, false, false>(
                m, 0u, dg, w, sdesc, a.ngroups, t, sr);
            hash_lane<ALGO, 1>(m, len, a, row + p);
            a.emit[row + p] = (2 * r + p < count
                               && in_window(p ? cc1 : cc, a));
        }
    }
}

// ---- host launch wrappers ----

#ifndef PIECE_ALGO
#define PIECE_ALGO ALGO_MD5
#endif

static const int kThreads = 256;

static int launch_checks(const LaunchArgs& a, int hash_blocks) {
    if (a.ngroups < 0 || a.ngroups > MAX_GROUPS) return 1;
    if (a.m < 0 || a.m > MAX_SLOTS) return 1;
    if (hash_blocks < 1 || hash_blocks > 3) return 1;
    return 0;
}

// The tables a kind / decode / closure combination reads must be present.
static int kind_checks(const LaunchArgs& a, int kind, int decode, int closed) {
    if (kind != KIND_MATCH && kind != KIND_SUBALL) return 1;
    if (closed && (kind != KIND_SUBALL || decode == DECODE_SCALAR
                   || !a.cnext || !a.cmul || a.close_s < 1)) {
        return 1;
    }
    if (kind == KIND_SUBALL) {
        const bool cb = decode == DECODE_SCALAR
            || (decode == DECODE_WINDOWED && a.pack && !closed);
        if (cb ? !a.sel_bit : !a.sel_slot) return 1;
        if (cb && decode == DECODE_WINDOWED && !a.bitpos) return 1;
    }
    return 0;
}

template <int KIND, int DECODE, int HB, bool CLOSED>
static void launch_one(const LaunchArgs& a, const PieceTables& t,
                       unsigned grid, cudaStream_t s) {
    piece_kernel<PIECE_ALGO, KIND, DECODE, HB, CLOSED>
        <<<grid, kThreads, 0, s>>>(a, t);
}

template <int KIND, int DECODE, bool CLOSED>
static void launch_hb(const LaunchArgs& a, const PieceTables& t,
                      int hash_blocks, unsigned grid, cudaStream_t s) {
    switch (hash_blocks) {
        case 1: launch_one<KIND, DECODE, 1, CLOSED>(a, t, grid, s); break;
        case 2: launch_one<KIND, DECODE, 2, CLOSED>(a, t, grid, s); break;
        default: launch_one<KIND, DECODE, 3, CLOSED>(a, t, grid, s); break;
    }
}

template <int DECODE>
static int launch_single(const LaunchArgs& a, const PieceTables& t,
                         int kind, int closed, int hash_blocks,
                         void* stream) {
    if (launch_checks(a, hash_blocks) || kind_checks(a, kind, DECODE, closed)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long n = (long long)a.nb * a.stride;
    if (n == 0) return (int)cudaSuccess;
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == KIND_MATCH) {
        launch_hb<KIND_MATCH, DECODE, false>(a, t, hash_blocks, grid, s);
        return (int)cudaGetLastError();
    }
    if constexpr (DECODE != DECODE_SCALAR) {  // closed plans decode digits
        if (closed) {
            launch_hb<KIND_SUBALL, DECODE, true>(a, t, hash_blocks, grid, s);
            return (int)cudaGetLastError();
        }
    }
    launch_hb<KIND_SUBALL, DECODE, false>(a, t, hash_blocks, grid, s);
    return (int)cudaGetLastError();
}

static LaunchArgs make_args(const void* blk_word, const void* blk_count,
                            const void* blk_base, const void* radix,
                            const void* win_v, int nb, int stride, int m,
                            int k2, int k_opts, int pack, const void* desc,
                            int ngroups, int min_sub, int max_sub,
                            void* state, void* emit, const void* sel_bit,
                            const void* sel_slot, const void* bitpos,
                            const void* cnext, const void* cmul, int ncols,
                            int close_s) {
    LaunchArgs a;
    a.blk_word = static_cast<const int32_t*>(blk_word);
    a.blk_count = static_cast<const int32_t*>(blk_count);
    a.blk_base = static_cast<const int32_t*>(blk_base);
    a.radix = static_cast<const int32_t*>(radix);
    a.win_v = static_cast<const int32_t*>(win_v);
    a.nb = nb;
    a.stride = stride;
    a.m = m;
    a.k2 = k2;
    a.k_opts = k_opts;
    a.pack = pack;
    a.desc = static_cast<const int32_t*>(desc);
    a.ngroups = ngroups;
    a.min_sub = min_sub;
    a.max_sub = max_sub;
    a.state = static_cast<int32_t*>(state);
    a.emit = static_cast<uint8_t*>(emit);
    a.sel_bit = static_cast<const int32_t*>(sel_bit);
    a.sel_slot = static_cast<const int32_t*>(sel_slot);
    a.bitpos = static_cast<const int32_t*>(bitpos);
    a.cnext = static_cast<const int32_t*>(cnext);
    a.cmul = static_cast<const int32_t*>(cmul);
    a.ncols = ncols;
    a.close_s = close_s;
    return a;
}

static PieceTables make_tables(const void* gw, const void* gw16,
                               const void* gl, int ngw, int ng16, int ngd,
                               int vm, int nw) {
    PieceTables t;
    t.gw = static_cast<const uint32_t*>(gw);
    t.gw16 = static_cast<const int32_t*>(gw16);
    t.gl = static_cast<const int32_t*>(gl);
    t.ngw = ngw;
    t.ng16 = ng16;
    t.ngd = ngd;
    t.vm = vm;
    t.nw = nw;
    return t;
}

// Every entry point takes the same arguments (ops/fused_expand.py builds
// one list): the block fields, the decode tables, the piece tables, the
// group descriptors, the window, the hash-block count, the outputs (state
// int32[rows, 4|5], emit uint8[rows]), the plan kind (0 match, 1 suball),
// the closure flag, the suball selector and closure tables (null for
// match plans) and the stream.  `decode` must be one the entry point
// takes.  Each returns cudaGetLastError() after the launch (or
// cudaErrorInvalidValue for arguments it refuses).
#define PIECE_PARAMS                                                        \
    const void *blk_word, const void *blk_count, const void *blk_base,      \
        const void *radix, const void *win_v, int nb, int stride, int m,    \
        int k2, int k_opts, int pack, int decode, const void *gw,           \
        const void *gw16, const void *gl, int ngw, int ng16, int ngd,       \
        int vm, int nw, const void *desc, int ngroups, int min_sub,         \
        int max_sub, int hash_blocks, void *state, void *emit, int kind,    \
        int closed, const void *sel_bit, const void *sel_slot,              \
        const void *bitpos, const void *cnext, const void *cmul, int ncols, \
        int close_s, void *stream
#define PIECE_SETUP                                                         \
    const LaunchArgs a = make_args(blk_word, blk_count, blk_base, radix,    \
                                   win_v, nb, stride, m, k2, k_opts, pack,  \
                                   desc, ngroups, min_sub, max_sub, state,  \
                                   emit, sel_bit, sel_slot, bitpos, cnext,  \
                                   cmul, ncols, close_s);                   \
    const PieceTables t = make_tables(gw, gw16, gl, ngw, ng16, ngd, vm, nw)

extern "C" {

// K=1, scalar decode (pbase), 1-3 hash blocks.
int a5_piece_k1(PIECE_PARAMS) {
    PIECE_SETUP;
    if (decode != DECODE_SCALAR) return (int)cudaErrorInvalidValue;
    return launch_single<DECODE_SCALAR>(a, t, kind, closed, hash_blocks,
                                        stream);
}

// K=1, digit decode (base digits [NB, M]), 1-3 hash blocks.
int a5_piece_digits(PIECE_PARAMS) {
    PIECE_SETUP;
    if (decode != DECODE_DIGITS) return (int)cudaErrorInvalidValue;
    return launch_single<DECODE_DIGITS>(a, t, kind, closed, hash_blocks,
                                        stream);
}

// K=1, windowed decode (scalar windowed rank [NB]), cb packing when
// `pack`, 1-3 hash blocks.
int a5_piece_windowed(PIECE_PARAMS) {
    PIECE_SETUP;
    if (decode != DECODE_WINDOWED || a.k2 < 1 || a.k_opts < 1) {
        return (int)cudaErrorInvalidValue;
    }
    return launch_single<DECODE_WINDOWED>(a, t, kind, closed, hash_blocks,
                                          stream);
}

// Pair tier, scalar or digit decode, one hash block, no closure.
int a5_piece_pair(PIECE_PARAMS) {
    PIECE_SETUP;
    if (launch_checks(a, hash_blocks) || hash_blocks != 1 || closed
        || (decode != DECODE_SCALAR && decode != DECODE_DIGITS)
        || kind_checks(a, kind, decode, 0)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long n = (long long)a.nb * a.stride;
    if (n == 0) return (int)cudaSuccess;
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == KIND_MATCH && decode == DECODE_SCALAR) {
        piece_pair_kernel<PIECE_ALGO, KIND_MATCH, DECODE_SCALAR>
            <<<grid, kThreads, 0, s>>>(a, t);
    } else if (kind == KIND_MATCH) {
        piece_pair_kernel<PIECE_ALGO, KIND_MATCH, DECODE_DIGITS>
            <<<grid, kThreads, 0, s>>>(a, t);
    } else if (decode == DECODE_SCALAR) {
        piece_pair_kernel<PIECE_ALGO, KIND_SUBALL, DECODE_SCALAR>
            <<<grid, kThreads, 0, s>>>(a, t);
    } else {
        piece_pair_kernel<PIECE_ALGO, KIND_SUBALL, DECODE_DIGITS>
            <<<grid, kThreads, 0, s>>>(a, t);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
