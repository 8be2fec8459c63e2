// Piece-emission MD5 kernels for Hopper (sm_90a): decode + splice + MD5 of
// one (K=1) or two (pair, K=2) candidates per thread, straight from the
// sweep-resident piece tables.
//
// Replaces the TPU kernel body `_make_piece_kernel` of the reference
// package (hashcat_a5_table_generator_tpu/ops/pallas_expand.py:1303,
// launched through `_launch_fused` / `pl.pallas_call` at :1961), in its
// match / scalar-units / full-enumeration tier: pair=False (budget keys
// `scalar-solo` and `2-hash-block`) and pair=True (key `scalar`).
//
// What one lane computes (block b, in-block lane r):
//   cb   = pbase[b] + r              (pair: pbase[b] + 2r, partner cb | 1)
//   emit = r < count[b] && min <= popcount(cb) <= max
//          (pair partner: 2r + 1 < count[b] && min <= popcount(cb) + 1 <= max)
//   For each PieceSchema group, in emission order: a bit-field of cb picks
//   the variant index; the variant's pre-masked word(s) (u32 `gw` rows, or
//   the narrow `gw16` rows) are OR-ed into the message at the lane's
//   running byte offset, and the offset advances by the group's placed
//   length (static, or the `gl` row of the variant).  The tail group's
//   bytes carry the 0x80 terminator, so the candidate is `off - 1` bytes.
//   The bit length goes to word 16k+14 of the lane's own padding block k
//   (end <= 64(k+1) - 9); the lane compresses blocks 0..k and outputs the
//   state after block k.  Non-emitted lanes may hold garbage state (the
//   reference's contract); their bytes never land outside their own
//   message.
//
// What bounds it on the H100: integer throughput.  Per candidate the MD5 rounds
// cost ~320 INT32 instructions per compression (per round one LOP3 for
// the round function, two IADD3, one SHF funnel rotate, one IADD), against
// 17 output bytes (state + emit) and a few table words read through L1/L2,
// so the kernel sits far on the operations side of the roofline.
//
// What this design does about it, first version: one thread per lane, no
// shared state between lanes except the group descriptors (copied once
// per block into shared memory), table rows read by word index from the
// resident tables (no per-launch gather), rotates as funnel shifts, round
// functions in their 3-input mux forms.  The message lives in a
// `uint32_t[16 * HB]` array indexed by the data-dependent piece offset, so
// it goes to local memory (`-Xptxas -v` reports the stack frame); the pair
// kernel builds the partner's message independently instead of sharing
// the prefix and funnel-shifting the suffix.  Both are levers for a later
// change, not correctness matters.
//
// Types: torch tensors are int32; the kernel reinterprets them as
// uint32_t.  `gw16` and `gl` arrive widened to int32.

#include <cuda_runtime.h>
#include <stdint.h>

#define DESC_WIDTH 16
#define MAX_GROUPS 256
#define MAX_SEL 4

// Group descriptor fields (int32, DESC_WIDTH per group; built by
// ops/fused_expand.py::group_descriptors — keep the two in step).
#define D_NSEL 0        // number of selector columns
#define D_SEL 1         // selector columns (bit positions of cb), MAX_SEL
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

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int s) {
    return __funnelshift_l(x, x, s);
}

#define MD5_F(x, y, z) ((z) ^ ((x) & ((y) ^ (z))))
#define MD5_G(x, y, z) ((y) ^ ((z) & ((x) ^ (y))))
#define MD5_H(x, y, z) ((x) ^ (y) ^ (z))
#define MD5_I(x, y, z) ((y) ^ ((x) | ~(z)))
#define MD5_STEP(f, a, b, x, t, s) (a) = (b) + rotl32((a) + (f) + (x) + (t), (s))

__device__ __forceinline__ void md5_compress(uint32_t st[4],
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

// Splice one candidate's bytes (terminator included) into m[0..16*HB) and
// return its length.  Whole-word placement: a group word lands at byte
// offset `o` as a (lo, hi) pair straddling words o/4 and o/4 + 1.  Words
// past the data area (the last block's length words) are never written.
template <int HB>
__device__ __forceinline__ int build_message(uint32_t* m, uint32_t cb, int w,
                                             const int* desc, int ngroups,
                                             const PieceTables& t) {
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
            for (int i = 0; i < nsel; ++i) {
                const int c = g[D_SEL + i];
                idx |= (int)((c < 32 ? (cb >> c) : 0u) & 1u) << i;
            }
            idx = min(idx, nvar - 1);
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
            const int q = o >> 2;
            const int sh = (o & 3) * 8;
            if (q < NW_DATA) m[q] |= wd << sh;
            if (sh != 0 && q + 1 < NW_DATA) m[q + 1] |= wd >> (32 - sh);
        }
        off += len_fixed >= 0
            ? len_fixed
            : t.gl[((size_t)w * t.ngd + g[D_GL]) * t.vm + idx];
    }
    return off - 1;
}

// Length words + chained compressions up to the lane's own padding block.
template <int HB>
__device__ __forceinline__ void hash_message(uint32_t* m, int end,
                                             uint32_t st[4]) {
    const uint32_t bits = (uint32_t)end * 8u;
#pragma unroll
    for (int k = 0; k < HB; ++k) {
        if (k + 1 == HB || end <= 64 * (k + 1) - 9) m[16 * k + 14] |= bits;
    }
    st[0] = 0x67452301u;
    st[1] = 0xefcdab89u;
    st[2] = 0x98badcfeu;
    st[3] = 0x10325476u;
#pragma unroll
    for (int k = 0; k < HB; ++k) {
        md5_compress(st, m + 16 * k);
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

__device__ __forceinline__ void store_state(int32_t* state, long long row,
                                            const uint32_t st[4]) {
    reinterpret_cast<int4*>(state)[row] =
        make_int4((int)st[0], (int)st[1], (int)st[2], (int)st[3]);
}

template <int HB>
__global__ void piece_md5_k1_kernel(
    const int32_t* __restrict__ blk_word,
    const int32_t* __restrict__ blk_count,
    const int32_t* __restrict__ blk_pbase, int nb, int stride,
    PieceTables t, const int32_t* __restrict__ desc, int ngroups,
    int min_sub, int max_sub, int32_t* __restrict__ state,
    uint8_t* __restrict__ emit) {
    __shared__ int sdesc[MAX_GROUPS * DESC_WIDTH];
    load_desc(sdesc, desc, ngroups);
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (long long)nb * stride) return;
    const int blk = (int)(lane / stride);
    const int r = (int)(lane - (long long)blk * stride);
    const int w = blk_word[blk];
    const uint32_t cb = (uint32_t)(blk_pbase[blk] + r);
    const int cc = __popc(cb);
    uint32_t m[16 * HB];
    const int end = build_message<HB>(m, cb, w, sdesc, ngroups, t);
    uint32_t st[4];
    hash_message<HB>(m, end, st);
    store_state(state, lane, st);
    emit[lane] = (r < blk_count[blk] && cc >= min_sub && cc <= max_sub);
}

// Pair tier: lane r of block b owns candidate ranks 2r and 2r + 1 of a
// block spanning 2 * stride ranks; the outputs land in rank order, row
// b * 2 * stride + 2r + p.  The schema's pair gate guarantees cb's bit 0
// (slot 0's chosen bit) is 0 on every emittable lane, so the partner is
// cb | 1 and differs only in the pair group's variant.
__global__ void piece_md5_pair_kernel(
    const int32_t* __restrict__ blk_word,
    const int32_t* __restrict__ blk_count,
    const int32_t* __restrict__ blk_pbase, int nb, int stride,
    PieceTables t, const int32_t* __restrict__ desc, int ngroups,
    int min_sub, int max_sub, int32_t* __restrict__ state,
    uint8_t* __restrict__ emit) {
    __shared__ int sdesc[MAX_GROUPS * DESC_WIDTH];
    load_desc(sdesc, desc, ngroups);
    const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= (long long)nb * stride) return;
    const int blk = (int)(lane / stride);
    const int r = (int)(lane - (long long)blk * stride);
    const int w = blk_word[blk];
    const int count = blk_count[blk];
    const uint32_t cb = (uint32_t)(blk_pbase[blk] + 2 * r);
    const int cc = __popc(cb);
    const long long row = 2 * lane;  // == b * 2 * stride + 2r
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        uint32_t m[16];
        const int end = build_message<1>(m, p ? (cb | 1u) : cb, w, sdesc,
                                         ngroups, t);
        uint32_t st[4];
        hash_message<1>(m, end, st);
        store_state(state, row + p, st);
        const int ccp = cc + p;
        emit[row + p] = (2 * r + p < count && ccp >= min_sub
                         && ccp <= max_sub);
    }
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

static const int kThreads = 256;

extern "C" {

// K=1 tier, 1-3 chained hash blocks.  Outputs state int32[nb*stride, 4]
// and emit uint8[nb*stride].  Returns cudaGetLastError() after the launch.
int a5_piece_md5_k1(const void* blk_word, const void* blk_count,
                    const void* blk_pbase, int nb, int stride,
                    const void* gw, const void* gw16, const void* gl,
                    int ngw, int ng16, int ngd, int vm, int nw,
                    const void* desc, int ngroups, int min_sub, int max_sub,
                    int hash_blocks, void* state, void* emit, void* stream) {
    if (ngroups < 0 || ngroups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
    const long long n = (long long)nb * stride;
    if (n == 0) return (int)cudaSuccess;
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const PieceTables t = make_tables(gw, gw16, gl, ngw, ng16, ngd, vm, nw);
    const int32_t* bw = static_cast<const int32_t*>(blk_word);
    const int32_t* bc = static_cast<const int32_t*>(blk_count);
    const int32_t* bp = static_cast<const int32_t*>(blk_pbase);
    const int32_t* d = static_cast<const int32_t*>(desc);
    int32_t* so = static_cast<int32_t*>(state);
    uint8_t* eo = static_cast<uint8_t*>(emit);
    switch (hash_blocks) {
        case 1:
            piece_md5_k1_kernel<1><<<grid, kThreads, 0, s>>>(
                bw, bc, bp, nb, stride, t, d, ngroups, min_sub, max_sub,
                so, eo);
            break;
        case 2:
            piece_md5_k1_kernel<2><<<grid, kThreads, 0, s>>>(
                bw, bc, bp, nb, stride, t, d, ngroups, min_sub, max_sub,
                so, eo);
            break;
        case 3:
            piece_md5_k1_kernel<3><<<grid, kThreads, 0, s>>>(
                bw, bc, bp, nb, stride, t, d, ngroups, min_sub, max_sub,
                so, eo);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Pair tier (one hash block).  Outputs state int32[2*nb*stride, 4] and
// emit uint8[2*nb*stride] in candidate-rank order.
int a5_piece_md5_pair(const void* blk_word, const void* blk_count,
                      const void* blk_pbase, int nb, int stride,
                      const void* gw, const void* gw16, const void* gl,
                      int ngw, int ng16, int ngd, int vm, int nw,
                      const void* desc, int ngroups, int min_sub,
                      int max_sub, void* state, void* emit, void* stream) {
    if (ngroups < 0 || ngroups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
    const long long n = (long long)nb * stride;
    if (n == 0) return (int)cudaSuccess;
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    piece_md5_pair_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blk_word),
        static_cast<const int32_t*>(blk_count),
        static_cast<const int32_t*>(blk_pbase), nb, stride,
        make_tables(gw, gw16, gl, ngw, ng16, ngd, vm, nw),
        static_cast<const int32_t*>(desc), ngroups, min_sub, max_sub,
        static_cast<int32_t*>(state), static_cast<uint8_t*>(emit));
    return (int)cudaGetLastError();
}

}  // extern "C"
