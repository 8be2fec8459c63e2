// Byte-scan hash kernels for Hopper (sm_90a): decode + per-byte unit scan
// + hash of one candidate per thread, for MD5, MD4, SHA-1 and NTLM — the
// tiers that run a plan which has no per-slot piece schema (overlapping
// static spans such as german's `ss` on a word with "sss", or every plan
// under A5GEN_EMIT=bytescan).
//
// Replaces three TPU kernel bodies of the reference package
// (hashcat_a5_table_generator_tpu/ops/pallas_expand.py, launched through
// `_launch_fused` / `pl.pallas_call` at :1961):
//   ROW_SCALAR  `_make_scalar_kernel` (:619; launch `_launch_scalar_units`
//               :751; callers :2183, :2570), the K=1 scalar-units tier:
//               the chosen-slot vector cb = pbase + rank (or the windowed
//               DP walk's chosen bits packed at bitpos[w, s]); per byte j
//               the variants
//                 VAR_SINGLE   match, every span one byte: started =
//                              bit startp[j] of cb, coverage = start;
//                 VAR_BITMASK  match: ab = cb & ins_bits[j], coverage =
//                              ab != 0, clash = ab has two bits (:699-701),
//                              started = bit startp[j];
//                 VAR_SUBALL   substitute-all: chosen = bit ownbit[j],
//                              started = chosen && isstart[j];
//   ROW_MATCH   `_make_kernel` (:1758, caller :2194-2211), match plans off
//               the scalar tier: radix-2 (`_decode_tile_radix2` :380),
//               mixed-radix (`_decode_tile` :773) or windowed
//               (`_decode_tile_windowed` :333) digits, the K-way value
//               select, per byte the cover count over the chosen slots,
//               clash = cover > 1 (:1848);
//   ROW_SUBALL  `_make_suball_kernel` (:2214, caller :2582-2603),
//               substitute-all plans off the scalar tier: the pattern slot
//               owning byte j (slotat) and its span start (startat); the
//               first byte of a chosen segment emits the value, its other
//               bytes nothing; CLOSED: the value row is the joint closure
//               index (d - 1) * cmul[s, 0] + sum_i d[cnext[s, i]] *
//               cmul[s, 1 + i] over the slot's later successors.
// Per byte j < the word's length, a started byte emits its value (<= 4
// bytes), a covered byte nothing, any other byte its token; then the 0x80
// terminator, the length words and 1-3 chained compressions with each
// lane's state taken after its own padding block (hash_common.cuh).  NTLM
// places every byte as a UTF-16LE code unit at doubled offsets.  emit =
// rank < count && min <= chosen count <= max && !clash.  Non-emitted lanes
// may hold any state (the reference's contract); their bytes never land
// outside their own message.
//
// Work layout: one CTA per block, so one word per CTA.  The CTA stages its
// word's row into shared memory once — tokens, the per-byte fields (row 7:
// ins_bits / ownbit, startp / isstart, value length and word; row 8: the
// start and coverage slot masks, computed here from match_pos / match_len;
// row 9: slotat / startat), the slot radices, bit positions, option words
// and lengths, the windowed suffix counts and the closure tables — and
// each thread runs one in-block rank (looping when the stride exceeds the
// CTA).  Row 8 tests a byte against bit masks of the slots starting at and
// covering it (M <= 24 slots fit one word), so a byte costs O(1), not
// O(M).
//
// What bounds it on the H100: integer throughput.  A compression costs
// ~320 INT32 instructions for MD5, ~176 for MD4/NTLM and ~608 for SHA-1;
// the unit scan adds ~10-20 per byte of the word (the placement of a unit
// into the local-memory message is the largest part), and the decodes one
// divide per slot (digits) or the DP walk (windowed).  The word's row is
// read once per CTA from the resident tables (L2), so bytes stay far below
// the operations.
//
// Simple first: no wgmma/TMA; the message (uint32_t[16 * HB]) and the
// digit vector (int[24]) are indexed by data-dependent offsets and slots,
// so they live in local memory (`-Xptxas -v` reports the stack frame).
//
// One device body per row, templated on ALGO (one per library,
// -DPIECE_ALGO=n), the row 7 variant or the row 8/9 decode, CLOSED and HB
// (hash blocks, 1-3).  The token width L stays a runtime argument up to 64.

#include "hash_common.cuh"

#define ROW_SCALAR 0
#define ROW_MATCH 1
#define ROW_SUBALL 2

#define VAR_SINGLE 0
#define VAR_BITMASK 1
#define VAR_SUBALL 2

// Row 8/9 decodes (DECODE_DIGITS / DECODE_WINDOWED from hash_common.cuh).
#define DECODE_RADIX2 3

#define MAX_TOKENS 64
#define MAX_OPTIONS 12
#define MAX_WIN_K2 10
#define MAX_SUCC 3

// Everything one launch reads.  Per-word tables are indexed by the
// block's word; u8 tables hold per-byte fields that fit a byte.
struct ByteScanArgs {
    const int32_t* blk_word;   // [NB]
    const int32_t* blk_count;  // [NB] candidates in each block
    const int32_t* blk_base;   // [NB] pbase / windowed rank, or [NB, M]
    int nb, stride;
    const uint8_t* tokens;     // [B, L]
    const int32_t* lengths;    // [B]
    int L;
    const int32_t* radix;      // [B, M]
    int m;
    const int32_t* win_v;      // [B, M+1, K2] (windowed)
    int k2, k_opts;
    // Row 7.
    const int32_t* bitpos;     // [B, M] (windowed)
    const int32_t* aj;         // [B, L] ins_bits (bitmask) / ownbit
    const uint8_t* bj;         // [B, L] startp (match) / isstart (suball)
    const uint8_t* svl;        // [B, L] value length of the span at j
    const int32_t* svw;        // [B, L] value word of the span at j
    // Row 8.
    const int32_t* mpos;       // [B, M]
    const int32_t* mlen;       // [B, M]
    // Row 9.
    const int32_t* slotat;     // [B, L] pattern slot owning byte j, -1
    const int32_t* startat;    // [B, L] its span start
    const int32_t* cnext;      // [B, M, S] successor slots (-1 none)
    const int32_t* cmul;       // [B, M, S+1] joint index multipliers
    int close_s;
    // Rows 8 and 9.
    const int32_t* vopt;       // [B, M, K] option words (u32 bits)
    const int32_t* vlen;       // [B, M, K] option lengths
    int min_sub, max_sub;
    int32_t* state;            // [rows, state words]
    uint8_t* emit;             // [rows]
};

// One word's row, staged in shared memory by its CTA.
struct WordRow {
    uint8_t tok[MAX_TOKENS];
    uint32_t a[MAX_TOKENS];    // row 7: aj; row 8: cover mask; row 9: slotat
    uint32_t b[MAX_TOKENS];    // row 7: bj; row 8: start mask; row 9: startat
    uint8_t svl[MAX_TOKENS];
    uint32_t svw[MAX_TOKENS];
    int32_t radix[MAX_SLOTS];
    int32_t bitpos[MAX_SLOTS];
    uint32_t vopt[MAX_SLOTS * MAX_OPTIONS];
    int32_t vlen[MAX_SLOTS * MAX_OPTIONS];
    int32_t winv[(MAX_SLOTS + 1) * MAX_WIN_K2];
    int32_t cnext[MAX_SLOTS * MAX_SUCC];
    int32_t cmul[MAX_SLOTS * (MAX_SUCC + 1)];
    int wlen;
};

template <int ROW, int VAR, int DECODE, bool CLOSED>
__device__ __forceinline__ void stage_row(WordRow& s, const ByteScanArgs& a,
                                          int w) {
    const int t = threadIdx.x, n = blockDim.x;
    const size_t wl = (size_t)w * a.L;
    if (t == 0) s.wlen = a.lengths[w];
    for (int j = t; j < a.L; j += n) {
        s.tok[j] = a.tokens[wl + j];
        if (ROW == ROW_SCALAR) {
            s.a[j] = VAR == VAR_SINGLE ? 0u : (uint32_t)a.aj[wl + j];
            s.b[j] = a.bj[wl + j];
            s.svl[j] = a.svl[wl + j];
            s.svw[j] = (uint32_t)a.svw[wl + j];
        } else if (ROW == ROW_MATCH) {
            uint32_t cover = 0u, start = 0u;
            for (int q = 0; q < a.m; ++q) {
                const int p = a.mpos[(size_t)w * a.m + q];
                const int l = a.mlen[(size_t)w * a.m + q];
                if (p == j) start |= 1u << q;
                if (j >= p && j < p + l) cover |= 1u << q;
            }
            s.a[j] = cover;
            s.b[j] = start;
        } else {
            s.a[j] = (uint32_t)a.slotat[wl + j];
            s.b[j] = (uint32_t)a.startat[wl + j];
        }
    }
    const bool slots = ROW != ROW_SCALAR || DECODE == DECODE_WINDOWED;
    for (int q = t; slots && q < a.m; q += n) {
        s.radix[q] = a.radix[(size_t)w * a.m + q];
        if (ROW == ROW_SCALAR) s.bitpos[q] = a.bitpos[(size_t)w * a.m + q];
    }
    if (ROW != ROW_SCALAR) {
        const int nv = a.m * a.k_opts;
        for (int i = t; i < nv; i += n) {
            s.vopt[i] = (uint32_t)a.vopt[(size_t)w * nv + i];
            s.vlen[i] = a.vlen[(size_t)w * nv + i];
        }
    }
    if (DECODE == DECODE_WINDOWED) {
        const int nw = (a.m + 1) * a.k2;
        for (int i = t; i < nw; i += n) s.winv[i] = a.win_v[(size_t)w * nw + i];
    }
    if (CLOSED) {
        const int ns = a.m * a.close_s, nm = a.m * (a.close_s + 1);
        for (int i = t; i < ns; i += n) s.cnext[i] = a.cnext[(size_t)w * ns + i];
        for (int i = t; i < nm; i += n) s.cmul[i] = a.cmul[(size_t)w * nm + i];
    }
    __syncthreads();
}

// `_decode_tile_radix2`: radices <= 2 (K=1), so active slots' digits are
// successive bits of the rank added to the base digits with a binary
// carry; inactive (radix-1) slots decode 0 and pass the carry through.
// Equal to decode_digits for such radices, without its divides.
__device__ __forceinline__ void decode_radix2(int* dg, int r,
                                              const int32_t* base,
                                              const int32_t* radix, int m) {
    int carry = 0, nbits = 0;
    for (int q = 0; q < m; ++q) {
        if (radix[q] > 1) {
            const int t = base[q] + ((r >> nbits) & 1) + carry;
            dg[q] = t & 1;
            carry = t >> 1;
            ++nbits;
        } else {
            dg[q] = 0;
        }
    }
}

// The value of a chosen slot `q` with digit `d` (rows 8, 9): option d - 1
// of the slot's K-way select (K = 1: the slot's one option), or for a
// closed slot the row at its joint closure index; (0, 0) when the index
// lies outside the K options.
template <bool CLOSED>
__device__ __forceinline__ void slot_value(const WordRow& s, int q, int d,
                                           const int* dg, int m, int k_opts,
                                           int close_s, uint32_t& wd,
                                           int& len) {
    int k;
    bool ok;
    if (CLOSED) {
        k = (d - 1) * s.cmul[q * (close_s + 1)];
        for (int i = 0; i < close_s; ++i) {
            const int nt = s.cnext[q * close_s + i];
            if (nt > q && nt < m) k += dg[nt] * s.cmul[q * (close_s + 1) + 1 + i];
        }
        ok = d > 0 && k >= 0 && k < k_opts;
    } else if (k_opts == 1) {
        k = 0;
        ok = d > 0;
    } else {
        k = d - 1;
        ok = d >= 1 && d <= k_opts;
    }
    wd = ok ? s.vopt[q * k_opts + k] : 0u;
    len = ok ? s.vlen[q * k_opts + k] : 0;
}

// OR a unit's low `len` bytes (0..4) into the message at candidate offset
// `off` (NTLM: each byte as a code unit at twice the offset).
template <int ALGO, int NW_DATA>
__device__ __forceinline__ void put_unit(uint32_t* m, int off, uint32_t wd,
                                         int len) {
    if (len <= 0) return;
    if (len < 4) wd &= (1u << (8 * len)) - 1u;
    if (ALGO == ALGO_NTLM) {
        place<NW_DATA>(m, 2 * off, (wd & 0xFFu) | ((wd & 0xFF00u) << 8));
        if (len > 2) {
            place<NW_DATA>(m, 2 * off + 4,
                           ((wd >> 16) & 0xFFu) | ((wd >> 24) << 16));
        }
    } else {
        place<NW_DATA>(m, off, wd);
    }
}

template <int ALGO, int ROW, int VAR, int DECODE, bool CLOSED, int HB>
__global__ void bytescan_kernel(ByteScanArgs a) {
    constexpr int NW_DATA = 16 * HB - 2;
    constexpr int SCALE = Hash<ALGO>::SCALE;
    __shared__ WordRow s;
    const int blk = blockIdx.x;
    const int w = a.blk_word[blk];
    stage_row<ROW, VAR, DECODE, CLOSED>(s, a, w);
    const int count = a.blk_count[blk];
    const int wlen = s.wlen;
    for (int r = threadIdx.x; r < a.stride; r += blockDim.x) {
        const long long lane = (long long)blk * a.stride + r;
        int dg[MAX_SLOTS];
        uint32_t cb = 0u;  // row 7: chosen bits; row 8: chosen slots
        int cc = 0;
        if (ROW == ROW_SCALAR) {
            if (DECODE == DECODE_WINDOWED) {
                decode_windowed(dg, a.blk_base[blk] + r, s.winv, s.radix,
                                a.m, a.k2, 1);
                for (int q = 0; q < a.m; ++q) {
                    cb |= (dg[q] > 0 ? 1u : 0u) << (s.bitpos[q] & 31);
                }
            } else {
                cb = (uint32_t)(a.blk_base[blk] + r);
            }
            cc = __popc(cb);
        } else {
            const int32_t* base = a.blk_base + (size_t)blk * a.m;
            if (DECODE == DECODE_WINDOWED) {
                decode_windowed(dg, a.blk_base[blk] + r, s.winv, s.radix,
                                a.m, a.k2, a.k_opts);
            } else if (DECODE == DECODE_RADIX2) {
                decode_radix2(dg, r, base, s.radix, a.m);
            } else {
                decode_digits(dg, r, base, s.radix, a.m);
            }
            for (int q = 0; q < a.m; ++q) {
                if (ROW == ROW_MATCH) {
                    cb |= (dg[q] > 0 ? 1u : 0u) << q;
                } else {
                    cc += (s.radix[q] > 1 && dg[q] > 0) ? 1 : 0;
                }
            }
            if (ROW == ROW_MATCH) cc = __popc(cb);
        }
        uint32_t m[16 * HB];
#pragma unroll
        for (int i = 0; i < 16 * HB; ++i) m[i] = 0u;
        bool clash = false;
        int off = 0;
        for (int j = 0; j < wlen; ++j) {
            bool started, covered;
            uint32_t wd = 0u;
            int len = 0;
            if (ROW == ROW_SCALAR) {
                if (VAR == VAR_SUBALL) {
                    covered = (cb >> (s.a[j] & 31)) & 1u;
                    started = covered && s.b[j] > 0;
                } else {
                    started = (cb >> (s.b[j] & 31)) & 1u;
                    covered = started;
                    if (VAR == VAR_BITMASK) {
                        const uint32_t ab = cb & s.a[j];
                        covered = ab != 0u;
                        clash |= (ab & (ab - 1u)) != 0u;
                    }
                }
                wd = s.svw[j];
                len = s.svl[j];
            } else if (ROW == ROW_MATCH) {
                const uint32_t st = s.b[j] & cb;
                const uint32_t cv = s.a[j] & cb;
                clash |= (cv & (cv - 1u)) != 0u;
                started = st != 0u;
                covered = cv != 0u;
                if (started) {
                    const int q = 31 - __clz(st);  // the last slot starting here
                    slot_value<false>(s, q, dg[q], dg, a.m, a.k_opts, 0, wd,
                                      len);
                }
            } else {
                const int q = (int)s.a[j];
                covered = q >= 0 && dg[q] > 0;
                started = covered && (int)s.b[j] == j;
                if (started) {
                    slot_value<CLOSED>(s, q, dg[q], dg, a.m, a.k_opts,
                                       a.close_s, wd, len);
                }
            }
            if (started) {
                put_unit<ALGO, NW_DATA>(m, off, wd, len);
                off += len;
            } else if (!covered) {
                put_unit<ALGO, NW_DATA>(m, off, s.tok[j], 1);
                off += 1;
            }
        }
        place<NW_DATA>(m, off * SCALE, 0x80u);
        uint32_t st[Hash<ALGO>::WORDS];
        hash_message<ALGO, HB>(m, off * SCALE, st);
        store_state<ALGO>(a.state, lane, st);
        a.emit[lane] = (r < count && cc >= a.min_sub && cc <= a.max_sub
                        && !clash);
    }
}

// ---- host launch wrappers ----

#ifndef PIECE_ALGO
#define PIECE_ALGO ALGO_MD5
#endif

// Threads per CTA: one per in-block rank, up to 128 (a CTA is one block).
static unsigned cta_threads(int stride) {
    const int t = ((stride + 31) / 32) * 32;
    return (unsigned)(t < 128 ? t : 128);
}

template <int ROW, int VAR, int DECODE, bool CLOSED>
static int launch(const ByteScanArgs& a, int hash_blocks, void* stream) {
    if (a.nb == 0 || a.stride == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned grid = (unsigned)a.nb, threads = cta_threads(a.stride);
    switch (hash_blocks) {
        case 1:
            bytescan_kernel<PIECE_ALGO, ROW, VAR, DECODE, CLOSED, 1>
                <<<grid, threads, 0, s>>>(a);
            break;
        case 2:
            bytescan_kernel<PIECE_ALGO, ROW, VAR, DECODE, CLOSED, 2>
                <<<grid, threads, 0, s>>>(a);
            break;
        default:
            bytescan_kernel<PIECE_ALGO, ROW, VAR, DECODE, CLOSED, 3>
                <<<grid, threads, 0, s>>>(a);
            break;
    }
    return (int)cudaGetLastError();
}

// The bounds the shared-memory row holds, and the tables every row reads.
static int common_checks(const ByteScanArgs& a, int hash_blocks,
                         bool windowed) {
    if (hash_blocks < 1 || hash_blocks > 3) return 1;
    if (a.L < 1 || a.L > MAX_TOKENS || a.m < 0 || a.m > MAX_SLOTS) return 1;
    if (a.nb < 0 || a.stride < 0) return 1;
    if (!a.blk_word || !a.blk_count || !a.blk_base || !a.tokens
        || !a.lengths || !a.state || !a.emit) {
        return 1;
    }
    if (windowed && (!a.win_v || !a.radix || a.k2 < 1 || a.k2 > MAX_WIN_K2)) {
        return 1;
    }
    return 0;
}

// Rows 8/9: slot tables and option words.
static int slot_checks(const ByteScanArgs& a) {
    if (a.m < 1 || !a.radix || !a.vopt || !a.vlen) return 1;
    if (a.k_opts < 1 || a.k_opts > MAX_OPTIONS) return 1;
    return 0;
}

#define BYTESCAN_PARAMS                                                      \
    const void *blk_word, const void *blk_count, const void *blk_base,       \
        int nb, int stride, const void *tokens, const void *lengths, int L,  \
        const void *radix, int m, const void *win_v, int k2, int k_opts,     \
        const void *bitpos, const void *aj, const void *bj, const void *svl, \
        const void *svw, const void *mpos, const void *mlen,                 \
        const void *slotat, const void *startat, const void *cnext,          \
        const void *cmul, int close_s, const void *vopt, const void *vlen,   \
        int variant, int decode, int closed, int min_sub, int max_sub,       \
        int hash_blocks, void *state, void *emit, void *stream

static ByteScanArgs make_args(BYTESCAN_PARAMS) {
    (void)variant;
    (void)decode;
    (void)closed;
    (void)hash_blocks;
    (void)stream;
    ByteScanArgs a;
    a.blk_word = static_cast<const int32_t*>(blk_word);
    a.blk_count = static_cast<const int32_t*>(blk_count);
    a.blk_base = static_cast<const int32_t*>(blk_base);
    a.nb = nb;
    a.stride = stride;
    a.tokens = static_cast<const uint8_t*>(tokens);
    a.lengths = static_cast<const int32_t*>(lengths);
    a.L = L;
    a.radix = static_cast<const int32_t*>(radix);
    a.m = m;
    a.win_v = static_cast<const int32_t*>(win_v);
    a.k2 = k2;
    a.k_opts = k_opts;
    a.bitpos = static_cast<const int32_t*>(bitpos);
    a.aj = static_cast<const int32_t*>(aj);
    a.bj = static_cast<const uint8_t*>(bj);
    a.svl = static_cast<const uint8_t*>(svl);
    a.svw = static_cast<const int32_t*>(svw);
    a.mpos = static_cast<const int32_t*>(mpos);
    a.mlen = static_cast<const int32_t*>(mlen);
    a.slotat = static_cast<const int32_t*>(slotat);
    a.startat = static_cast<const int32_t*>(startat);
    a.cnext = static_cast<const int32_t*>(cnext);
    a.cmul = static_cast<const int32_t*>(cmul);
    a.close_s = close_s;
    a.vopt = static_cast<const int32_t*>(vopt);
    a.vlen = static_cast<const int32_t*>(vlen);
    a.min_sub = min_sub;
    a.max_sub = max_sub;
    a.state = static_cast<int32_t*>(state);
    a.emit = static_cast<uint8_t*>(emit);
    return a;
}

#define BYTESCAN_ARGS                                                        \
    blk_word, blk_count, blk_base, nb, stride, tokens, lengths, L, radix, m, \
        win_v, k2, k_opts, bitpos, aj, bj, svl, svw, mpos, mlen, slotat,     \
        startat, cnext, cmul, close_s, vopt, vlen, variant, decode, closed,  \
        min_sub, max_sub, hash_blocks, state, emit, stream

// Every entry point takes the same arguments (ops/bytescan.py builds one
// list): the block fields, the word tables, the row 7 per-byte fields, the
// row 8 match geometry, the row 9 ownership and closure tables, the option
// words, the row 7 variant (0 single, 1 bitmask, 2 suball), the decode
// (0 scalar, 1 digits, 2 windowed, 3 radix2), the closure flag, the
// window, the hash-block count, the outputs (state int32[rows, 4|5],
// emit uint8[rows]) and the stream.  Unused tables may be null.  Each
// returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for arguments it refuses.
extern "C" {

// Row 7: the K=1 scalar-units tier, full enumeration (decode 0, cb =
// pbase + rank) or windowed (decode 2, cb packed at bitpos).
int a5_bytescan_scalar(BYTESCAN_PARAMS) {
    const ByteScanArgs a = make_args(BYTESCAN_ARGS);
    const bool win = decode == DECODE_WINDOWED;
    if (common_checks(a, hash_blocks, win) || closed
        || (decode != DECODE_SCALAR && !win)
        || (win && (!a.bitpos || a.m < 1))
        || !a.bj || !a.svl || !a.svw
        || (variant != VAR_SINGLE && !a.aj)) {
        return (int)cudaErrorInvalidValue;
    }
    switch (variant * 2 + (win ? 1 : 0)) {
        case 0: return launch<ROW_SCALAR, VAR_SINGLE, DECODE_SCALAR, false>(a, hash_blocks, stream);
        case 1: return launch<ROW_SCALAR, VAR_SINGLE, DECODE_WINDOWED, false>(a, hash_blocks, stream);
        case 2: return launch<ROW_SCALAR, VAR_BITMASK, DECODE_SCALAR, false>(a, hash_blocks, stream);
        case 3: return launch<ROW_SCALAR, VAR_BITMASK, DECODE_WINDOWED, false>(a, hash_blocks, stream);
        case 4: return launch<ROW_SCALAR, VAR_SUBALL, DECODE_SCALAR, false>(a, hash_blocks, stream);
        case 5: return launch<ROW_SCALAR, VAR_SUBALL, DECODE_WINDOWED, false>(a, hash_blocks, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Row 8: match plans, radix-2 (decode 3), digit (1) or windowed (2) decode.
int a5_bytescan_match(BYTESCAN_PARAMS) {
    const ByteScanArgs a = make_args(BYTESCAN_ARGS);
    if (common_checks(a, hash_blocks, decode == DECODE_WINDOWED)
        || slot_checks(a) || closed || !a.mpos || !a.mlen) {
        return (int)cudaErrorInvalidValue;
    }
    switch (decode) {
        case DECODE_RADIX2: return launch<ROW_MATCH, 0, DECODE_RADIX2, false>(a, hash_blocks, stream);
        case DECODE_DIGITS: return launch<ROW_MATCH, 0, DECODE_DIGITS, false>(a, hash_blocks, stream);
        case DECODE_WINDOWED: return launch<ROW_MATCH, 0, DECODE_WINDOWED, false>(a, hash_blocks, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// Row 9: substitute-all plans, radix-2 / digit / windowed decode, the
// cascade closure when `closed`.
int a5_bytescan_suball(BYTESCAN_PARAMS) {
    const ByteScanArgs a = make_args(BYTESCAN_ARGS);
    if (common_checks(a, hash_blocks, decode == DECODE_WINDOWED)
        || slot_checks(a) || !a.slotat || !a.startat
        || (closed && (!a.cnext || !a.cmul || a.close_s < 1
                       || a.close_s > MAX_SUCC))) {
        return (int)cudaErrorInvalidValue;
    }
    switch (decode * 2 + (closed ? 1 : 0)) {
        case DECODE_DIGITS * 2: return launch<ROW_SUBALL, 0, DECODE_DIGITS, false>(a, hash_blocks, stream);
        case DECODE_DIGITS * 2 + 1: return launch<ROW_SUBALL, 0, DECODE_DIGITS, true>(a, hash_blocks, stream);
        case DECODE_WINDOWED * 2: return launch<ROW_SUBALL, 0, DECODE_WINDOWED, false>(a, hash_blocks, stream);
        case DECODE_WINDOWED * 2 + 1: return launch<ROW_SUBALL, 0, DECODE_WINDOWED, true>(a, hash_blocks, stream);
        case DECODE_RADIX2 * 2: return launch<ROW_SUBALL, 0, DECODE_RADIX2, false>(a, hash_blocks, stream);
        case DECODE_RADIX2 * 2 + 1: return launch<ROW_SUBALL, 0, DECODE_RADIX2, true>(a, hash_blocks, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
