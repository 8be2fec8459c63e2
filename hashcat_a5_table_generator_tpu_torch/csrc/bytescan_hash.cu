// Byte-scan hash kernels for Hopper (sm_90a): decode + per-byte unit scan
// + hash of one candidate per live lane, for MD5, MD4, SHA-1 and NTLM —
// the tiers that run a plan which has no per-slot piece schema
// (overlapping static spans such as german's `ss` on a word with "sss",
// or every plan under A5GEN_EMIT=bytescan).
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
//               index (closure_index, hash_common.cuh) over the slot's
//               later successors.
// Per byte j < the word's length, a started byte emits its value (<= 4
// bytes), a covered byte nothing, any other byte its token; then the 0x80
// terminator, the length words and 1-3 chained compressions with each
// lane's state taken after its own padding block (hash_common.cuh).  NTLM
// places every byte as a UTF-16LE code unit.  emit = rank < count && min
// <= chosen count <= max && !clash.  Dead rows get emit 0 and no state
// (the reference's contract).
//
// What bounds it on the H100: integer throughput.  A compression costs
// ~320 INT32 instructions for MD5, ~176 for MD4/NTLM and ~608 for SHA-1;
// the unit scan adds ~10-20 per byte of the word and the decodes a
// multiply-high per slot (digits) or the DP walk (windowed).  Each word's
// row is read once per CTA from the resident tables, so bytes stay far
// below the operations; on the main path most rows are dead (german:
// 99% of its rows masked), and computing only live ones is the lever.
//
// Work layout, as the piece kernel's tile tiers (piece_hash.cu): a CTA
// owns G consecutive blocks, or one chunk of a block wider than
// SCAN_LANES, and runs SCAN_PHASES phases with a barrier between each
// (scan_phase):
//   0  the blocks' word, count and base into shared memory;
//   1  one thread numbers the distinct words and takes the prefix of the
//      lanes each block has below its count;
//   2  each distinct word's record is staged in shared memory once —
//      tokens, the per-byte fields (row 7: ins_bits / ownbit, startp /
//      isstart, value length and word; row 8: the slots starting at and
//      covering each byte, as bit masks, from match_pos / match_len; row
//      9: slotat / startat), the slot radices (and, for the digit decode,
//      their multiply-high reciprocals: radix_row), bit positions, option
//      words and lengths, the windowed suffix counts, the closure rows, and
//      the overlap masks ov[q] (row 7 bitmask: per bit, the ins_bits of
//      the bytes it covers, OR-ed; row 8: per slot, the slots whose spans
//      meet it inside the word) — and emit 0 is written for lanes past the
//      counts;
//   3  the threads walk the tile's lanes (block and rank by shift and mask
//      for a power-of-two stride, else by binary search over the prefix),
//      decode each lane's chosen bits and count, and decide emit before any
//      scan: clash = OR over chosen q of (cb & ov[q] & ~bit q) != 0, O(M)
//      not a byte scan; the live lanes are packed into a list (warp ballot
//      + popc prefix), the dead get emit 0;
//   4  the threads stride over the packed list — full warps — each
//      decoding again (digits into a shared-memory slab), scanning its
//      word's bytes and appending the units in byte order (tile_put: one
//      store per message word, no read-modify-write) to a message slab
//      [word][thread] in shared memory, then compressing it.
// Nothing is in local memory: the message and digits live in slabs, the
// word rows in the staged record, and the message is copied into
// registers for the compressions.
//
// One device body, templated on ALGO (one per library, -DPIECE_ALGO=n),
// the row, the row 7 variant, the decode, CLOSED and HB (hash blocks,
// 1-3).  The token width L stays a runtime argument up to 64.

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

#define SCAN_LANES 2048  // lanes a CTA takes at most (its live list)
#define SCAN_MAX_G 32
#define SCAN_RECORD_BYTES (24 * 1024)  // staged word records per CTA
#define SCAN_PHASES 5

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

// A CTA's shared-memory layout (offsets in int32 words) and the record
// layout of one staged word (offsets within the record; tok and svl are
// byte arrays).
struct ScanGeom {
    int g, c, lc, nt, rec, bm, shift;
    int r_dec, r_radix, r_wlen, r_tok, r_a, r_b, r_svl, r_svw, r_bitpos,
        r_winv, r_vopt, r_vlen, r_cnext, r_cmul, r_ov;
    int s_blk, s_rec, s_list, s_msg, s_dig;
    int smem_bytes;
};

// Plain C++: the host launch and the host test build both call it.
static inline ScanGeom scan_geometry(const ByteScanArgs& a, int row, int var,
                                     int decode, bool closed, int hb, int nt,
                                     int gmax, int lmax) {
    ScanGeom g;
    const bool scalar = row == ROW_SCALAR;
    const bool windowed = decode == DECODE_WINDOWED;
    const int tw = (a.L + 3) / 4;  // words of L bytes
    int o = 0;
    // The digit decode's slot rows (radix_row: 16-byte loads) first.
    g.r_dec = o;    o += !scalar && decode == DECODE_DIGITS ? 4 * a.m : 0;
    g.r_radix = o;  o += !scalar || windowed ? a.m : 0;
    g.r_wlen = o;   o += 1;
    g.r_tok = o;    o += tw;
    g.r_a = o;      o += scalar && var == VAR_SINGLE ? 0 : a.L;
    g.r_b = o;      o += a.L;
    g.r_svl = o;    o += scalar ? tw : 0;
    g.r_svw = o;    o += scalar ? a.L : 0;
    g.r_bitpos = o; o += scalar && windowed ? a.m : 0;
    g.r_winv = o;   o += windowed ? (a.m + 1) * a.k2 : 0;
    g.r_vopt = o;   o += scalar ? 0 : a.m * a.k_opts;
    g.r_vlen = o;   o += scalar ? 0 : a.m * a.k_opts;
    g.r_cnext = o;  o += closed ? a.m * a.close_s : 0;
    g.r_cmul = o;   o += closed ? a.m * (a.close_s + 1) : 0;
    g.r_ov = o;     o += row == ROW_MATCH ? a.m
                         : (scalar && var == VAR_BITMASK ? 32 : 0);
    g.rec = (o + 3) & ~3;
    const TileCut k = tile_cut(a.stride, SCAN_RECORD_BYTES / 4 / g.rec, gmax,
                               lmax);
    g.g = k.g;
    g.c = k.c;
    g.lc = k.lc;
    g.shift = k.shift;
    g.nt = nt;
    g.bm = !scalar && !windowed ? a.m : 1;
    // word, count, slot, distinct word [G] each; base [G * bm]; prefix
    // [G + 1]; then the distinct words and the live lanes.
    g.s_blk = 0;
    g.s_rec = (4 * g.g + g.g * g.bm + g.g + 1 + 2 + 3) & ~3;
    g.s_list = g.s_rec + g.g * g.rec;
    g.s_msg = (g.s_list + g.g * g.lc + 3) & ~3;
    g.s_dig = g.s_msg + 16 * hb * nt;
    g.smem_bytes = 4 * (g.s_dig + (scalar ? 0 : (a.m * nt + 3) / 4));
    return g;
}

// `_decode_tile_radix2`: radices <= 2 (K=1), so active slots' digits are
// successive bits of the rank added to the base digits with a binary
// carry; inactive (radix-1) slots decode 0 and pass the carry through.
// Equal to the mixed-radix decode for such radices, without its divides.
template <class Put>
__device__ __forceinline__ void radix2_walk(int r, const int32_t* base,
                                            const int32_t* radix, int m,
                                            Put&& put) {
    int carry = 0, nbits = 0;
    for (int q = 0; q < m; ++q) {
        if (radix[q] > 1) {
            const int t = base[q] + ((r >> nbits) & 1) + carry;
            put(q, t & 1);
            carry = t >> 1;
            ++nbits;
        } else {
            put(q, 0);
        }
    }
}

// A lane's decode from its word's record `rec` and its block's base:
// returns its chosen bits (row 7: the packed chosen vector; row 8: bit q
// for each chosen slot q) and sets its chosen count `cc`; rows 8 and 9
// give each slot's digit to `put(q, d)`.
template <int ROW, int DECODE, class Put>
__device__ __forceinline__ uint32_t scan_decode(const ByteScanArgs& a,
                                                const ScanGeom& g,
                                                const int32_t* rec,
                                                const int32_t* base, int r,
                                                int& cc, Put&& put) {
    const int32_t* radix = rec + g.r_radix;
    uint32_t cb = 0u;
    cc = 0;
    if (ROW == ROW_SCALAR) {
        if (DECODE == DECODE_WINDOWED) {
            const int32_t* bpos = rec + g.r_bitpos;
            windowed_walk(base[0] + r, rec + g.r_winv, radix, a.m, a.k2, 1,
                          [&](int q, int d) {
                cb |= (d > 0 ? 1u : 0u) << (bpos[q] & 31);
            });
        } else {
            cb = (uint32_t)(base[0] + r);
        }
        cc = __popc(cb);
        return cb;
    }
    auto take = [&](int q, int d) {
        if (ROW == ROW_MATCH) {
            cb |= (d > 0 ? 1u : 0u) << q;
        } else {
            cc += (radix[q] > 1 && d > 0) ? 1 : 0;
        }
        put(q, d);
    };
    if (DECODE == DECODE_WINDOWED) {
        windowed_walk(base[0] + r, rec + g.r_winv, radix, a.m, a.k2,
                      a.k_opts, take);
    } else if (DECODE == DECODE_RADIX2) {
        radix2_walk(r, base, radix, a.m, take);
    } else {
        digits_walk(r, base, reinterpret_cast<const int4*>(rec + g.r_dec),
                    a.m, take);
    }
    if (ROW == ROW_MATCH) cc = __popc(cb);
    return cb;
}

// The value of a chosen slot `q` with digit `d` (rows 8, 9): option d - 1
// of the slot's K-way select (K = 1: the slot's one option), or for a
// closed slot the row at its joint closure index; (0, 0) when the index
// lies outside the K options.
template <bool CLOSED, class Dig>
__device__ __forceinline__ void slot_value(const ByteScanArgs& a,
                                           const ScanGeom& g,
                                           const int32_t* rec, int q, int d,
                                           Dig dg, uint32_t& wd, int& len) {
    int k;
    bool ok;
    if (CLOSED) {
        k = closure_index(q, d, dg, a.m, rec + g.r_cnext + q * a.close_s,
                          rec + g.r_cmul + q * (a.close_s + 1), a.close_s);
        ok = d > 0 && k >= 0 && k < a.k_opts;
    } else if (a.k_opts == 1) {
        k = 0;
        ok = d > 0;
    } else {
        k = d - 1;
        ok = d >= 1 && d <= a.k_opts;
    }
    wd = ok ? (uint32_t)rec[g.r_vopt + q * a.k_opts + k] : 0u;
    len = ok ? rec[g.r_vlen + q * a.k_opts + k] : 0;
}

// Append a unit's low `len` bytes (0..4) to the message (NTLM: each byte
// as a code unit, the byte then 00).
template <int ALGO, int NW_DATA>
__device__ __forceinline__ void put_unit(const Slab<uint32_t>& m,
                                         MsgState& st, uint32_t wd,
                                         int len) {
    if (len <= 0) return;
    if (len < 4) wd &= (1u << (8 * len)) - 1u;
    if (ALGO == ALGO_NTLM) {
        tile_put<NW_DATA>(m, st, (wd & 0xFFu) | ((wd & 0xFF00u) << 8),
                          2 * min(len, 2));
        if (len > 2) {
            tile_put<NW_DATA>(m, st, ((wd >> 16) & 0xFFu) | ((wd >> 24) << 16),
                              2 * (len - 2));
        }
    } else {
        tile_put<NW_DATA>(m, st, wd, len);
    }
    st.off += len;
}

// One phase of a CTA (see above).
template <int ALGO, int ROW, int VAR, int DECODE, bool CLOSED, int HB>
__device__ __forceinline__ void scan_phase(int phase, const ByteScanArgs& a,
                                           const ScanGeom& g, int32_t* s) {
    constexpr int NW_DATA = 16 * HB - 2;
    constexpr bool CLASH = ROW == ROW_MATCH
        || (ROW == ROW_SCALAR && VAR == VAR_BITMASK);
    const int tid = threadIdx.x, nt = blockDim.x, G = g.g;
    int32_t* bw = s + g.s_blk;  // word of each block (-1 past nb)
    int32_t* bc = bw + G;       // count, clamped to the stride
    int32_t* bs = bc + G;       // distinct-word slot of each block
    int32_t* bu = bs + G;       // word of each slot
    int32_t* bb = bu + G;       // base [G * bm]: pbase / rank, or digits
    int32_t* bp = bb + G * g.bm;  // prefix of the lanes [G + 1]
    int32_t* misc = bp + G + 1;   // distinct words, live lanes
    const int grp = (int)blockIdx.x / g.c;
    const int lane0 = ((int)blockIdx.x - grp * g.c) * g.lc;
    const int lane1 = min(lane0 + g.lc, a.stride);
    const int blk0 = grp * G;
    if (phase == 0) {
        for (int i = tid; i < G; i += nt) {
            const bool in = blk0 + i < a.nb;
            bw[i] = in ? a.blk_word[blk0 + i] : -1;
            bc[i] = in ? min(max(a.blk_count[blk0 + i], 0), a.stride) : 0;
        }
        for (int i = tid; i < G * g.bm; i += nt) {
            bb[i] = blk0 + i / g.bm < a.nb
                ? a.blk_base[(size_t)blk0 * g.bm + i] : 0;
        }
    } else if (phase == 1) {
        if (tid == 0) {
            misc[0] = tile_words(bw, [&](int i) { return bc[i]; }, bs, bu,
                                 bp, G, lane0, lane1);
            misc[1] = 0;
        }
    } else if (phase == 2) {
        const int nu = misc[0], L = a.L, m = a.m;
        int32_t* recs = s + g.s_rec;
        for (int k = tid; k < nu * L; k += nt) {
            const int u = k / L, j = k - u * L, w = bu[u];
            int32_t* rec = recs + u * g.rec;
            const size_t wl = (size_t)w * L + j;
            reinterpret_cast<uint8_t*>(rec + g.r_tok)[j] = a.tokens[wl];
            if (ROW == ROW_SCALAR) {
                if (VAR != VAR_SINGLE) rec[g.r_a + j] = a.aj[wl];
                rec[g.r_b + j] = a.bj[wl];
                reinterpret_cast<uint8_t*>(rec + g.r_svl)[j] = a.svl[wl];
                rec[g.r_svw + j] = a.svw[wl];
            } else if (ROW == ROW_MATCH) {
                uint32_t cover = 0u, start = 0u;
                for (int q = 0; q < m; ++q) {
                    const int p = a.mpos[(size_t)w * m + q];
                    const int l = a.mlen[(size_t)w * m + q];
                    if (p == j) start |= 1u << q;
                    if (j >= p && j < p + l) cover |= 1u << q;
                }
                rec[g.r_a + j] = (int32_t)cover;
                rec[g.r_b + j] = (int32_t)start;
            } else {
                rec[g.r_a + j] = a.slotat[wl];
                rec[g.r_b + j] = a.startat[wl];
            }
        }
        for (int u = tid; u < nu; u += nt) {
            recs[u * g.rec + g.r_wlen] = a.lengths[bu[u]];
        }
        if (ROW != ROW_SCALAR || DECODE == DECODE_WINDOWED) {
            stage_rows(recs, g.rec, g.r_radix, a.radix, m, bu, nu);
        }
        if (ROW != ROW_SCALAR && DECODE == DECODE_DIGITS) {
            for (int k = tid; k < nu * m; k += nt) {
                const int u = k / m, q = k - u * m;
                reinterpret_cast<int4*>(recs + u * g.rec + g.r_dec)[q] =
                    radix_row(a.radix[(size_t)bu[u] * m + q]);
            }
        }
        if (ROW == ROW_SCALAR && DECODE == DECODE_WINDOWED) {
            stage_rows(recs, g.rec, g.r_bitpos, a.bitpos, m, bu, nu);
        }
        if (DECODE == DECODE_WINDOWED) {
            stage_rows(recs, g.rec, g.r_winv, a.win_v, (m + 1) * a.k2, bu,
                       nu);
        }
        if (ROW != ROW_SCALAR) {
            stage_rows(recs, g.rec, g.r_vopt, a.vopt, m * a.k_opts, bu, nu);
            stage_rows(recs, g.rec, g.r_vlen, a.vlen, m * a.k_opts, bu, nu);
        }
        if (CLOSED) {
            stage_rows(recs, g.rec, g.r_cnext, a.cnext, m * a.close_s, bu,
                       nu);
            stage_rows(recs, g.rec, g.r_cmul, a.cmul, m * (a.close_s + 1),
                       bu, nu);
        }
        if (ROW == ROW_MATCH) {
            // ov[q]: the slots whose spans meet slot q's inside the word
            // (the bytes j < length two chosen slots would both cover).
            for (int k = tid; k < nu * m; k += nt) {
                const int u = k / m, q = k - u * m, w = bu[u];
                const int wlen = a.lengths[w];
                const int* mp = a.mpos + (size_t)w * m;
                const int* ml = a.mlen + (size_t)w * m;
                uint32_t ov = 0u;
                for (int q2 = 0; q2 < m; ++q2) {
                    const int lo = max(max(mp[q], mp[q2]), 0);
                    const int hi = min(min(mp[q] + ml[q], mp[q2] + ml[q2]),
                                       wlen);
                    ov |= (lo < hi ? 1u : 0u) << q2;
                }
                recs[u * g.rec + g.r_ov + q] = (int32_t)ov;
            }
        } else if (ROW == ROW_SCALAR && VAR == VAR_BITMASK) {
            // ov[q]: the ins_bits of the bytes j < length bit q covers.
            for (int k = tid; k < nu * 32; k += nt) {
                const int u = k >> 5, q = k & 31, w = bu[u];
                const int wlen = min(a.lengths[w], L);
                uint32_t ov = 0u;
                for (int j = 0; j < wlen; ++j) {
                    const uint32_t x = (uint32_t)a.aj[(size_t)w * L + j];
                    ov |= (x >> q) & 1u ? x : 0u;
                }
                recs[u * g.rec + g.r_ov + q] = (int32_t)ov;
            }
        }
        for (int i = 0; g.shift < 0 && i < G && blk0 + i < a.nb; ++i) {
            const long long row0 = (long long)(blk0 + i) * a.stride;
            for (int r = max(bc[i], lane0) + tid; r < lane1; r += nt) {
                a.emit[row0 + r] = 0;
            }
        }
    } else if (phase == 3) {
        // Emit is decided here, before any byte scan: rank < count, the
        // window on the chosen count, and no clash.
        const bool shifted = g.shift >= 0;
        const int total = shifted ? min(G, a.nb - blk0) << g.shift : bp[G];
        int32_t* list = s + g.s_list;
        for (int base = 0; base < total; base += nt) {
            const int i = base + tid;
            bool live = false;
            int entry = 0;
            if (i < total) {
                const int lo = shifted ? i >> g.shift : tile_block(bp, G, i);
                const int rr = shifted ? i & (a.stride - 1) : i - bp[lo];
                const int r = lane0 + rr;
                entry = (lo << 16) | rr;
                live = r < bc[lo];
                if (live) {
                    const int32_t* rec = s + g.s_rec + bs[lo] * g.rec;
                    int cc;
                    const uint32_t cb = scan_decode<ROW, DECODE>(
                        a, g, rec, bb + lo * g.bm, r, cc, [](int, int) {});
                    live = cc >= a.min_sub && cc <= a.max_sub;
                    if (CLASH && live) {
                        const int32_t* ov = rec + g.r_ov;
                        for (uint32_t x = cb; x != 0u; x &= x - 1u) {
                            const int q = __ffs((int)x) - 1;
                            live &= (cb & (uint32_t)ov[q] & ~(1u << q)) == 0u;
                        }
                    }
                }
                if (!live) a.emit[(long long)(blk0 + lo) * a.stride + r] = 0;
            }
            pack_live(live, entry, &misc[1], list);
        }
    } else {
        const int n = misc[1];
        const int32_t* list = s + g.s_list;
        const Slab<uint32_t> msg{reinterpret_cast<uint32_t*>(s + g.s_msg)
                                 + tid, nt};
        const Slab<uint8_t> dig{reinterpret_cast<uint8_t*>(s + g.s_dig)
                                + tid, nt};
        for (int j = 0; j < 16 * HB; ++j) msg[j] = 0u;
        int hw = 0;  // slab words that may be non-zero
        for (int li = tid; li < n; li += nt) {
            const int entry = list[li];
            const int lo = entry >> 16;
            const int r = lane0 + (entry & 0xFFFF);
            const int32_t* rec = s + g.s_rec + bs[lo] * g.rec;
            const long long row = (long long)(blk0 + lo) * a.stride + r;
            int cc;
            const uint32_t cb = scan_decode<ROW, DECODE>(
                a, g, rec, bb + lo * g.bm, r, cc,
                [&](int q, int d) { dig[q] = (uint8_t)d; });
            const int wlen = rec[g.r_wlen];
            const uint8_t* tok = reinterpret_cast<const uint8_t*>(rec + g.r_tok);
            const uint8_t* svl = reinterpret_cast<const uint8_t*>(rec + g.r_svl);
            const int32_t* ra = rec + g.r_a;
            const int32_t* rb = rec + g.r_b;
            MsgState ms{0u, 0, 0, 0};
            for (int jb = 0; jb < wlen; ++jb) {
                bool started, covered;
                uint32_t wd = 0u;
                int len = 0;
                if (ROW == ROW_SCALAR) {
                    if (VAR == VAR_SUBALL) {
                        covered = (cb >> (ra[jb] & 31)) & 1u;
                        started = covered && rb[jb] > 0;
                    } else {
                        started = (cb >> (rb[jb] & 31)) & 1u;
                        covered = VAR == VAR_BITMASK
                            ? (cb & (uint32_t)ra[jb]) != 0u : started;
                    }
                    wd = (uint32_t)rec[g.r_svw + jb];
                    len = svl[jb];
                } else if (ROW == ROW_MATCH) {
                    const uint32_t st = (uint32_t)rb[jb] & cb;
                    started = st != 0u;
                    covered = ((uint32_t)ra[jb] & cb) != 0u;
                    if (started) {
                        const int q = 31 - __clz(st);  // the last slot here
                        slot_value<false>(a, g, rec, q, dig[q], dig, wd, len);
                    }
                } else {
                    const int q = ra[jb];
                    covered = q >= 0 && dig[q] > 0;
                    started = covered && rb[jb] == jb;
                    if (started) {
                        slot_value<CLOSED>(a, g, rec, q, dig[q], dig, wd,
                                           len);
                    }
                }
                if (started) {
                    put_unit<ALGO, NW_DATA>(msg, ms, wd, len);
                } else if (!covered) {
                    put_unit<ALGO, NW_DATA>(msg, ms, tok[jb], 1);
                }
            }
            tile_put<NW_DATA>(msg, ms, 0x80u, 1);  // the terminator
            const int nw = tile_end<NW_DATA>(msg, ms);
            // Words past this message's end keep zero for the next.
            for (int q = nw; q < hw; ++q) msg[q] = 0u;
            hw = nw;
            hash_slab<ALGO, HB>(msg, ms.off * Hash<ALGO>::SCALE, a.state,
                                row);
            a.emit[row] = 1;
        }
    }
}

template <int ALGO, int ROW, int VAR, int DECODE, bool CLOSED, int HB>
__global__ void __launch_bounds__(HB == 1 ? 256 : 128)
bytescan_kernel(ByteScanArgs a, ScanGeom g) {
    DYN_SMEM(smem);
    int32_t* s = reinterpret_cast<int32_t*>(smem);
#pragma unroll
    for (int p = 0; p < SCAN_PHASES; ++p) {
        if (p) __syncthreads();
        scan_phase<ALGO, ROW, VAR, DECODE, CLOSED, HB>(p, a, g, s);
    }
}

// ---- host launch wrappers ----

#ifndef PIECE_ALGO
#define PIECE_ALGO ALGO_MD5
#endif

// CTAs of SCAN_LANES lanes at most, 256 threads for one hash block, 128
// for two or three.  The largest record the launch checks admit (64 token
// bytes, 24 slots of 12 options, 10 DP columns, 3 successors: ~1,300
// words) fits SCAN_RECORD_BYTES, so G >= 1 block always fits.
template <int ROW, int VAR, int DECODE, bool CLOSED, int HB>
static int launch_hb(const ByteScanArgs& a, cudaStream_t s) {
    const int nt = HB == 1 ? 256 : 128;
    const ScanGeom g = scan_geometry(a, ROW, VAR, DECODE, CLOSED, HB, nt,
                                     SCAN_MAX_G, SCAN_LANES);
    auto kern = bytescan_kernel<PIECE_ALGO, ROW, VAR, DECODE, CLOSED, HB>;
    if (g.smem_bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const long long grid = (long long)((a.nb + g.g - 1) / g.g) * g.c;
    kern<<<(unsigned)grid, nt, g.smem_bytes, s>>>(a, g);
    return (int)cudaGetLastError();
}

template <int ROW, int VAR, int DECODE, bool CLOSED>
static int launch(const ByteScanArgs& a, int hash_blocks, void* stream) {
    if (a.nb == 0 || a.stride == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (hash_blocks) {
        case 1: return launch_hb<ROW, VAR, DECODE, CLOSED, 1>(a, s);
        case 2: return launch_hb<ROW, VAR, DECODE, CLOSED, 2>(a, s);
        default: return launch_hb<ROW, VAR, DECODE, CLOSED, 3>(a, s);
    }
}

// The bounds the staged record holds, and the tables every row reads.
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
