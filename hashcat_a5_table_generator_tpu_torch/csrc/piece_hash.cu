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
// and, per hash, the NTLM code-unit split of `split_pieces`
// (:1601-1629); the rounds, the decodes, the length words and the
// per-lane padding-block select come from hash_common.cuh, shared with
// the byte-scan kernels (bytescan_hash.cu).  The pair tier (pair=True,
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
//            variant's pre-masked word(s), appended to the message at the
//            lane's running byte offset; the offset advances by the
//            group's placed length.  The tail group carries the 0x80
//            terminator, so the candidate is `off - 1` bytes.  NTLM places
//            each byte as a UTF-16LE code unit (the byte, then 00) at
//            doubled offsets: a u32 piece becomes two code-unit words.
//   hash     The bit length goes to the lane's own padding block k (word
//            16k+14; SHA-1: byte-swapped into word 16k+15); the lane
//            compresses blocks 0..k and outputs the state after block k.
// Non-emitted lanes may hold garbage state, or none (the reference's
// contract); their bytes never land outside their own message.
//
// What bounds it on the H100: integer throughput.  Per candidate one
// compression costs ~320 INT32 instructions for MD5, ~176 for MD4/NTLM and
// ~608 for SHA-1 (chip_smoke.py derives the counts), against 17-21 output
// bytes and a few table words read through L1/L2, so every instantiation
// sits far on the operations side of the roofline.  Around the
// compression each candidate pays its decode (a multiply-high per slot
// for the digits, the DP walk for the windowed tier) and its splice (per
// group: the descriptor, the variant index, the table word, the append),
// and those instructions, not the bytes, are what keep a launch above its
// bound.
//
// What this design does about it: pieces appended in order (`append`,
// `tile_put`: one store per message word, no read-modify-write); rotates
// as funnel shifts, round functions in their 3-input forms.  Every tier
// computes live lanes only, packed into full warps, stages its words'
// tables in shared memory once a CTA and keeps the message (and digits)
// there, out of local memory: piece_tile_kernel for the scalar and digit
// decodes at K=1 (the closure included) and the pair tier,
// piece_windowed_kernel for the count-windowed decode.  The scalar tiers
// also merge neighbouring bit-field groups into one (fewer splice steps a
// candidate), the pair tier splices both candidates in one walk, and the
// digit decode divides by a staged reciprocal (radix_row) instead of a
// runtime divide.
//
// Shifts by 32 are undefined in C++ and CUDA: placement shifts only by
// 8..24 when the spill word is written, and the scalar selectors test the
// bit position (a match column, or a suball column's sel_bit) against 32
// before shifting.
//
// Types: torch tensors are int32; the kernel reinterprets them as
// uint32_t.  `gw16` and `gl` arrive widened to int32.

#include "hash_common.cuh"

#define KIND_MATCH 0
#define KIND_SUBALL 1

#define DESC_WIDTH 16
#define MAX_GROUPS 256
#define MAX_SEL 4

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

// ---------------------------------------------------------------------------
// Splice + hash
// ---------------------------------------------------------------------------

// The variant a digit-decoded column selects (0 = the span's own bytes):
// match plans, its slot's digit; suball plans, the digit of the pattern
// slot that owns the occurrence — or, for a chosen slot of a closed plan,
// 1 + its joint closure index (closure_index) over its successor slots.
template <int KIND, bool CLOSED, class Dig>
__device__ __forceinline__ int col_variant(int c, Dig dg, const SelRows& sr) {
    if (KIND == KIND_MATCH) return dg[c];
    const int sl = sr.sel_slot[c];
    const int d = (unsigned)sl < (unsigned)sr.m ? dg[sl] : 0;
    if (!CLOSED || d <= 0) return d;
    return 1 + closure_index(sl, d, dg, sr.m, sr.cnext + sl * sr.close_s,
                             sr.cmul + sl * (sr.close_s + 1), sr.close_s);
}

// Append `cnt` bytes of `x` (its bytes past `cnt` must be zero or be
// OR-ed over by later bytes, as a pre-masked piece word's are) to the
// message being written in order: bytes collect in `acc` and each full
// word is stored once at m[widx], past the data area dropped.
template <int NW_DATA, class Msg>
__device__ __forceinline__ void append(Msg m, uint64_t& acc, int& nacc,
                                       int& widx, uint32_t x, int cnt) {
    acc |= (uint64_t)x << (8 * nacc);
    nacc += cnt;
    if (nacc >= 4) {
        if (widx < NW_DATA) m[widx] = (uint32_t)acc;
        ++widx;
        acc >>= 32;
        nacc -= 4;
    }
}

// Splice one candidate's bytes (terminator included) into m[0..16*HB) and
// return its length in bytes.  CB: variant indices are bit-fields of the
// packed chosen vector `cb` (a match column c is bit c; a suball column
// bit sel_bit[c], 31 on padding columns, which no cb sets); otherwise they
// come from the digit vector `dg` (one column: its variant clamped to the
// group's rows; merged binary columns: their chosen bits).  `Msg` and
// `Dig` are shared-memory slabs (Slab); `dg` is unused under CB.  Groups
// follow each other in emission order, so the bytes are appended
// (append): one store per message word, no read-modify-write.  Words
// from `*nw` on are left alone (the reader zeroes them).
template <int ALGO, int HB, int KIND, bool CB, bool CLOSED, class Msg,
          class Dig>
__device__ __forceinline__ int build_message(Msg m, uint32_t cb, Dig dg,
                                             int w, const int* desc,
                                             int ngroups,
                                             const PieceTables& t,
                                             const SelRows& sr,
                                             int* nw) {
    constexpr int NW_DATA = 16 * HB - 2;
    uint64_t acc = 0u;
    int nacc = 0, widx = 0, off = 0;
    for (int gi = 0; gi < ngroups; ++gi) {
        const int* g = desc + gi * DESC_WIDTH;
        const int len_fixed = g[D_LEN_FIXED];
        if (len_fixed == 0) continue;  // empty in every launched word
        const int nvar = g[D_NVAR];
        int idx = 0;
        if (nvar > 1) {
            const int nsel = g[D_NSEL];
            if constexpr (CB) {
                for (int i = 0; i < nsel; ++i) {
                    const int c = g[D_SEL + i];
                    const int bit = KIND == KIND_MATCH ? c : sr.sel_bit[c];
                    idx |= (int)(((unsigned)bit < 32u ? (cb >> bit) : 0u)
                                 & 1u) << i;
                }
            } else {
                if (nsel == 1) {
                    idx = col_variant<KIND, CLOSED>(g[D_SEL], dg, sr);
                } else {
                    for (int i = 0; i < nsel; ++i) {
                        idx |= (col_variant<KIND, CLOSED>(g[D_SEL + i], dg,
                                                          sr)
                                > 0 ? 1 : 0) << i;
                    }
                }
            }
            idx = min(max(idx, 0), nvar - 1);
        }
        const int len = len_fixed >= 0
            ? len_fixed
            : t.gl[((size_t)w * t.ngd + g[D_GL]) * t.vm + idx];
        const int nwords = g[D_NWORDS];
        const bool p16 = g[D_PACKED16] != 0;
        for (int wi = 0; wi < nwords; ++wi) {
            const uint32_t wd = p16
                ? (uint32_t)t.gw16[((size_t)w * t.ng16 + g[D_TAB]) * t.vm
                                   + idx]
                : t.gw[(((size_t)w * t.ngw + g[D_TAB]) * t.vm + idx)
                       * t.nw + wi];
            const int bc = min(max(len - 4 * wi, 0), 4);
            if (ALGO == ALGO_NTLM) {
                // Bytes b0..b3 become code units (b0 | b1 << 16) and
                // (b2 | b3 << 16); the terminator byte becomes the padded
                // message's 80 00.  u16 rows have no b2, b3.
                append<NW_DATA>(m, acc, nacc, widx,
                                (wd & 0xFFu) | ((wd & 0xFF00u) << 8),
                                2 * min(bc, 2));
                if (!p16) {
                    append<NW_DATA>(m, acc, nacc, widx,
                                    ((wd >> 16) & 0xFFu) | ((wd >> 24) << 16),
                                    2 * max(bc - 2, 0));
                }
            } else {
                append<NW_DATA>(m, acc, nacc, widx, wd, bc);
            }
        }
        constexpr int STEP = 4 / Hash<ALGO>::SCALE;  // <= 4 message bytes
        for (int rest = len - 4 * nwords; rest > 0; rest -= STEP) {
            append<NW_DATA>(m, acc, nacc, widx, 0u,
                            Hash<ALGO>::SCALE * min(rest, STEP));
        }
        off += len;
    }
    // The pending bytes (and any set bits above them) end the data.
    for (int k = 0; k < 2 && acc != 0u; ++k) {
        if (widx < NW_DATA) m[widx] = (uint32_t)acc;
        ++widx;
        acc >>= 32;
    }
    *nw = min(widx, NW_DATA);
    return off - 1;
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
// The count-windowed tier: live ranks only, word tables staged per CTA
// ---------------------------------------------------------------------------
//
// A CTA owns G consecutive blocks.  It runs in WIN_PHASES phases with a
// barrier between each (win_phase): 0, the group descriptors and the G
// blocks' word / count / base into shared memory; 1, one thread takes
// the prefix of the counts and numbers the distinct words; 2, each
// distinct word's record — radix, DP rows, bit positions, piece rows,
// selector and closure rows — is copied into shared memory once, and the
// emit rows of padding lanes (rank >= count) are written 0; 3, the
// threads stride over the LIVE ranks of the G blocks (block by binary
// search over the prefix: no divide), each decoding, splicing and hashing
// one candidate from the staged tables.  The message and the digit
// vector live in per-thread shared-memory slabs laid out [word][thread]
// (Slab), so nothing is in local memory; the message is copied into
// registers for the compressions.  Padding lanes' state rows are not
// written (the reference's contract: emit masks them).

#define WIN_THREADS 256  // one hash block; 128 for two or three
#define WIN_MAX_G 32
#define WIN_RECORD_BYTES (24 * 1024)  // staged word records per CTA
#define WIN_PHASES 4

// A CTA's shared-memory layout (offsets in int32 words) and the record
// layout of one staged word (offsets within the record).
struct WinGeom {
    int g, nt, rec;
    int r_radix, r_winv, r_bitpos, r_gw, r_g16, r_gl, r_sel, r_cnext, r_cmul;
    int s_desc, s_blk, s_rec, s_msg, s_dig;
    int smem_bytes;
};

// Plain C++: the host launch and the host test build both call it.
static inline WinGeom win_geometry(const LaunchArgs& a, const PieceTables& t,
                                   int kind, bool closed, bool pack, int hb,
                                   int nt, int gmax) {
    WinGeom g;
    const bool suball = kind == KIND_SUBALL;
    int o = 0;
    g.r_radix = o;  o += a.m;
    g.r_winv = o;   o += (a.m + 1) * a.k2;
    g.r_bitpos = o; o += suball && pack ? a.m : 0;
    g.r_gw = o;     o += t.ngw * t.vm * t.nw;
    g.r_g16 = o;    o += t.ng16 * t.vm;
    g.r_gl = o;     o += t.ngd * t.vm;
    g.r_sel = o;    o += suball ? a.ncols : 0;
    g.r_cnext = o;  o += closed ? a.m * a.close_s : 0;
    g.r_cmul = o;   o += closed ? a.m * (a.close_s + 1) : 0;
    g.rec = o > 0 ? o : 1;
    int fit = WIN_RECORD_BYTES / 4 / g.rec;
    g.g = fit < 1 ? 1 : (fit < gmax ? fit : gmax);
    g.nt = nt;
    g.s_desc = 0;
    g.s_blk = a.ngroups * DESC_WIDTH;
    g.s_rec = g.s_blk + 6 * g.g + 2;
    g.s_msg = (g.s_rec + g.g * g.rec + 3) & ~3;
    g.s_dig = g.s_msg + 16 * hb * nt;
    const int dig_words = pack ? 0 : (a.m * nt + 3) / 4;
    g.smem_bytes = 4 * (g.s_dig + dig_words);
    return g;
}

// One phase of a CTA of the windowed tier (see above).  PACK: the walk's
// chosen bits feed the scalar selectors (no digit vector).
template <int ALGO, int KIND, int HB, bool CLOSED, bool PACK>
__device__ __forceinline__ void win_phase(int phase, const LaunchArgs& a,
                                          const PieceTables& t,
                                          const WinGeom& g, int32_t* s) {
    const int tid = threadIdx.x, nt = blockDim.x, G = g.g;
    int32_t* bw = s + g.s_blk;  // word of each block (-1 past nb)
    int32_t* bc = bw + G;       // count, clamped to the stride
    int32_t* bb = bc + G;       // windowed base rank
    int32_t* bs = bb + G;       // distinct-word slot of each block
    int32_t* bu = bs + G;       // word of each slot
    int32_t* bp = bu + G;       // prefix of the counts [G + 1], then nu
    const int blk0 = blockIdx.x * G;
    if (phase == 0) {
        for (int i = tid; i < a.ngroups * DESC_WIDTH; i += nt) {
            s[g.s_desc + i] = a.desc[i];
        }
        for (int i = tid; i < G; i += nt) {
            const bool in = blk0 + i < a.nb;
            bw[i] = in ? a.blk_word[blk0 + i] : -1;
            bc[i] = in ? min(max(a.blk_count[blk0 + i], 0), a.stride) : 0;
            bb[i] = in ? a.blk_base[blk0 + i] : 0;
        }
    } else if (phase == 1) {
        if (tid == 0) {
            bp[G + 1] = tile_words(bw, [&](int i) { return bc[i]; }, bs, bu,
                                   bp, G, 0, a.stride);
        }
    } else if (phase == 2) {
        const int nu = bp[G + 1];
        int32_t* recs = s + g.s_rec;
        const size_t mk = (size_t)(a.m + 1) * a.k2;
        stage_rows(recs, g.rec, g.r_radix, a.radix, a.m, bu, nu);
        stage_rows(recs, g.rec, g.r_winv, a.win_v, (int)mk, bu, nu);
        if (KIND == KIND_SUBALL && PACK) {
            stage_rows(recs, g.rec, g.r_bitpos, a.bitpos, a.m, bu, nu);
        }
        stage_rows(recs, g.rec, g.r_gw,
                   reinterpret_cast<const int32_t*>(t.gw),
                   t.ngw * t.vm * t.nw, bu, nu);
        stage_rows(recs, g.rec, g.r_g16, t.gw16, t.ng16 * t.vm, bu, nu);
        stage_rows(recs, g.rec, g.r_gl, t.gl, t.ngd * t.vm, bu, nu);
        if (KIND == KIND_SUBALL) {
            stage_rows(recs, g.rec, g.r_sel, PACK ? a.sel_bit : a.sel_slot,
                       a.ncols, bu, nu);
        }
        if (CLOSED) {
            stage_rows(recs, g.rec, g.r_cnext, a.cnext, a.m * a.close_s, bu,
                       nu);
            stage_rows(recs, g.rec, g.r_cmul, a.cmul, a.m * (a.close_s + 1),
                       bu, nu);
        }
        for (int i = 0; i < G && blk0 + i < a.nb; ++i) {
            for (int r = bc[i] + tid; r < a.stride; r += nt) {
                a.emit[(long long)(blk0 + i) * a.stride + r] = 0;
            }
        }
    } else {
        const int live = bp[G];
        const Slab<uint32_t> msg{reinterpret_cast<uint32_t*>(s + g.s_msg)
                                 + tid, nt};
        const Slab<uint8_t> dig{reinterpret_cast<uint8_t*>(s + g.s_dig)
                                + tid, nt};
        const int* desc = s + g.s_desc;
        for (int i = tid; i < live; i += nt) {
            int lo = 0, hi = G;  // the last block whose prefix is <= i
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (bp[mid] <= i) lo = mid; else hi = mid;
            }
            const int r = i - bp[lo];
            const int32_t* rec = s + g.s_rec + bs[lo] * g.rec;
            SelRows sr;
            sr.sel_bit = sr.sel_slot = rec + g.r_sel;
            sr.cnext = rec + g.r_cnext;
            sr.cmul = rec + g.r_cmul;
            sr.m = a.m;
            sr.close_s = a.close_s;
            PieceTables ts;
            ts.gw = reinterpret_cast<const uint32_t*>(rec + g.r_gw);
            ts.gw16 = rec + g.r_g16;
            ts.gl = rec + g.r_gl;
            ts.ngw = t.ngw;
            ts.ng16 = t.ng16;
            ts.ngd = t.ngd;
            ts.vm = t.vm;
            ts.nw = t.nw;
            int len, cc = 0, nw = 0;
            if constexpr (PACK) {
                // Scalar selectors over the walk's chosen bits: match slot
                // s is bit s of cb, suball slot s bit bitpos[w, s].
                uint32_t cb = 0u;
                const int32_t* bpos = rec + g.r_bitpos;
                windowed_walk(bb[lo] + r, rec + g.r_winv, rec + g.r_radix,
                              a.m, a.k2, a.k_opts, [&](int q, int d) {
                    const int bit = KIND == KIND_MATCH ? q : bpos[q];
                    cb |= (d > 0 ? 1u : 0u) << (bit & 31);
                });
                cc = __popc(cb);
                len = build_message<ALGO, HB, KIND, true, false>(
                    msg, cb, (const int*)nullptr, 0, desc, a.ngroups, ts,
                    sr, &nw);
            } else {
                windowed_walk(bb[lo] + r, rec + g.r_winv, rec + g.r_radix,
                              a.m, a.k2, a.k_opts, [&](int q, int d) {
                    dig[q] = (uint8_t)d;
                    cc += d > 0 ? 1 : 0;
                });
                len = build_message<ALGO, HB, KIND, false, CLOSED>(
                    msg, 0u, dig, 0, desc, a.ngroups, ts, sr, &nw);
            }
            uint32_t mr[16 * HB];
#pragma unroll
            for (int j = 0; j < 16 * HB; ++j) mr[j] = j < nw ? msg[j] : 0u;
            const long long row = (long long)(blk0 + lo) * a.stride + r;
            hash_lane<ALGO, HB>(mr, len, a, row);
            a.emit[row] = in_window(cc, a);
        }
    }
}

template <int ALGO, int KIND, int HB, bool CLOSED, bool PACK>
__global__ void __launch_bounds__(HB == 1 ? WIN_THREADS : WIN_THREADS / 2)
piece_windowed_kernel(LaunchArgs a, PieceTables t, WinGeom g) {
    DYN_SMEM(smem);
    int32_t* s = reinterpret_cast<int32_t*>(smem);
#pragma unroll
    for (int p = 0; p < WIN_PHASES; ++p) {
        if (p) __syncthreads();
        win_phase<ALGO, KIND, HB, CLOSED, PACK>(p, a, t, g, s);
    }
}

// ---------------------------------------------------------------------------
// The tile tiers — the scalar and digit decodes at K=1 and the pair tier:
// live lanes only, word tables staged per CTA, one splice walk for both
// pair candidates
// ---------------------------------------------------------------------------
//
// A CTA owns a tile: G consecutive blocks, or, when a block's stride is
// wider than TILE_LANES, one chunk of one block (C chunks a block).  It
// runs in TILE_PHASES phases with a barrier between each (tile_phase):
//   0  the tile's block fields into shared memory, and the group
//      descriptors packed to one int4 a group (tile_desc); for the
//      scalar selectors over a match plan one thread also drops the
//      groups empty in every word and merges runs of up to three
//      one-word groups — bit fields of cb side by side, and constant
//      pieces between them — into one group of at most 16 variants;
//   1  one thread numbers the distinct words and takes the prefix of the
//      lanes each block has below its count (pair: 2r < count);
//   2  each distinct word's record — the digit decode's slot rows (radix,
//      reciprocal and shift: radix_row), piece rows, selector row, the
//      closure's successor and multiplier rows, and each merged group's
//      variants as 16 bytes (three words, the pieces' bytes concatenated,
//      then the length) — is staged in shared memory once;
//   3  the threads walk the tile's lanes (a power-of-two stride: block and
//      rank by shift and mask; else the lanes below the counts, block by
//      binary search over the prefix), decide which are live (scalar
//      decode: the window on popc(cb); digit decode: the window on the
//      digits' chosen count, the digits decoded and dropped; pair: either
//      candidate in it) and pack the live ones into a list (warp ballot +
//      popc prefix, one shared atomic a warp), writing emit 0 for the
//      rest;
//   4  the threads stride over the packed list — full warps — each
//      decoding, splicing and hashing its lane's candidate(s).
// Dead rows get emit 0 and no state write (the reference's contract).  A
// bit-field group's variant index is one shift and mask of cb; a merged
// group's variant is one 16-byte shared load and at most three funnel-
// shifted stores (tile_put3).  The message lives in a shared-memory slab
// [word][thread] (Slab), so nothing is in local memory; its words past
// the candidate's end are kept zero, so it is copied into registers for
// the compressions with no selects.  The pair tier's two candidates
// differ only in slot 0 (cb | 1, or slot 0's digit + 1): one walk over
// the descriptors evaluates each group's selectors for both, reads the
// piece words once where the two variant indices agree, and appends to
// two messages, whose bytes shift apart after a group whose two variants
// differ in length.  Only live candidates are compressed.  What still
// holds the tiers above their bound, beside the compression: the splice
// walk (per group a descriptor, a variant index and its appends), the
// slab's stores and reloads, and each CTA's phases.

#define TILE_LANES 2048  // lanes a CTA takes at most (its live list)
#define TILE_MAX_G 32
#define TILE_RECORD_BYTES (24 * 1024)
#define TILE_PHASES 5
#define TILE_MERGE_VARIANTS 16  // variants of a merged group, at most
#define TILE_MERGE_GROUPS 3     // groups merged into one, at most
#define TILE_MISC 5  // prefix end, distinct words, live lanes, groups, merges

// A packed group descriptor (int4): x = placed length (16 bits, -1 =
// dynamic) | the u32 rows' words a variant << 16; y = variants (16 bits)
// | words << 16 (8 bits) | packed16 << 24 | bit field << 25 | selector
// columns << 26 (4 bits) | merged << 30; z = the columns a byte each (a
// bit field: its first column); w = offset of its word rows | offset of
// its length row << 16, in the staged record (a merged group: the offset
// of its variants, four int32 each — three words and the length).
#define TD_P16 (1 << 24)
#define TD_BITS (1 << 25)
#define TD_MERGED (1 << 30)

struct TileGeom {
    int g, c, lc, nt, rec, bm, shift;
    int r_dec, r_gw, r_g16, r_gl, r_sel, r_cnext, r_cmul, r_mrg;
    int s_desc, s_mrg, s_blk, s_rec, s_list, s_msg, s_dig;
    int smem_bytes;
};

// Plain C++: the host launch and the host test build both call it.
static inline TileGeom tile_geometry(const LaunchArgs& a, const PieceTables& t,
                                     int kind, int decode, bool closed,
                                     int nm, int hb, int nt, int gmax,
                                     int lmax) {
    TileGeom g;
    const bool digits = decode == DECODE_DIGITS;
    const bool merge = kind == KIND_MATCH && !digits;
    int o = 0;
    // The digit decode's slot rows (radix_row: 16-byte loads) first.
    g.r_dec = o;    o += digits ? 4 * a.m : 0;
    g.r_gw = o;     o += t.ngw * t.vm * t.nw;
    g.r_g16 = o;    o += t.ng16 * t.vm;
    g.r_gl = o;     o += t.ngd * t.vm;
    g.r_sel = o;    o += kind == KIND_SUBALL ? a.ncols : 0;
    g.r_cnext = o;  o += closed ? a.m * a.close_s : 0;
    g.r_cmul = o;   o += closed ? a.m * (a.close_s + 1) : 0;
    // Merged groups: three words and a length a variant (16-byte loads),
    // of at least two groups each.
    o = merge ? (o + 3) & ~3 : o;
    g.r_mrg = o;    o += merge ? a.ngroups / 2 * 4 * TILE_MERGE_VARIANTS : 0;
    g.rec = o > 0 ? (merge || digits ? (o + 3) & ~3 : o) : 1;
    const TileCut k = tile_cut(a.stride, TILE_RECORD_BYTES / 4 / g.rec, gmax,
                               lmax);
    g.g = k.g;
    g.c = k.c;
    g.lc = k.lc;
    g.shift = k.shift;
    g.nt = nt;
    g.bm = digits ? a.m : 1;
    g.s_desc = 0;
    g.s_mrg = 4 * a.ngroups;
    g.s_blk = g.s_mrg + a.ngroups;
    // word, count, slot, distinct word [G] each; base [G * bm]; prefix
    // [G + 1]; the TILE_MISC counts after it.
    g.s_rec = (g.s_blk + 5 * g.g + g.g * g.bm + 1 + TILE_MISC + 3) & ~3;
    g.s_list = g.s_rec + g.g * g.rec;
    g.s_msg = (g.s_list + g.g * g.lc + 3) & ~3;
    g.s_dig = g.s_msg + nm * 16 * hb * nt;
    g.smem_bytes = 4 * (g.s_dig + (digits ? (a.m * nt + 3) / 4 : 0));
    return g;
}

// A group's packed descriptor from its full one (D_*), its record offsets
// from the geometry; `bits`: its selectors are a bit field of cb.
__device__ __forceinline__ int4 tile_desc(const int* d, const TileGeom& g,
                                          const PieceTables& t, bool bits) {
    const int nsel = min(max(d[D_NSEL], 0), MAX_SEL);
    int cols = 0;
    for (int i = 0; i < MAX_SEL; ++i) {
        cols |= (i < nsel ? d[D_SEL + i] & 0xFF : 0xFF) << (8 * i);
    }
    const bool p16 = d[D_PACKED16] != 0;
    const int w_off = p16 ? g.r_g16 + d[D_TAB] * t.vm
                          : g.r_gw + d[D_TAB] * t.vm * t.nw;
    const int gl_off = d[D_LEN_FIXED] < 0 ? g.r_gl + d[D_GL] * t.vm : 0;
    return make_int4((d[D_LEN_FIXED] & 0xFFFF) | (t.nw << 16),
                     (d[D_NVAR] & 0xFFFF) | (d[D_NWORDS] << 16)
                         | (p16 ? TD_P16 : 0) | (bits ? TD_BITS : 0)
                         | (nsel << 26),
                     cols, (w_off & 0xFFFF) | (gl_off << 16));
}

// Whether a group's selector columns are consecutive ascending slots and
// its variants every value of them: its index is a bit field of cb.
__device__ __forceinline__ bool tile_bits(const int* d) {
    const int nsel = d[D_NSEL];
    if (nsel < 1 || nsel > MAX_SEL || d[D_NVAR] != 1 << nsel) return false;
    for (int i = 1; i < nsel; ++i) {
        if (d[D_SEL + i] != d[D_SEL] + i) return false;
    }
    return d[D_SEL] >= 0 && d[D_SEL] + nsel <= 31;
}

// One piece of group `d` (full descriptor) for word `w`, variant `v`:
// its first word and its placed length, read from the global tables.
__device__ __forceinline__ void tile_piece(const int* d, const PieceTables& t,
                                           int w, int v, uint32_t& wd,
                                           int& len) {
    len = d[D_LEN_FIXED] >= 0
        ? d[D_LEN_FIXED] : t.gl[((size_t)w * t.ngd + d[D_GL]) * t.vm + v];
    wd = d[D_PACKED16]
        ? (uint32_t)t.gw16[((size_t)w * t.ng16 + d[D_TAB]) * t.vm + v]
        : t.gw[(((size_t)w * t.ngw + d[D_TAB]) * t.vm + v) * t.nw];
}

// Append a merged variant — up to 12 bytes in three words, the bytes past
// `nbytes` zero — with funnel shifts: up to three stores.
template <int NW_DATA, class Msg>
__device__ __forceinline__ void tile_put3(Msg m, MsgState& st, uint32_t w0,
                                          uint32_t w1, uint32_t w2,
                                          int nbytes) {
    const uint32_t o0 = st.lo | (w0 << st.nb);
    const uint32_t o1 = __funnelshift_l(w0, w1, st.nb);
    const uint32_t o2 = __funnelshift_l(w1, w2, st.nb);
    const uint32_t o3 = __funnelshift_l(w2, 0u, st.nb);
    const int bits = st.nb + 8 * nbytes;
    const int k = bits >> 5;  // words filled
    if (k > 0 && st.widx < NW_DATA) m[st.widx] = o0;
    if (k > 1 && st.widx + 1 < NW_DATA) m[st.widx + 1] = o1;
    if (k > 2 && st.widx + 2 < NW_DATA) m[st.widx + 2] = o2;
    st.lo = k == 0 ? o0 : (k == 1 ? o1 : (k == 2 ? o2 : o3));
    st.widx += k;
    st.nb = bits & 31;
}

// Splice NM candidates of one lane into the slabs `msg[0..NM)` with one
// walk over the packed descriptors `gd` (TileDesc): candidate 1 differs
// from candidate 0 in slot 0 only (CB: bit 0 of cb set; digits: slot 0's
// digit `d0p`).  `rec` is the lane's staged word record (rows at the
// offsets the descriptors carry; the selector row at `sel`).  CLOSED (one
// candidate): a chosen slot's column variant is 1 + its joint closure
// index over the record's successor rows `cnext` / `cmul` (closure_index).
// Writes each candidate's length in bytes (terminator excluded) to `len`
// and its message words to `nw`.
template <int ALGO, int HB, int KIND, bool CB, int NM, bool CLOSED,
          class Dig, bool MERGED = CB && KIND == KIND_MATCH>
__device__ __forceinline__ void tile_splice(const Slab<uint32_t>* msg,
                                            uint32_t cb, Dig dg, int d0p,
                                            int m, const int4* gd, int ng,
                                            const int32_t* rec,
                                            const int32_t* sel,
                                            const int32_t* cnext,
                                            const int32_t* cmul, int close_s,
                                            int* len, int* nw) {
    constexpr int NW_DATA = 16 * HB - 2;
    MsgState ms[NM];
#pragma unroll
    for (int p = 0; p < NM; ++p) ms[p] = MsgState{0u, 0, 0, 0};
    for (int gi = 0; gi < ng; ++gi) {
        const int4 d = gd[gi];
        const int len_fixed = (int)(short)(d.x & 0xFFFF);
        if (len_fixed == 0) continue;  // empty in every launched word
        const int vstride = (int)((unsigned)d.x >> 16);
        const int nvar = d.y & 0xFFFF;
        const int nwords = (d.y >> 16) & 0xFF;
        const bool p16 = (d.y & TD_P16) != 0;
        int idx[NM];
#pragma unroll
        for (int p = 0; p < NM; ++p) idx[p] = 0;
        if (nvar > 1) {
            const int nsel = (d.y >> 26) & 15;
            if (CB && KIND == KIND_MATCH && (d.y & TD_BITS)) {
                const int c0 = d.z & 0xFF;
                idx[0] = (int)((cb >> c0) & ((1u << nsel) - 1u));
                if (NM == 2) idx[NM - 1] = idx[0] | (c0 == 0 ? 1 : 0);
            } else {
                for (int i = 0; i < nsel; ++i) {
                    const int c = (d.z >> (8 * i)) & 0xFF;
                    if constexpr (CB) {
                        const int bit = KIND == KIND_MATCH ? c : sel[c];
                        const uint32_t on = (unsigned)bit < 32u
                            ? (cb >> (bit & 31)) & 1u : 0u;
                        idx[0] |= (int)on << i;
                        if (NM == 2) {
                            idx[NM - 1] |= (int)(bit == 0 ? 1u : on) << i;
                        }
                    } else {
                        const int sl = KIND == KIND_MATCH ? c : sel[c];
                        int v = (unsigned)sl < (unsigned)m ? dg[sl] : 0;
                        if (CLOSED && v > 0) {
                            v = 1 + closure_index(sl, v, dg, m,
                                                  cnext + sl * close_s,
                                                  cmul + sl * (close_s + 1),
                                                  close_s);
                        }
                        const int v1 = sl == 0 ? d0p : v;
                        if (nsel == 1) {
                            idx[0] = v;
                            if (NM == 2) idx[NM - 1] = v1;
                        } else {
                            idx[0] |= (v > 0 ? 1 : 0) << i;
                            if (NM == 2) idx[NM - 1] |= (v1 > 0 ? 1 : 0) << i;
                        }
                    }
                }
            }
#pragma unroll
            for (int p = 0; p < NM; ++p) idx[p] = min(max(idx[p], 0), nvar - 1);
        }
        const int w_off = d.w & 0xFFFF;
        if (MERGED && (d.y & TD_MERGED)) {
            // A merged group: the variant's three words and length in one
            // 16-byte load.
            int4 q[NM];
#pragma unroll
            for (int p = 0; p < NM; ++p) {
                q[p] = p > 0 && idx[p] == idx[0] ? q[0]
                    : *reinterpret_cast<const int4*>(rec + w_off + 4 * idx[p]);
            }
#pragma unroll
            for (int p = 0; p < NM; ++p) {
                MsgState& st = ms[p];
                if (ALGO == ALGO_NTLM) {
                    // Each byte becomes a UTF-16LE code unit (the byte,
                    // then 00).
                    for (int wi = 0; wi < nwords; ++wi) {
                        const uint32_t wd = (uint32_t)(wi == 0 ? q[p].x
                            : (wi == 1 ? q[p].y : q[p].z));
                        const int bc = min(max(q[p].w - 4 * wi, 0), 4);
                        tile_put<NW_DATA>(msg[p], st,
                                          (wd & 0xFFu) | ((wd & 0xFF00u) << 8),
                                          2 * min(bc, 2));
                        tile_put<NW_DATA>(msg[p], st,
                                          ((wd >> 16) & 0xFFu)
                                              | ((wd >> 24) << 16),
                                          2 * max(bc - 2, 0));
                    }
                } else {
                    tile_put3<NW_DATA>(msg[p], st, (uint32_t)q[p].x,
                                       (uint32_t)q[p].y, (uint32_t)q[p].z,
                                       q[p].w);
                }
            }
#pragma unroll
            for (int p = 0; p < NM; ++p) ms[p].off += q[p].w;
            continue;
        }
        const int gl_off = (d.w >> 16) & 0xFFFF;
        int glen[NM];
#pragma unroll
        for (int p = 0; p < NM; ++p) {
            glen[p] = len_fixed >= 0 ? len_fixed
                : (p > 0 && idx[p] == idx[0] ? glen[0] : rec[gl_off + idx[p]]);
        }
        for (int wi = 0; wi < nwords; ++wi) {
            uint32_t wd[NM];
#pragma unroll
            for (int p = 0; p < NM; ++p) {
                wd[p] = p > 0 && idx[p] == idx[0] ? wd[0]
                    : (uint32_t)(p16 ? rec[w_off + idx[p]]
                                     : rec[w_off + idx[p] * vstride + wi]);
            }
#pragma unroll
            for (int p = 0; p < NM; ++p) {
                const int bc = min(max(glen[p] - 4 * wi, 0), 4);
                MsgState& st = ms[p];
                if (ALGO == ALGO_NTLM) {
                    tile_put<NW_DATA>(msg[p], st,
                                      (wd[p] & 0xFFu) | ((wd[p] & 0xFF00u) << 8),
                                      2 * min(bc, 2));
                    if (!p16) {
                        tile_put<NW_DATA>(msg[p], st,
                                          ((wd[p] >> 16) & 0xFFu)
                                              | ((wd[p] >> 24) << 16),
                                          2 * max(bc - 2, 0));
                    }
                } else {
                    tile_put<NW_DATA>(msg[p], st, wd[p], bc);
                }
            }
        }
        constexpr int STEP = 4 / Hash<ALGO>::SCALE;  // <= 4 message bytes
#pragma unroll
        for (int p = 0; p < NM; ++p) {
            MsgState& st = ms[p];
            for (int rest = glen[p] - 4 * nwords; rest > 0; rest -= STEP) {
                tile_put<NW_DATA>(msg[p], st, 0u,
                                  Hash<ALGO>::SCALE * min(rest, STEP));
            }
            st.off += glen[p];
        }
    }
#pragma unroll
    for (int p = 0; p < NM; ++p) {
        nw[p] = tile_end<NW_DATA>(msg[p], ms[p]);  // the pending bytes
        len[p] = ms[p].off - 1;
    }
}

// One phase of a CTA of the tile tiers (see above).  PAIR: lane r of
// block b owns candidate ranks 2r and 2r + 1 of a block of 2 * stride
// ranks, rows b * 2 * stride + 2r + p; else lane r is rank r, row
// b * stride + r.  CLOSED: the cascade closure (substitute-all digit
// decode, K=1).
template <int ALGO, int KIND, int DECODE, int HB, bool PAIR, bool CLOSED>
__device__ __forceinline__ void tile_phase(int phase, const LaunchArgs& a,
                                           const PieceTables& t,
                                           const TileGeom& g, int32_t* s) {
    constexpr bool CB = DECODE == DECODE_SCALAR;
    constexpr bool MERGE = CB && KIND == KIND_MATCH;
    constexpr int NM = PAIR ? 2 : 1;
    const int tid = threadIdx.x, nt = blockDim.x, G = g.g;
    int4* gd = reinterpret_cast<int4*>(s + g.s_desc);
    int32_t* mrg = s + g.s_mrg;  // merges: first group | second << 16
    int32_t* bw = s + g.s_blk;  // word of each block (-1 past nb)
    int32_t* bc = bw + G;       // count, clamped to the block's ranks
    int32_t* bs = bc + G;       // distinct-word slot of each block
    int32_t* bu = bs + G;       // word of each slot
    int32_t* bb = bu + G;       // base [G * bm]: pbase, or base digits
    int32_t* bp = bb + G * g.bm;  // prefix of the lanes [G + 1]
    int32_t* misc = bp + G + 1;   // distinct words, live, groups, merges
    const int grp = (int)blockIdx.x / g.c;
    const int lane0 = ((int)blockIdx.x - grp * g.c) * g.lc;
    const int lane1 = min(lane0 + g.lc, a.stride);
    const int blk0 = grp * G;
    const int ranks = a.stride * NM;  // candidate ranks a block spans
    if (phase == 0) {
        for (int i = tid; i < G; i += nt) {
            const bool in = blk0 + i < a.nb;
            bw[i] = in ? a.blk_word[blk0 + i] : -1;
            bc[i] = in ? min(max(a.blk_count[blk0 + i], 0), ranks) : 0;
        }
        for (int i = tid; i < G * g.bm; i += nt) {
            bb[i] = blk0 + i / g.bm < a.nb
                ? a.blk_base[(size_t)blk0 * g.bm + i] : 0;
        }
        if (!MERGE) {
            for (int gi = tid; gi < a.ngroups; gi += nt) {
                gd[gi] = tile_desc(a.desc + gi * DESC_WIDTH, g, t, false);
            }
            if (tid == 0) {
                misc[2] = a.ngroups;
                misc[3] = 0;
            }
        } else if (tid == 0) {
            // Runs of up to TILE_MERGE_GROUPS one-word groups — bit fields
            // of cb side by side, and constant pieces — become one group
            // of at most TILE_MERGE_VARIANTS variants (mixed radix over its
            // groups, in order: the bit fields concatenated).
            int nd = 0, nm = 0, moff = g.r_mrg;
            int run[TILE_MERGE_GROUPS], nrun = 0, nvar = 1, next = -1;
            int c0 = 0, nsel = 0;
            auto close = [&]() {
                if (nrun == 1) {
                    const int* d = a.desc + run[0] * DESC_WIDTH;
                    gd[nd++] = tile_desc(d, g, t, tile_bits(d));
                } else if (nrun > 1) {
                    gd[nd++] = make_int4(
                        0xFFFF | (4 << 16),
                        nvar | (nrun << 16) | TD_BITS | TD_MERGED
                            | (nsel << 26),
                        c0, moff);
                    mrg[2 * nm] = run[0] | (run[1] << 8)
                        | ((nrun > 2 ? run[2] : 0) << 16) | (nrun << 24);
                    mrg[2 * nm + 1] = moff;
                    ++nm;
                    moff += 4 * nvar;
                }
                nrun = 0;
                nvar = 1;
                next = -1;
                c0 = nsel = 0;
            };
            for (int gi = 0; gi < a.ngroups; ++gi) {
                const int* d = a.desc + gi * DESC_WIDTH;
                if (d[D_LEN_FIXED] == 0) continue;  // empty in every word
                const bool bits = tile_bits(d);
                const bool fixed = d[D_NVAR] == 1;
                if (d[D_NWORDS] != 1 || !(bits || fixed)) {
                    close();
                    gd[nd++] = tile_desc(d, g, t, bits);
                    continue;
                }
                if (nrun == TILE_MERGE_GROUPS
                    || nvar * d[D_NVAR] > TILE_MERGE_VARIANTS
                    || (bits && next >= 0 && d[D_SEL] != next)) {
                    close();
                }
                if (bits) {
                    if (next < 0) c0 = d[D_SEL];
                    next = d[D_SEL] + d[D_NSEL];
                    nsel += d[D_NSEL];
                }
                run[nrun++] = gi;
                nvar *= d[D_NVAR];
            }
            close();
            misc[2] = nd;
            misc[3] = nm;
        }
    } else if (phase == 1) {
        if (tid == 0) {
            misc[0] = tile_words(
                bw, [&](int i) { return PAIR ? (bc[i] + 1) >> 1 : bc[i]; },
                bs, bu, bp, G, lane0, lane1);
            misc[1] = 0;
        }
    } else if (phase == 2) {
        const int nu = misc[0];
        int32_t* recs = s + g.s_rec;
        if (DECODE == DECODE_DIGITS) {
            for (int k = tid; k < nu * a.m; k += nt) {
                const int u = k / a.m, q = k - u * a.m;
                reinterpret_cast<int4*>(recs + u * g.rec + g.r_dec)[q] =
                    radix_row(a.radix[(size_t)bu[u] * a.m + q]);
            }
        }
        stage_rows(recs, g.rec, g.r_gw,
                   reinterpret_cast<const int32_t*>(t.gw),
                   t.ngw * t.vm * t.nw, bu, nu);
        stage_rows(recs, g.rec, g.r_g16, t.gw16, t.ng16 * t.vm, bu, nu);
        stage_rows(recs, g.rec, g.r_gl, t.gl, t.ngd * t.vm, bu, nu);
        if (KIND == KIND_SUBALL) {
            stage_rows(recs, g.rec, g.r_sel, CB ? a.sel_bit : a.sel_slot,
                       a.ncols, bu, nu);
        }
        if (CLOSED) {
            stage_rows(recs, g.rec, g.r_cnext, a.cnext, a.m * a.close_s, bu,
                       nu);
            stage_rows(recs, g.rec, g.r_cmul, a.cmul, a.m * (a.close_s + 1),
                       bu, nu);
        }
        if (MERGE) {
            // Each merged variant: its groups' pieces' bytes in order
            // (each piece at most 4), then the length.
            const int nm = misc[3];
            for (int k = tid; k < nu * nm * TILE_MERGE_VARIANTS; k += nt) {
                const int v = k % TILE_MERGE_VARIANTS;
                const int j = k / TILE_MERGE_VARIANTS;
                const int u = j / nm, mi = j - u * nm;
                const int src = mrg[2 * mi], n = src >> 24;
                // Every merged group's variant counts are powers of two.
                int nbits = 0;
                for (int q = 0; q < n; ++q) {
                    nbits += a.desc[((src >> (8 * q)) & 0xFF) * DESC_WIDTH
                                    + D_NSEL];
                }
                if (v >> nbits) continue;
                uint32_t o0 = 0u, o1 = 0u, o2 = 0u;
                int pos = 0, vv = v;
                for (int q = 0; q < n; ++q) {
                    const int* d = a.desc + ((src >> (8 * q)) & 0xFF)
                        * DESC_WIDTH;
                    const int nsel = d[D_NVAR] > 1 ? d[D_NSEL] : 0;
                    uint32_t wd;
                    int len;
                    tile_piece(d, t, bu[u], vv & ((1 << nsel) - 1), wd, len);
                    vv >>= nsel;
                    // The piece (zero past its length, at most 4 bytes)
                    // at byte `pos` of the three words.
                    const int sh = 8 * (pos & 3), at = pos >> 2;
                    const uint32_t lo = wd << sh;
                    const uint32_t hi = sh ? wd >> (32 - sh) : 0u;
                    o0 |= at == 0 ? lo : 0u;
                    o1 |= at == 1 ? lo : (at == 0 ? hi : 0u);
                    o2 |= at == 2 ? lo : (at == 1 ? hi : 0u);
                    pos += len;
                }
                int32_t* row = recs + u * g.rec + mrg[2 * mi + 1] + 4 * v;
                row[0] = (int32_t)o0;
                row[1] = (int32_t)o1;
                row[2] = (int32_t)o2;
                row[3] = pos;
            }
        }
        for (int i = 0; g.shift < 0 && i < G && blk0 + i < a.nb; ++i) {
            const int live = PAIR ? (bc[i] + 1) >> 1 : bc[i];
            const long long row0 = (long long)(blk0 + i) * ranks;
            for (int r = max(live, lane0) + tid; r < lane1; r += nt) {
#pragma unroll
                for (int p = 0; p < NM; ++p) a.emit[row0 + NM * r + p] = 0;
            }
        }
    } else if (phase == 3) {
        // The lanes to walk: every lane of the tile's blocks (a
        // power-of-two stride: block and rank by shift and mask, the dead
        // ones' emit written here), or the lanes below the counts, by the
        // prefix (block by binary search).
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
                const int r = lane0 + rr;  // rr: lanes from the tile's first
                entry = (lo << 16) | rr;
                live = !shifted || NM * r < bc[lo];
                if (CB && live) {
                    const uint32_t cb = (uint32_t)(bb[lo] + NM * r);
                    const int cc = __popc(cb);
                    if (PAIR) {
                        live = in_window(cc, a)
                            || (2 * r + 1 < bc[lo] && in_window(cc + 1, a));
                    } else {
                        live = in_window(cc, a);
                    }
                } else if (!CB && live) {
                    // The digits' chosen count (and the pair partner's:
                    // slot 0's digit + 1), not kept: the lane decodes
                    // again if it is live.
                    const int4* dec = reinterpret_cast<const int4*>(
                        s + g.s_rec + bs[lo] * g.rec + g.r_dec);
                    int cc = 0, d0 = 0;
                    digits_walk(NM * r, bb + lo * g.bm, dec, a.m,
                                [&](int q, int d) {
                        cc += d > 0 ? 1 : 0;
                        d0 = q == 0 ? d : d0;
                    });
                    live = in_window(cc, a);
                    if (PAIR && a.m > 0 && 2 * r + 1 < bc[lo]) {
                        const int d0p = min(d0 + 1, dec[0].x - 1);
                        live = live || in_window(
                            cc + (d0p > 0) - (d0 > 0), a);
                    }
                }
                if (!live) {
                    const long long row = (long long)(blk0 + lo) * ranks
                        + NM * r;
#pragma unroll
                    for (int p = 0; p < NM; ++p) a.emit[row + p] = 0;
                }
            }
            pack_live(live, entry, &misc[1], list);
        }
    } else {
        const int n = misc[1], nd = misc[2];
        const int32_t* list = s + g.s_list;
        Slab<uint32_t> msg[NM];
#pragma unroll
        for (int p = 0; p < NM; ++p) {
            msg[p] = Slab<uint32_t>{reinterpret_cast<uint32_t*>(s + g.s_msg)
                                        + p * 16 * HB * nt + tid, nt};
        }
        int hw[NM];  // slab words that may be non-zero
#pragma unroll
        for (int p = 0; p < NM; ++p) {
            for (int j = 0; j < 16 * HB; ++j) msg[p][j] = 0u;
            hw[p] = 0;
        }
        const Slab<uint8_t> dig{reinterpret_cast<uint8_t*>(s + g.s_dig)
                                + tid, nt};
        for (int j = tid; j < n; j += nt) {
            const int entry = list[j];
            const int lo = entry >> 16;
            const int r = lane0 + (entry & 0xFFFF);
            const int32_t* rec = s + g.s_rec + bs[lo] * g.rec;
            const int32_t* sel = rec + g.r_sel;
            const long long row = (long long)(blk0 + lo) * ranks + NM * r;
            const int count = bc[lo];
            int len[NM], nw[NM];
            bool e[NM];
            if constexpr (CB) {
                const uint32_t cb = (uint32_t)(bb[lo] + NM * r);
                const int cc = __popc(cb);
#pragma unroll
                for (int p = 0; p < NM; ++p) {
                    e[p] = NM * r + p < count && in_window(cc + p, a);
                }
                tile_splice<ALGO, HB, KIND, true, NM, false>(
                    msg, cb, (const int*)nullptr, 0, a.m, gd, nd, rec, sel,
                    nullptr, nullptr, 0, len, nw);
            } else {
                const int4* dec = reinterpret_cast<const int4*>(rec + g.r_dec);
                int cc = 0;
                digits_walk(NM * r, bb + lo * g.bm, dec, a.m,
                            [&](int q, int d) {
                    dig[q] = (uint8_t)d;
                    cc += d > 0 ? 1 : 0;
                });
                const int d0 = a.m > 0 ? (int)dig[0] : 0;
                const int d0p = a.m > 0 ? min(d0 + 1, dec[0].x - 1) : 0;
                const int cc1 = cc + (d0p > 0 ? 1 : 0) - (d0 > 0 ? 1 : 0);
#pragma unroll
                for (int p = 0; p < NM; ++p) {
                    e[p] = NM * r + p < count && in_window(p ? cc1 : cc, a);
                }
                tile_splice<ALGO, HB, KIND, false, NM, CLOSED>(
                    msg, 0u, dig, d0p, a.m, gd, nd, rec, sel,
                    rec + g.r_cnext, rec + g.r_cmul, a.close_s, len, nw);
            }
#pragma unroll
            for (int p = 0; p < NM; ++p) {
                // Words past this message's end keep zero for the next.
                for (int q = nw[p]; q < hw[p]; ++q) msg[p][q] = 0u;
                hw[p] = nw[p];
                if (e[p]) {
                    hash_slab<ALGO, HB>(msg[p], len[p] * Hash<ALGO>::SCALE,
                                        a.state, row + p);
                }
                a.emit[row + p] = e[p] ? 1 : 0;
            }
        }
    }
}

template <int ALGO, int KIND, int DECODE, int HB, bool PAIR, bool CLOSED>
__global__ void __launch_bounds__(HB == 1 ? 256 : 128)
piece_tile_kernel(LaunchArgs a, PieceTables t, TileGeom g) {
    DYN_SMEM(smem);
    int32_t* s = reinterpret_cast<int32_t*>(smem);
#pragma unroll
    for (int p = 0; p < TILE_PHASES; ++p) {
        if (p) __syncthreads();
        tile_phase<ALGO, KIND, DECODE, HB, PAIR, CLOSED>(p, a, t, g, s);
    }
}

// ---- host launch wrappers ----

#ifndef PIECE_ALGO
#define PIECE_ALGO ALGO_MD5
#endif

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

// The tile tiers (piece_tile_kernel): CTAs of TILE_LANES lanes at most,
// 256 threads for one hash block, 128 for two or three.  The largest
// record the route gate admits (64 token bytes, 24 slots of at most 8
// options of at most 4 bytes, joint tables of 12 rows: ~5,300 words)
// fits a CTA of one block (tests/test_torch_fused_expand.py pins it).
template <int KIND, int DECODE, int HB, bool PAIR, bool CLOSED>
static int launch_tile(const LaunchArgs& a, const PieceTables& t,
                       cudaStream_t s) {
    const int nt = HB == 1 ? 256 : 128;
    const TileGeom g = tile_geometry(a, t, KIND, DECODE, CLOSED,
                                     PAIR ? 2 : 1, HB, nt, TILE_MAX_G,
                                     TILE_LANES);
    // Record offsets ride 16-bit descriptor fields, columns 8-bit ones.
    if (g.rec > 0xFFFF || a.ncols > 0xFF) return (int)cudaErrorInvalidValue;
    auto kern = piece_tile_kernel<PIECE_ALGO, KIND, DECODE, HB, PAIR, CLOSED>;
    if (g.smem_bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const long long grid = (long long)((a.nb + g.g - 1) / g.g) * g.c;
    kern<<<(unsigned)grid, nt, g.smem_bytes, s>>>(a, t, g);
    return (int)cudaGetLastError();
}

template <int KIND, int DECODE, bool CLOSED>
static int launch_tile_hb(const LaunchArgs& a, const PieceTables& t,
                          int hash_blocks, cudaStream_t s) {
    switch (hash_blocks) {
        case 1: return launch_tile<KIND, DECODE, 1, false, CLOSED>(a, t, s);
        case 2: return launch_tile<KIND, DECODE, 2, false, CLOSED>(a, t, s);
        default: return launch_tile<KIND, DECODE, 3, false, CLOSED>(a, t, s);
    }
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

template <int KIND, int HB, bool CLOSED, bool PACK>
static int launch_win(const LaunchArgs& a, const PieceTables& t,
                      cudaStream_t s) {
    const WinGeom g = win_geometry(a, t, KIND, CLOSED, PACK, HB,
                                   HB == 1 ? WIN_THREADS : WIN_THREADS / 2,
                                   WIN_MAX_G);
    auto kern = piece_windowed_kernel<PIECE_ALGO, KIND, HB, CLOSED, PACK>;
    if (g.smem_bytes > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, g.smem_bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const unsigned grid = (unsigned)((a.nb + g.g - 1) / g.g);
    kern<<<grid, g.nt, g.smem_bytes, s>>>(a, t, g);
    return (int)cudaGetLastError();
}

template <int KIND, bool CLOSED, bool PACK>
static int launch_win_hb(const LaunchArgs& a, const PieceTables& t,
                         int hash_blocks, cudaStream_t s) {
    switch (hash_blocks) {
        case 1: return launch_win<KIND, 1, CLOSED, PACK>(a, t, s);
        case 2: return launch_win<KIND, 2, CLOSED, PACK>(a, t, s);
        default: return launch_win<KIND, 3, CLOSED, PACK>(a, t, s);
    }
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
    if (decode != DECODE_SCALAR || launch_checks(a, hash_blocks)
        || kind_checks(a, kind, DECODE_SCALAR, closed)) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.nb == 0 || a.stride == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return kind == KIND_MATCH
        ? launch_tile_hb<KIND_MATCH, DECODE_SCALAR, false>(a, t, hash_blocks,
                                                           s)
        : launch_tile_hb<KIND_SUBALL, DECODE_SCALAR, false>(a, t,
                                                            hash_blocks, s);
}

// K=1, digit decode (base digits [NB, M]), the cascade closure when
// `closed`, 1-3 hash blocks.
int a5_piece_digits(PIECE_PARAMS) {
    PIECE_SETUP;
    if (decode != DECODE_DIGITS || launch_checks(a, hash_blocks)
        || kind_checks(a, kind, DECODE_DIGITS, closed)) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.nb == 0 || a.stride == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == KIND_MATCH) {
        return launch_tile_hb<KIND_MATCH, DECODE_DIGITS, false>(
            a, t, hash_blocks, s);
    }
    return closed
        ? launch_tile_hb<KIND_SUBALL, DECODE_DIGITS, true>(a, t, hash_blocks,
                                                           s)
        : launch_tile_hb<KIND_SUBALL, DECODE_DIGITS, false>(a, t,
                                                            hash_blocks, s);
}

// K=1, windowed decode (scalar windowed rank [NB]), cb packing when
// `pack`, 1-3 hash blocks.
int a5_piece_windowed(PIECE_PARAMS) {
    PIECE_SETUP;
    if (decode != DECODE_WINDOWED || a.k2 < 1 || a.k_opts < 1) {
        return (int)cudaErrorInvalidValue;
    }
    if (launch_checks(a, hash_blocks)
        || kind_checks(a, kind, DECODE_WINDOWED, closed)) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.nb == 0 || a.stride == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool cb = a.pack && !closed;
    if (kind == KIND_MATCH) {
        return cb ? launch_win_hb<KIND_MATCH, false, true>(a, t, hash_blocks, s)
                  : launch_win_hb<KIND_MATCH, false, false>(a, t, hash_blocks, s);
    }
    if (closed) {
        return launch_win_hb<KIND_SUBALL, true, false>(a, t, hash_blocks, s);
    }
    return cb ? launch_win_hb<KIND_SUBALL, false, true>(a, t, hash_blocks, s)
              : launch_win_hb<KIND_SUBALL, false, false>(a, t, hash_blocks, s);
}

// Pair tier, scalar or digit decode, one hash block, no closure.
int a5_piece_pair(PIECE_PARAMS) {
    PIECE_SETUP;
    if (launch_checks(a, hash_blocks) || hash_blocks != 1 || closed
        || (decode != DECODE_SCALAR && decode != DECODE_DIGITS)
        || kind_checks(a, kind, decode, 0)) {
        return (int)cudaErrorInvalidValue;
    }
    if (a.nb == 0 || a.stride == 0) return (int)cudaSuccess;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == KIND_MATCH) {
        return decode == DECODE_SCALAR
            ? launch_tile<KIND_MATCH, DECODE_SCALAR, 1, true, false>(a, t, s)
            : launch_tile<KIND_MATCH, DECODE_DIGITS, 1, true, false>(a, t, s);
    }
    return decode == DECODE_SCALAR
        ? launch_tile<KIND_SUBALL, DECODE_SCALAR, 1, true, false>(a, t, s)
        : launch_tile<KIND_SUBALL, DECODE_DIGITS, 1, true, false>(a, t, s);
}

}  // extern "C"
