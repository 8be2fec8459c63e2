// Buffer hash kernel for Hopper (sm_90a): MD5, MD4, SHA-1 or NTLM of
// candidate byte rows — the hash half of the XLA expand + hash route,
// which takes every plan the fused kernels refuse.
//
// Replaces TPU kernel row 10 of the reference package,
// `_md5_kernel` (hashcat_a5_table_generator_tpu/ops/pallas_md5.py:47,
// wrapper `md5_pallas` :87, `pl.pallas_call` :105): one-block MD5 of
// pre-padded message words, u32[N/128, 16, 128] -> u32[N/128, 4, 128],
// taken under A5GEN_PALLAS=1 for widths up to 55 bytes.  Here the padding
// happens in the kernel, and the same body is the counterpart of the
// reference's XLA byte hashes `HASH_FNS` (ops/hashes.py:257-:295) at every
// width and hash: `pad_message` (:54) — bytes at and past the row's
// length zeroed, 0x80 at byte `length`, the 64-bit bit length at the end
// of the row's own last block (little-endian; big-endian for SHA-1,
// whose compression byte-swaps the little-endian words) — and
// `_run_blocks` (:222): blocks past the row's own last block leave the
// state alone.  NTLM widens the row to UTF-16LE code units first (every
// byte followed by a zero byte, `utf16le_expand` :277), doubling width
// and length.
//
// What bounds it on the H100: integer throughput, with the bytes close
// behind.  A compression costs ~320 INT32 instructions for MD5, ~176 for
// MD4/NTLM and ~608 for SHA-1 against 64 bytes of input (~5-10 per byte
// read); at 1.67e13 INT32 ops/s and 3.35e12 B/s the operations bound it,
// so the loads and the padding have to cost few instructions beside the
// compressions.
//
// Work layout: one thread per row.  A thread builds each 64-byte block's
// words with aligned 4-byte loads straight from global memory — as they
// are when the rows are 4-byte aligned (ALIGNED), else funnel-shifted to
// the row's byte offset (one more load per block); only words holding a
// byte below the row's length are loaded, so no sector past the data is
// fetched, and byte loads remain only where an aligned word would reach
// outside the buffer (its first or last row).  A warp's rows are
// neighbours, so the sectors one load misses the next loads of the warp
// find in L1.  One pass masks the words past the length and, for a row
// no longer than the buffer, places the 0x80 terminator in the same
// select.  The block count is a runtime loop: ceil((length + 9) / 64)
// blocks for the row's own length, at most ceil((width + 9) / 64) — the
// reference's static count for the buffer.  Built once per hash
// (-DPIECE_ALGO=n).
//
// The tiled layout — persistent CTAs, each tile of rows copied into
// shared memory with 16-byte cp.async through a two-stage ring, the rows
// read back from shared memory through the same `hash_row` — is
// scripts/torch_buffer_hash_tiled.cu; scripts/torch_buffer_hash_layouts.py
// times both in one process.  On the H100 it is slower at every width and
// hash but NTLM's aligned widths up to 56 (PERF.md §6): the loads were
// never what held the kernel back; the instructions around the
// compressions were.

#include "hash_common.cuh"

// Everything one launch reads.
struct BhArgs {
    const uint8_t* msg;   // [n, width], rows contiguous
    const int32_t* len;   // [n]
    long long n;
    int width;
    int32_t* state;       // [n, 4|5]
};

// Bytes [o, o + 4) of a row as a little-endian word, byte by byte, bytes
// at and past `lim` (the row's data length, at most its width) read as
// zero.
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, int lim,
                                             int o) {
    if (o >= lim) return 0u;
    uint32_t w = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (o + i < lim) w |= (uint32_t)row[o + i] << (8 * i);
    }
    return w;
}

// A row read straight from global memory: words q = 0..NQ-1 of its bytes
// [base + 4q, base + 4q + 4) (`base` a multiple of 4); words past `lim`
// are zero, the word holding byte lim is left for the caller to mask.
// `covered`: the aligned words over the row's bytes [0, lim) lie inside
// the buffer, so they are loaded whole.
template <bool ALIGNED>
struct GlobalRow {
    const uint8_t* row;
    int lim;
    bool covered;
    template <int NQ>
    __device__ __forceinline__ void words(int base, uint32_t (&d)[NQ]) const {
        if (ALIGNED) {
            const uint32_t* w = reinterpret_cast<const uint32_t*>(row + base);
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                d[q] = base + 4 * q < lim ? w[q] : 0u;
            }
        } else if (covered) {
            const uintptr_t at = reinterpret_cast<uintptr_t>(row + base);
            const int mis = (int)(at & 3u);
            const uint32_t* w = reinterpret_cast<const uint32_t*>(at - mis);
            uint32_t x[NQ + 1];
#pragma unroll
            for (int j = 0; j <= NQ; ++j) {
                x[j] = base + 4 * j - mis < lim ? w[j] : 0u;
            }
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                d[q] = __funnelshift_r(x[q], x[q + 1], 8 * mis);
            }
        } else {
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                d[q] = row_word(row, lim, base + 4 * q);
            }
        }
    }
};

// The state of one row of length L (in 0..width for a defined result)
// in a buffer of `width`, its data bytes the first
// lim = clamp(L, 0, width): `src.words(o, d)` fills d[] (16 words; 8 for
// NTLM) with the row's bytes from byte o; bytes at and past lim are
// zeroed here.
template <int ALGO, class Src>
__device__ __forceinline__ void hash_row(int L, int lim, int width,
                                         const Src& src, uint32_t* st) {
    constexpr int SCALE = Hash<ALGO>::SCALE;
    constexpr int NQ = 16 / SCALE;  // data words per 64-byte block
    const int wl = L * SCALE;  // message length in bytes
    // The row's own block count (floor division, as the reference's
    // int32 `//`), and the buffer's static count.
    const int own = wl >= -72 ? (wl + 72) / 64 : -1;
    const int nb = (width * SCALE + 9 + 63) / 64;
    const int nrun = min(own, nb);
    st[0] = 0x67452301u;
    st[1] = 0xefcdab89u;
    st[2] = 0x98badcfeu;
    st[3] = 0x10325476u;
    st[4] = 0xc3d2e1f0u;
#pragma unroll 1
    for (int k = 0; k < nrun; ++k) {
        uint32_t m[16];
        uint32_t d[NQ];
        src.words(NQ * 4 * k, d);
        // Data bytes of this window: words below pq whole, word pq cut to
        // its first rem & 3 bytes, the rest zero; where the terminator
        // falls at the data's end (L == lim, not NTLM) it joins word pq.
        const int rem = lim - NQ * 4 * k;
        const int pq = rem >> 2;
        const uint32_t pm = (1u << (8 * (rem & 3))) - 1u;
        const bool merged = ALGO != ALGO_NTLM && L == lim;
        const uint32_t tb = merged ? 0x80u << (8 * (rem & 3)) : 0u;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
            d[q] = q < pq ? d[q] : (q == pq ? (d[q] & pm) | tb : 0u);
        }
        if (ALGO == ALGO_NTLM) {
#pragma unroll
            for (int p = 0; p < 8; ++p) {
                m[2 * p] = (d[p] & 0xFFu) | ((d[p] & 0xFF00u) << 8);
                m[2 * p + 1] = ((d[p] >> 16) & 0xFFu) | ((d[p] >> 24) << 16);
            }
        } else {
#pragma unroll
            for (int q = 0; q < 16; ++q) m[q] = d[q % NQ];
        }
        const int t = wl - 64 * k;  // terminator offset in this block
        if (!merged) {
#pragma unroll
            for (int q = 0; q < 16; ++q) {
                if (t >= 0 && (t >> 2) == q) m[q] |= 0x80u << (8 * (t & 3));
            }
        }
        if (k == own - 1) {
            const uint32_t lo32 = (uint32_t)wl * 8u;
            const uint32_t hi32 = (uint32_t)wl >> 29;
            if (ALGO == ALGO_SHA1) {
                m[14] |= bswap32(hi32);
                m[15] |= bswap32(lo32);
            } else {
                m[14] |= lo32;
                m[15] |= hi32;
            }
        }
        compress<ALGO>(st, m);
    }
}

// One thread per row: the state of row r of length L (each in 0..width
// for a defined result; its data bytes are the first
// lim = clamp(L, 0, width)).
template <int ALGO, bool ALIGNED>
__global__ void buffer_hash_kernel(BhArgs a) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= a.n) return;
    const uint8_t* row = a.msg + r * (long long)a.width;
    const int L = a.len[r];
    const int lim = min(max(L, 0), a.width);
    const uintptr_t lo = reinterpret_cast<uintptr_t>(row) & ~(uintptr_t)3;
    const uintptr_t hi = (reinterpret_cast<uintptr_t>(row) + lim + 3)
        & ~(uintptr_t)3;
    const bool covered = lo >= reinterpret_cast<uintptr_t>(a.msg)
        && hi <= reinterpret_cast<uintptr_t>(a.msg + a.n * (long long)a.width);
    uint32_t st[5];
    hash_row<ALGO>(L, lim, a.width, GlobalRow<ALIGNED>{row, lim, covered},
                   st);
    store_state<ALGO>(a.state, r, st);
}

// ---- host launch wrapper ----

#ifndef PIECE_ALGO
#define PIECE_ALGO ALGO_MD5
#endif

extern "C" {

// Hash `n` rows of `msg` (uint8[n, width]) with lengths `len` (int32[n],
// each in 0..width for a defined result) into `state` (int32[n, 4], or
// [n, 5] for SHA-1) on `stream`.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for arguments it refuses.
int a5_buffer_hash(const void* msg, const void* len, long long n, int width,
                   void* state, void* stream) {
    if (n < 0 || width < 0
        || (n > 0 && (!len || !state || (width > 0 && !msg)))) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return (int)cudaSuccess;
    const long long blocks = (n + 255) / 256;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    BhArgs a;
    a.msg = static_cast<const uint8_t*>(msg);
    a.len = static_cast<const int32_t*>(len);
    a.n = n;
    a.width = width;
    a.state = static_cast<int32_t*>(state);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (width % 4 == 0 && reinterpret_cast<uintptr_t>(msg) % 4 == 0) {
        buffer_hash_kernel<PIECE_ALGO, true><<<(unsigned)blocks, 256, 0, s>>>(a);
    } else {
        buffer_hash_kernel<PIECE_ALGO, false><<<(unsigned)blocks, 256, 0, s>>>(a);
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
