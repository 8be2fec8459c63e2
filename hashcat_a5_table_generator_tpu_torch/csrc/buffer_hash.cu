// Buffer hash kernel for Hopper (sm_90a): MD5, MD4, SHA-1 or NTLM of
// candidate byte rows, one row per thread — the hash half of the XLA
// expand + hash route, which takes every plan the fused kernels refuse.
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
// Work layout: one thread per row.  A thread builds each 64-byte block's
// sixteen words in registers from its row (4-byte loads when the row
// width is a multiple of 4, byte loads otherwise; nothing past the row's
// width is read), ORs in the terminator and the length words, and
// compresses with hash_common.cuh.  The block count is a runtime loop:
// ceil((length + 9) / 64) blocks for the row's own length, at most
// ceil((width + 9) / 64) — the reference's static count for the buffer.
//
// What bounds it on the H100: integer throughput.  A compression costs
// ~320 INT32 instructions for MD5, ~176 for MD4/NTLM and ~608 for SHA-1
// against 64 bytes of input, so the kernel needs ~5-10 instructions per
// byte read; at 1.67e13 INT32 ops/s and 3.35e12 B/s the operations bound
// it.  A warp's loads are strided by the row width (each thread its own
// row): uncoalesced, but each 32-byte sector a thread touches is reused
// by its next loads from L1.  Built once per hash (-DPIECE_ALGO=n).

#include "hash_common.cuh"

// Bytes [o, o + 4) of `row` as a little-endian word, bytes at and past
// `lim` (the row's data length, at most its width) read as zero.
__device__ __forceinline__ uint32_t row_word(const uint8_t* row, int lim,
                                             int o, bool aligned) {
    if (o >= lim) return 0u;
    if (aligned && o + 4 <= lim) {
        return *reinterpret_cast<const uint32_t*>(row + o);
    }
    uint32_t w = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        if (o + i < lim) w |= (uint32_t)row[o + i] << (8 * i);
    }
    return w;
}

// One thread per row: `msg` uint8[n, width] (rows contiguous), `len`
// int32[n], `state` int32[n, 4|5].  `aligned`: the rows start on 4-byte
// boundaries (width % 4 == 0 and a 4-byte-aligned buffer).
template <int ALGO>
__global__ void buffer_hash_kernel(const uint8_t* __restrict__ msg,
                                   const int32_t* __restrict__ len,
                                   long long n, int width, bool aligned,
                                   int32_t* __restrict__ state) {
    const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (r >= n) return;
    constexpr int SCALE = Hash<ALGO>::SCALE;
    const uint8_t* row = msg + r * (long long)width;
    const int L = len[r];
    const int lim = min(max(L, 0), width);
    const int wl = L * SCALE;  // message length in bytes
    // The row's own block count (floor division, as the reference's
    // int32 `//`), and the buffer's static count.
    const int own = wl >= -72 ? (wl + 72) / 64 : -1;
    const int nb = (width * SCALE + 9 + 63) / 64;
    const int nrun = min(own, nb);
    uint32_t st[5];
    st[0] = 0x67452301u;
    st[1] = 0xefcdab89u;
    st[2] = 0x98badcfeu;
    st[3] = 0x10325476u;
    st[4] = 0xc3d2e1f0u;
#pragma unroll 1
    for (int k = 0; k < nrun; ++k) {
        uint32_t m[16];
        const int t = wl - 64 * k;  // terminator offset in this block
        if (ALGO == ALGO_NTLM) {
#pragma unroll
            for (int p = 0; p < 8; ++p) {
                const uint32_t sw = row_word(row, lim, 32 * k + 4 * p,
                                             aligned);
                m[2 * p] = (sw & 0xFFu) | ((sw & 0xFF00u) << 8);
                m[2 * p + 1] = ((sw >> 16) & 0xFFu) | ((sw >> 24) << 16);
            }
        } else {
#pragma unroll
            for (int q = 0; q < 16; ++q) {
                m[q] = row_word(row, lim, 64 * k + 4 * q, aligned);
            }
        }
#pragma unroll
        for (int q = 0; q < 16; ++q) {
            if (t >= 0 && (t >> 2) == q) m[q] |= 0x80u << (8 * (t & 3));
        }
        if (k == own - 1) {
            const uint32_t lo = (uint32_t)wl * 8u;
            const uint32_t hi = (uint32_t)wl >> 29;
            if (ALGO == ALGO_SHA1) {
                m[14] |= bswap32(hi);
                m[15] |= bswap32(lo);
            } else {
                m[14] |= lo;
                m[15] |= hi;
            }
        }
        compress<ALGO>(st, m);
    }
    store_state<ALGO>(state, r, st);
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
                   int aligned, void* state, void* stream) {
    if (n < 0 || width < 0
        || (n > 0 && (!len || !state || (width > 0 && !msg)))) {
        return (int)cudaErrorInvalidValue;
    }
    if (n == 0) return (int)cudaSuccess;
    const unsigned threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    buffer_hash_kernel<PIECE_ALGO>
        <<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
            static_cast<const uint8_t*>(msg),
            static_cast<const int32_t*>(len), n, width, aligned != 0,
            static_cast<int32_t*>(state));
    return (int)cudaGetLastError();
}

}  // extern "C"
