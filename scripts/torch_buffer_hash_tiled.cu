// The tiled layout of the buffer hash, kept to be measured beside the
// layout the port ships (csrc/buffer_hash.cu: one thread per row, words
// loaded straight from global memory); scripts/torch_buffer_hash_layouts.py
// builds it, holds it against the plain version and times both.
//
// Layout: persistent CTAs walk tiles of R consecutive rows (R = the CTA's
// threads, a multiple of 16: 256 for rows up to 96 bytes, fewer for
// wider rows so that a stage stays near 24 KB).  A tile is R * width
// contiguous bytes; it comes into shared memory with 16-byte cp.async
// copies (the ragged tail of the last tile, and buffers that are not
// 16-byte aligned, with plain loads) into a ring of two stages, so the
// next tile's copy runs under this tile's compressions.  Each thread
// then hashes its row from shared memory through the shipped kernel's
// `hash_row`: aligned 4-byte reads funnel-shifted to the row's byte
// offset (odd strides), aligned 4-byte reads (strides that are
// multiples of 4) or 16-byte reads (multiples of 16); no byte loads.
// Where width is a multiple of 32 the stage pads each row by 16 bytes so
// that the 16-byte reads of neighbouring threads hit distinct banks.
// Rows wider than BH_MAX_STAGED_WIDTH take the shipped kernel.
//
// Build (one library per hash, n = 0..3 for md5, md4, sha1, ntlm):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//     -Xcompiler -fPIC -I hashcat_a5_table_generator_tpu_torch/csrc \
//     -DPIECE_ALGO=n -o libbuffer_hash_tiled_<algo>.so \
//     scripts/torch_buffer_hash_tiled.cu

#include "buffer_hash.cu"

#define BH_MAX_STAGED_WIDTH 2048
// Bytes after a stage's last row that a window may over-read: a 64-byte
// window (+4 for the funnel shift) starting up to width + 8 bytes in.
#define BH_SLACK 96

#define BH_MODE_FUNNEL 0  // odd row strides: funnel-shifted 4-byte reads
#define BH_MODE_WORD 1    // row strides that are multiples of 4
#define BH_MODE_VEC 2     // row strides that are multiples of 16

struct TileArgs {
    BhArgs a;
    int async_ok;         // msg 16-byte aligned: tiles copy with cp.async
    int rows;             // rows per tile = threads per CTA
    int pstride;          // bytes between rows in a stage
    int stage_bytes;      // bytes per stage, BH_SLACK included
    long long ntiles;
};

static inline void tile_geometry(TileArgs& t) {
    const int w = t.a.width;
    int rows = w <= 96 ? 256 : ((24 * 1024 / w) & ~15);
    t.rows = rows < 32 ? 32 : rows;
    t.pstride = w > 0 && w % 32 == 0 ? w + 16 : w;
    t.stage_bytes = (t.rows * t.pstride + BH_SLACK + 15) & ~15;
    t.ntiles = (t.a.n + t.rows - 1) / t.rows;
}

__device__ __forceinline__ void async_copy16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(src));
}

__device__ __forceinline__ void async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// A row staged in shared memory, read in MODE: the raw words q = 0..NQ-1
// of its bytes [base + 4q, base + 4q + 4) (`base` a multiple of 4; bytes
// past the row are garbage, which hash_row masks).  The stage's slack
// keeps every window inside it.
template <int MODE>
struct SmemRow {
    const uint8_t* row;
    template <int NQ>
    __device__ __forceinline__ void words(int base, uint32_t (&d)[NQ]) const {
        if (MODE == BH_MODE_VEC) {
            const uint4* w4 = reinterpret_cast<const uint4*>(row + base);
#pragma unroll
            for (int v = 0; v < NQ / 4; ++v) {
                const uint4 x = w4[v];
                d[4 * v] = x.x;
                d[4 * v + 1] = x.y;
                d[4 * v + 2] = x.z;
                d[4 * v + 3] = x.w;
            }
        } else if (MODE == BH_MODE_WORD) {
            const uint32_t* w = reinterpret_cast<const uint32_t*>(row + base);
#pragma unroll
            for (int q = 0; q < NQ; ++q) d[q] = w[q];
        } else {
            const uintptr_t at = reinterpret_cast<uintptr_t>(row + base);
            const int mis = (int)(at & 3u);
            const uint32_t* w = reinterpret_cast<const uint32_t*>(at - mis);
            uint32_t x[NQ + 1];
#pragma unroll
            for (int j = 0; j <= NQ; ++j) x[j] = w[j];
#pragma unroll
            for (int q = 0; q < NQ; ++q) {
                d[q] = __funnelshift_r(x[q], x[q + 1], 8 * mis);
            }
        }
    }
};

// Copy tile `tile`'s rows into a stage (every thread its share): 16-byte
// cp.async chunks, then plain loads for the tail the chunks do not cover
// (all of it when the buffer is not 16-byte aligned).
__device__ __forceinline__ void tile_stage(const TileArgs& t, long long tile,
                                           uint8_t* dst) {
    const long long r0 = tile * t.rows;
    const long long left = t.a.n - r0;
    const int nrows = (int)(left < t.rows ? left : t.rows);
    const int width = t.a.width;
    const uint8_t* src = t.a.msg + r0 * width;
    const int tid = threadIdx.x, nt = blockDim.x;
    if (t.pstride == width) {
        const int nbytes = nrows * width;
        const int full = t.async_ok ? nbytes >> 4 : 0;
        for (int c = tid; c < full; c += nt) {
            async_copy16(dst + 16 * c, src + 16 * c);
        }
        for (int b = 16 * full + tid; b < nbytes; b += nt) dst[b] = src[b];
        return;
    }
    // Padded stride (width a multiple of 32): whole 16-byte chunks.
    const int cw = width >> 4;
    for (int c = tid; c < nrows * cw; c += nt) {
        const int r = c / cw, k = c - r * cw;
        const uint8_t* from = src + (size_t)r * width + 16 * k;
        uint8_t* to = dst + r * t.pstride + 16 * k;
        if (t.async_ok) {
            async_copy16(to, from);
        } else {
            for (int i = 0; i < 16; ++i) to[i] = from[i];
        }
    }
}

// Persistent CTAs over the tiles, a ring of two stages: the next tile's
// copy is issued before this tile's rows are hashed.
template <int ALGO, int MODE>
__global__ void buffer_hash_tiled_kernel(TileArgs t) {
    DYN_SMEM(smem);
    long long tile = blockIdx.x;
    int slot = 0;
    if (tile < t.ntiles) tile_stage(t, tile, smem);
    async_commit();
    for (; tile < t.ntiles; tile += gridDim.x) {
        const long long next = tile + gridDim.x;
        if (next < t.ntiles) {
            tile_stage(t, next, smem + (slot ^ 1) * t.stage_bytes);
        }
        async_commit();
        async_wait<1>();
        __syncthreads();
        const long long r = tile * t.rows + threadIdx.x;
        if (r < t.a.n) {
            const int L = t.a.len[r];
            uint32_t st[5];
            hash_row<ALGO>(L, min(max(L, 0), t.a.width), t.a.width,
                           SmemRow<MODE>{smem + slot * t.stage_bytes
                                         + threadIdx.x * t.pstride},
                           st);
            store_state<ALGO>(t.a.state, r, st);
        }
        __syncthreads();
        slot ^= 1;
    }
}

template <int MODE>
static int launch_tiled(const TileArgs& t, cudaStream_t s) {
    auto kern = buffer_hash_tiled_kernel<PIECE_ALGO, MODE>;
    const int smem = 2 * t.stage_bytes;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0, dev = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, t.rows,
                                                      smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    const long long fill = (long long)(per_sm > 0 ? per_sm : 1) * sms;
    const unsigned grid = (unsigned)(t.ntiles < fill ? t.ntiles : fill);
    kern<<<grid, t.rows, smem, s>>>(t);
    return (int)cudaGetLastError();
}

extern "C" {

// As a5_buffer_hash, in the tiled layout.
int a5_buffer_hash_tiled(const void* msg, const void* len, long long n,
                         int width, void* state, void* stream) {
    if (width > BH_MAX_STAGED_WIDTH || n <= 0) {
        return a5_buffer_hash(msg, len, n, width, state, stream);
    }
    if (width < 0 || !len || !state || (width > 0 && !msg)) {
        return (int)cudaErrorInvalidValue;
    }
    TileArgs t;
    t.a.msg = static_cast<const uint8_t*>(msg);
    t.a.len = static_cast<const int32_t*>(len);
    t.a.n = n;
    t.a.width = width;
    t.a.state = static_cast<int32_t*>(state);
    t.async_ok = reinterpret_cast<uintptr_t>(msg) % 16 == 0;
    tile_geometry(t);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (t.pstride % 16 == 0) return launch_tiled<BH_MODE_VEC>(t, s);
    if (t.pstride % 4 == 0) return launch_tiled<BH_MODE_WORD>(t, s);
    return launch_tiled<BH_MODE_FUNNEL>(t, s);
}

}  // extern "C"
