// Host-side wordlist hot path: scan + pack, C ABI for ctypes.
//
// The reference's entire input layer is Go's bufio.Scanner feeding goroutines
// (main.go:70-94). Here the analogous hot path — splitting a rockyou-class
// dictionary into lines and packing them into fixed-width uint8 batches for
// device upload — runs as native code: one pass over the mmap'd file for
// line structure, one cache-friendly pass per width bucket for packing.
// Python (ops/packing.py) remains the reference implementation; outputs are
// bit-identical (contract-tested) and the Python path is the automatic
// fallback when this library is unavailable.
//
// Line semantics mirror bufio.ScanLines: split on '\n', drop one trailing
// '\r' per line, final unterminated line counts. Unlike the reference, an
// oversized line is an ERROR (-2), not a silent end of input (Q8).

#include <cstdint>
#include <cstddef>

extern "C" {

// Count lines in data[0..n). Returns the line count.
int64_t a5_count_lines(const uint8_t* data, int64_t n) {
    if (n == 0) return 0;
    int64_t lines = 0;
    for (int64_t i = 0; i < n; ++i) lines += (data[i] == '\n');
    if (data[n - 1] != '\n') ++lines;  // unterminated final line
    return lines;
}

// Scan line structure into offsets/lengths (caller sizes them via
// a5_count_lines). A line's payload excludes '\n' and one trailing '\r'.
// Returns 0 on success, or -2 with *bad_line set when a payload exceeds
// max_word (the anti-Q8 contract: surface, never truncate).
int32_t a5_scan_lines(const uint8_t* data, int64_t n, int64_t max_word,
                      int64_t* offsets, int32_t* lengths, int64_t* bad_line) {
    int64_t line = 0, start = 0;
    for (int64_t i = 0; i <= n; ++i) {
        bool eof_tail = (i == n && start < i);
        if (i < n ? (data[i] == '\n') : eof_tail) {
            int64_t len = i - start;
            if (len > 0 && data[start + len - 1] == '\r') --len;
            if (len > max_word) {
                if (bad_line) *bad_line = line;
                return -2;
            }
            offsets[line] = start;
            lengths[line] = static_cast<int32_t>(len);
            ++line;
            start = i + 1;
        }
    }
    return 0;
}

// Pack rows[sel[i]] into tokens[i * width .. ) zero-padded, i in [0, m).
// sel may be null (identity: rows 0..m-1). Rows longer than width return -3
// (callers bucket by length first, so this is a programming error).
int32_t a5_pack(const uint8_t* data, const int64_t* offsets,
                const int32_t* lengths, const int64_t* sel, int64_t m,
                int32_t width, uint8_t* tokens, int32_t* out_lengths) {
    for (int64_t i = 0; i < m; ++i) {
        int64_t row = sel ? sel[i] : i;
        int32_t len = lengths[row];
        if (len > width) return -3;
        const uint8_t* src = data + offsets[row];
        uint8_t* dst = tokens + i * width;
        int32_t j = 0;
        for (; j < len; ++j) dst[j] = src[j];
        for (; j < width; ++j) dst[j] = 0;
        out_lengths[i] = len;
    }
    return 0;
}

// ABI version tag so the Python loader can reject a stale build.
int32_t a5_native_abi(void) { return 1; }

}  // extern "C"
