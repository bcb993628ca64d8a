// Native host-side bitmap kernels (C ABI, loaded via ctypes).
//
// The TPU owns the query hot path (Pallas/XLA bitplane kernels); these are
// the host runtime's compiled kernels: bitplane packing for device upload,
// sorted-container set ops for the cold/roaring path, and popcounts — the
// CPU-fallback tier of the framework (the reference's equivalents are the
// roaring container routines, reference roaring/roaring.go:1836-3375).
//
// Build: make -C pilosa_tpu/native  (produces libbitmap_ops.so)

#include <cstdint>
#include <cstddef>
#include <cstring>

extern "C" {

// Set bit positions cols[0..n) (each < n_words*32) in a zeroed word buffer.
void pack_bits(const uint32_t* cols, size_t n, uint32_t* words) {
    for (size_t i = 0; i < n; i++) {
        uint32_t c = cols[i];
        words[c >> 5] |= (1u << (c & 31u));
    }
}

// Extract set bit positions from a bitplane; returns count written.
size_t unpack_bits(const uint32_t* words, size_t n_words, uint32_t* out) {
    size_t k = 0;
    for (size_t w = 0; w < n_words; w++) {
        uint32_t v = words[w];
        while (v) {
            uint32_t b = __builtin_ctz(v);
            out[k++] = (uint32_t)(w * 32 + b);
            v &= v - 1;
        }
    }
    return k;
}

uint64_t popcount_words(const uint32_t* words, size_t n) {
    uint64_t total = 0;
    for (size_t i = 0; i < n; i++) total += __builtin_popcount(words[i]);
    return total;
}

uint64_t and_count_words(const uint32_t* a, const uint32_t* b, size_t n) {
    uint64_t total = 0;
    for (size_t i = 0; i < n; i++) total += __builtin_popcount(a[i] & b[i]);
    return total;
}

// Sorted uint16 container ops (roaring array containers).

uint64_t intersection_count_u16(const uint16_t* a, size_t na,
                                const uint16_t* b, size_t nb) {
    size_t i = 0, j = 0;
    uint64_t n = 0;
    while (i < na && j < nb) {
        uint16_t x = a[i], y = b[j];
        n += (x == y);
        i += (x <= y);
        j += (y <= x);
    }
    return n;
}

size_t intersect_u16(const uint16_t* a, size_t na, const uint16_t* b, size_t nb,
                     uint16_t* out) {
    size_t i = 0, j = 0, k = 0;
    while (i < na && j < nb) {
        uint16_t x = a[i], y = b[j];
        if (x == y) out[k++] = x;
        i += (x <= y);
        j += (y <= x);
    }
    return k;
}

size_t union_u16(const uint16_t* a, size_t na, const uint16_t* b, size_t nb,
                 uint16_t* out) {
    size_t i = 0, j = 0, k = 0;
    while (i < na && j < nb) {
        uint16_t x = a[i], y = b[j];
        if (x < y)      { out[k++] = x; i++; }
        else if (y < x) { out[k++] = y; j++; }
        else            { out[k++] = x; i++; j++; }
    }
    while (i < na) out[k++] = a[i++];
    while (j < nb) out[k++] = b[j++];
    return k;
}

size_t difference_u16(const uint16_t* a, size_t na, const uint16_t* b, size_t nb,
                      uint16_t* out) {
    size_t i = 0, j = 0, k = 0;
    while (i < na && j < nb) {
        uint16_t x = a[i], y = b[j];
        if (x < y)      { out[k++] = x; i++; }
        else if (y < x) { j++; }
        else            { i++; j++; }
    }
    while (i < na) out[k++] = a[i++];
    return k;
}

size_t xor_u16(const uint16_t* a, size_t na, const uint16_t* b, size_t nb,
               uint16_t* out) {
    size_t i = 0, j = 0, k = 0;
    while (i < na && j < nb) {
        uint16_t x = a[i], y = b[j];
        if (x < y)      { out[k++] = x; i++; }
        else if (y < x) { out[k++] = y; j++; }
        else            { i++; j++; }
    }
    while (i < na) out[k++] = a[i++];
    while (j < nb) out[k++] = b[j++];
    return k;
}

}  // extern "C"
