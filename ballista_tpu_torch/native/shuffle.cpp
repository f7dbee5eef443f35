// Native shuffle partitioner.
//
// The repartition-exchange host path (the data plane the reference implements
// in Rust: hash partitioning in RepartitionExec + the shuffle writer split,
// ref rust/executor/src/flight_service.rs + execution_plans) implemented in
// C++: splitmix64 row hashing over Arrow column buffers and a counting-sort
// partition split producing contiguous per-partition row-index ranges —
// O(n + P) instead of the O(n*P) per-partition filter loop.
//
// Build: g++ -O3 -shared -fPIC -o libballista_shuffle.so shuffle.cpp
// Bound via ctypes (no pybind11 in the toolchain).

#include <cstdint>
#include <cstring>

static inline uint64_t splitmix64(uint64_t x) {
    uint64_t z = x + 0x9E3779B97F4A7C15ULL;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
    return z ^ (z >> 31);
}

extern "C" {

// Mix an int64 key column into the per-row hash accumulator.
void hash_mix_i64(const int64_t* keys, int64_t n, uint64_t* acc) {
    for (int64_t i = 0; i < n; i++) {
        acc[i] = splitmix64(acc[i] ^ splitmix64((uint64_t)keys[i]));
    }
}

// Mix an int32 key column (dates, dictionary codes).
void hash_mix_i32(const int32_t* keys, int64_t n, uint64_t* acc) {
    for (int64_t i = 0; i < n; i++) {
        acc[i] = splitmix64(acc[i] ^ splitmix64((uint64_t)(int64_t)keys[i]));
    }
}

// Mix a float64 key column (bit pattern).
void hash_mix_f64(const double* keys, int64_t n, uint64_t* acc) {
    for (int64_t i = 0; i < n; i++) {
        uint64_t bits;
        std::memcpy(&bits, &keys[i], sizeof(bits));
        acc[i] = splitmix64(acc[i] ^ splitmix64(bits));
    }
}

// Mix a UTF-8 string column (Arrow offsets + data buffers), FNV-1a per row.
void hash_mix_str(const int32_t* offsets, const uint8_t* data, int64_t n,
                  uint64_t* acc) {
    for (int64_t i = 0; i < n; i++) {
        uint64_t h = 0xCBF29CE484222325ULL;
        for (int32_t j = offsets[i]; j < offsets[i + 1]; j++) {
            h = (h ^ data[j]) * 0x100000001B3ULL;
        }
        acc[i] = splitmix64(acc[i] ^ h);
    }
}

// Finalize: map accumulated hashes to partition ids.
void hash_to_partitions(const uint64_t* acc, int64_t n, uint32_t num_parts,
                        int32_t* out_part_ids) {
    for (int64_t i = 0; i < n; i++) {
        out_part_ids[i] = (int32_t)(acc[i] % (uint64_t)num_parts);
    }
}

// Counting sort by partition id: emits row indices grouped by partition
// (out_indices) and partition offsets (out_offsets, length num_parts+1).
void partition_indices(const int32_t* part_ids, int64_t n, uint32_t num_parts,
                       int64_t* out_indices, int64_t* out_offsets) {
    for (uint32_t p = 0; p <= num_parts; p++) out_offsets[p] = 0;
    for (int64_t i = 0; i < n; i++) out_offsets[part_ids[i] + 1]++;
    for (uint32_t p = 0; p < num_parts; p++) out_offsets[p + 1] += out_offsets[p];
    // stable fill
    int64_t* cursor = new int64_t[num_parts];
    for (uint32_t p = 0; p < num_parts; p++) cursor[p] = out_offsets[p];
    for (int64_t i = 0; i < n; i++) {
        out_indices[cursor[part_ids[i]]++] = i;
    }
    delete[] cursor;
}

}  // extern "C"
