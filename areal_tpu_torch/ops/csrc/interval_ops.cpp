// Host-side batched interval copies and first-fit-decreasing bin packing:
// the inner loops of the port's fixed-shape micro-batch packer
// (areal_tpu_torch/models/packing.py batch_from_packed, base/datapack.py
// ffd_allocate). NumPy scatters a packed 1-D token stream into [R, L] grids
// with one Python slice assignment per sequence; here it is one C call per
// key with tight memcpy loops.
//
// C ABI only, loaded through ctypes (areal_tpu_torch/ops/native.py), which
// builds it with g++ at first use. All offsets are in ELEMENTS; `itemsize`
// converts to bytes, so one entry point serves any fixed-size dtype. The
// caller checks every interval against the grid and the flat buffer before
// a pointer reaches these loops.

#include <cstdint>
#include <cstring>

extern "C" {

// dst[rows[i], cols[i] : cols[i]+lens[i]] = src[offs[i] : offs[i]+lens[i]]
// dst is a [R, L, inner] row-major grid; inner elements per position are
// folded into itemsize by the caller.
void scatter_intervals(
    const uint8_t* src,
    uint8_t* dst,
    const int64_t* rows,
    const int64_t* cols,
    const int64_t* lens,
    const int64_t* offs,
    int64_t n_intervals,
    int64_t row_stride_elems,  // L * inner
    int64_t itemsize
) {
    for (int64_t i = 0; i < n_intervals; ++i) {
        std::memcpy(
            dst + (rows[i] * row_stride_elems + cols[i]) * itemsize,
            src + offs[i] * itemsize,
            static_cast<size_t>(lens[i]) * itemsize
        );
    }
}

// out[offs[i] : offs[i]+lens[i]] = src[rows[i], cols[i] : cols[i]+lens[i]]
void gather_intervals(
    const uint8_t* src,
    uint8_t* out,
    const int64_t* rows,
    const int64_t* cols,
    const int64_t* lens,
    const int64_t* offs,
    int64_t n_intervals,
    int64_t row_stride_elems,
    int64_t itemsize
) {
    for (int64_t i = 0; i < n_intervals; ++i) {
        std::memcpy(
            out + offs[i] * itemsize,
            src + (rows[i] * row_stride_elems + cols[i]) * itemsize,
            static_cast<size_t>(lens[i]) * itemsize
        );
    }
}

// First-fit-decreasing bin packing: writes each item's bin id into
// `bin_of` and the bin count into `n_bins_out`. Items are taken in the
// given (stable, decreasing-size) order and each goes to the first bin
// whose running load leaves room for it.
int64_t ffd_assign(
    const int64_t* sizes,
    const int64_t* order,   // indices sorted by decreasing size
    int64_t n,
    int64_t capacity,
    int64_t* bin_of,        // out: bin id per item
    int64_t* loads,         // scratch: at least n entries
    int64_t* n_bins_out
) {
    int64_t n_bins = 0;
    for (int64_t k = 0; k < n; ++k) {
        int64_t i = order[k];
        int64_t s = sizes[i];
        int64_t b = -1;
        for (int64_t j = 0; j < n_bins; ++j) {
            if (loads[j] + s <= capacity) { b = j; break; }
        }
        if (b < 0) {
            b = n_bins++;
            loads[b] = 0;
        }
        loads[b] += s;
        bin_of[i] = b;
    }
    *n_bins_out = n_bins;
    return 0;
}

}  // extern "C"
