// Native host-side FITS decode/encode kernels.
//
// The analog of the reference's Rust mmap reader hot path
// (reference: src-tauri/src/infra/fits/reader.rs:42-101 decode_pixels
// and writer.rs big-endian encoders): big-endian BITPIX
// {8,16,32,-32,-64} to float32 with BSCALE/BZERO, OpenMP-parallel.
// Exposed as a plain C ABI consumed via ctypes
// (astroburst_tpu/native/__init__.py); numpy remains the fallback.

#include <cstdint>
#include <cstring>

#include <unistd.h>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// unaligned word load + bswap intrinsic: GCC vectorizes these loops
// (VPSHUFB on x86) where the shift-or byte form stays scalar.
inline uint16_t load_be16(const uint8_t* p) {
    uint16_t v;
    std::memcpy(&v, p, 2);
    return __builtin_bswap16(v);
}

inline uint32_t load_be32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return __builtin_bswap32(v);
}

inline uint64_t load_be64(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return __builtin_bswap64(v);
}

}  // namespace

extern "C" {

// Decode n big-endian pixels of the given BITPIX into float32 with
// physical = raw * bscale + bzero (identity fast path for -32).
// Returns 0 on success, -1 for unsupported bitpix.
int astro_decode_pixels(const uint8_t* src, float* dst, int64_t n,
                        int bitpix, double bscale, double bzero) {
    const bool identity = (bscale == 1.0 && bzero == 0.0);
    switch (bitpix) {
        case 8: {
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < n; ++i) {
                dst[i] = static_cast<float>(src[i] * bscale + bzero);
            }
            return 0;
        }
        case 16: {
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < n; ++i) {
                int16_t v = static_cast<int16_t>(load_be16(src + 2 * i));
                dst[i] = static_cast<float>(v * bscale + bzero);
            }
            return 0;
        }
        case 32: {
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < n; ++i) {
                int32_t v = static_cast<int32_t>(load_be32(src + 4 * i));
                dst[i] = static_cast<float>(v * bscale + bzero);
            }
            return 0;
        }
        case -32: {
            if (identity) {
#pragma omp parallel for schedule(static)
                for (int64_t i = 0; i < n; ++i) {
                    uint32_t bits = load_be32(src + 4 * i);
                    float f;
                    std::memcpy(&f, &bits, 4);
                    dst[i] = f;
                }
            } else {
#pragma omp parallel for schedule(static)
                for (int64_t i = 0; i < n; ++i) {
                    uint32_t bits = load_be32(src + 4 * i);
                    float f;
                    std::memcpy(&f, &bits, 4);
                    dst[i] = static_cast<float>(
                        static_cast<double>(f) * bscale + bzero);
                }
            }
            return 0;
        }
        case -64: {
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < n; ++i) {
                uint64_t bits = load_be64(src + 8 * i);
                double d;
                std::memcpy(&d, &bits, 8);
                dst[i] = static_cast<float>(d * bscale + bzero);
            }
            return 0;
        }
        default:
            return -1;
    }
}

// Encode float32 → big-endian f32 (BITPIX -32 writer path).
void astro_encode_be_f32(const float* src, uint8_t* dst, int64_t n) {
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, &src[i], 4);
        bits = __builtin_bswap32(bits);
        std::memcpy(dst + 4 * i, &bits, 4);
    }
}

// Encode float32 → big-endian i16 with (v - bzero) / bscale, rounded
// and clamped (writer.rs:102-119).
void astro_encode_be_i16(const float* src, uint8_t* dst, int64_t n,
                         double bzero, double bscale) {
    const double inv = 1.0 / bscale;
#pragma omp parallel for schedule(static)
    for (int64_t i = 0; i < n; ++i) {
        double physical = (static_cast<double>(src[i]) - bzero) * inv;
        if (physical > 32767.0) physical = 32767.0;
        if (physical < -32768.0) physical = -32768.0;
        int16_t v = static_cast<int16_t>(physical >= 0.0
                                             ? physical + 0.5
                                             : physical - 0.5);
        uint16_t bits = __builtin_bswap16(static_cast<uint16_t>(v));
        std::memcpy(dst + 2 * i, &bits, 2);
    }
}

// Encode float32 → big-endian payload and write() it to an open fd in
// cache-resident chunks: the source crosses DRAM once and the bounce
// buffer stays hot in L2, where encode-to-a-full-size-buffer +
// f.write() re-reads the whole cold payload a third time. Returns 0 on
// success, -1 on a short/failed write or unsupported bitpix.
int astro_encode_be_to_fd(const float* src, int64_t n, int bitpix,
                          double bzero, double bscale, int fd) {
    constexpr int64_t kChunkBytes = 4 << 20;
    static thread_local uint8_t tls_buf[kChunkBytes];
    uint8_t* const buf = tls_buf;  // resolve TLS once, OUTSIDE the
                                   // omp regions (workers would
                                   // otherwise hit their own copies)
    const int bpp = bitpix == 16 ? 2 : 4;
    if (bitpix != 16 && bitpix != -32) return -1;
    const double inv = bitpix == 16 ? 1.0 / bscale : 0.0;
    const int64_t per_chunk = kChunkBytes / bpp;
    for (int64_t start = 0; start < n; start += per_chunk) {
        const int64_t cnt = n - start < per_chunk ? n - start : per_chunk;
        if (bitpix == -32) {
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < cnt; ++i) {
                uint32_t bits;
                std::memcpy(&bits, &src[start + i], 4);
                bits = __builtin_bswap32(bits);
                std::memcpy(buf + 4 * i, &bits, 4);
            }
        } else {
#pragma omp parallel for schedule(static)
            for (int64_t i = 0; i < cnt; ++i) {
                double physical =
                    (static_cast<double>(src[start + i]) - bzero) * inv;
                if (physical > 32767.0) physical = 32767.0;
                if (physical < -32768.0) physical = -32768.0;
                int16_t v = static_cast<int16_t>(physical >= 0.0
                                                     ? physical + 0.5
                                                     : physical - 0.5);
                uint16_t bits = __builtin_bswap16(static_cast<uint16_t>(v));
                std::memcpy(buf + 2 * i, &bits, 2);
            }
        }
        int64_t todo = cnt * bpp;
        const uint8_t* p = buf;
        while (todo > 0) {
            int64_t wrote = write(fd, p, static_cast<size_t>(todo));
            if (wrote <= 0) return -1;
            todo -= wrote;
            p += wrote;
        }
    }
    return 0;
}

// Masked min/max/sum/count with the validity rule finite && > 1e-7
// (stats.rs:11), for host-side previews that skip the device.
void astro_masked_scan(const float* src, int64_t n, double* out_min,
                       double* out_max, double* out_sum,
                       int64_t* out_count) {
    double mn = 1e300, mx = -1e300, sum = 0.0;
    int64_t count = 0;
#pragma omp parallel for schedule(static) \
    reduction(min : mn) reduction(max : mx) reduction(+ : sum, count)
    for (int64_t i = 0; i < n; ++i) {
        float v = src[i];
        if (v == v && v <= 3.4e38f && v >= -3.4e38f && v > 1e-7f) {
            double d = v;
            if (d < mn) mn = d;
            if (d > mx) mx = d;
            sum += d;
            ++count;
        }
    }
    *out_min = mn;
    *out_max = mx;
    *out_sum = sum;
    *out_count = count;
}

}  // extern "C"
