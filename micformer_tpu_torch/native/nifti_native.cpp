// Native NIfTI-1 reader and resize kernels for the host data path.
//
// The port's own copy of micformer_tpu/native/nifti_native.cpp. The data
// layer reads and resizes .nii.gz volumes on the host; this library does it
// in C++:
//   * nifti_read_f32: zlib-inflate + NIfTI-1 header parse + dtype convert +
//     scl_slope/inter scaling, returning (z,y,x)-ordered float32 (the
//     SimpleITK convention the Python reader also follows).
//   * resize_trilinear_f32 / resize_nearest_f32: multithreaded separable
//     resizes.
// Exposed as a plain C ABI for ctypes.
//
// Build: micformer_tpu_torch/native/__init__.py compiles it at first use
// (g++ -O3 -shared -fPIC -std=c++17 -lz -lpthread).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

// ---------------------------------------------------------------------------
// gzip / raw file loading
// ---------------------------------------------------------------------------

static bool load_file(const char* path, std::vector<uint8_t>& out) {
    size_t n = std::strlen(path);
    bool gz = n > 3 && std::strcmp(path + n - 3, ".gz") == 0;
    if (gz) {
        gzFile f = gzopen(path, "rb");
        if (!f) return false;
        // grow in 8 MB chunks
        const size_t CH = 8u << 20;
        size_t used = 0;
        for (;;) {
            out.resize(used + CH);
            int got = gzread(f, out.data() + used, (unsigned)CH);
            if (got < 0) { gzclose(f); return false; }
            used += (size_t)got;
            if ((size_t)got < CH) break;
        }
        out.resize(used);
        gzclose(f);
        return true;
    }
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long sz = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    out.resize((size_t)sz);
    bool ok = std::fread(out.data(), 1, (size_t)sz, f) == (size_t)sz;
    std::fclose(f);
    return ok;
}

// ---------------------------------------------------------------------------
// NIfTI-1 parsing
// ---------------------------------------------------------------------------

template <typename T>
static T rd(const uint8_t* p, bool swap) {
    T v;
    std::memcpy(&v, p, sizeof(T));
    if (swap) {
        uint8_t* b = reinterpret_cast<uint8_t*>(&v);
        for (size_t i = 0; i < sizeof(T) / 2; ++i) std::swap(b[i], b[sizeof(T) - 1 - i]);
    }
    return v;
}

template <typename S>
static void convert_to_f32(const uint8_t* src, float* dst, int64_t n, bool swap,
                           float slope, float inter) {
    const S* s = reinterpret_cast<const S*>(src);
    int nthreads = (int)std::min<int64_t>(std::thread::hardware_concurrency(), 8);
    if (nthreads < 1) nthreads = 1;
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t i = lo; i < hi; ++i) {
            S v = s[i];
            if (swap) {
                uint8_t* b = reinterpret_cast<uint8_t*>(&v);
                for (size_t k = 0; k < sizeof(S) / 2; ++k) std::swap(b[k], b[sizeof(S) - 1 - k]);
            }
            dst[i] = (float)v * slope + inter;
        }
    };
    if (n < (1 << 18) || nthreads == 1) { work(0, n); return; }
    std::vector<std::thread> ts;
    int64_t step = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * step, hi = std::min<int64_t>(n, lo + step);
        if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
}

extern "C" {

// Reads a 3D NIfTI-1 volume as float32 in (z, y, x) C order.
// Returns a malloc'd buffer (caller frees via nifti_native_free) or nullptr.
// dims_out receives {z, y, x}.
float* nifti_read_f32(const char* path, int64_t dims_out[3]) {
    std::vector<uint8_t> raw;
    if (!load_file(path, raw) || raw.size() < 352) return nullptr;
    const uint8_t* h = raw.data();
    int32_t sizeof_hdr = rd<int32_t>(h, false);
    bool swap = false;
    if (sizeof_hdr != 348) {
        swap = true;
        if (rd<int32_t>(h, true) != 348) return nullptr;
    }
    int16_t ndim = rd<int16_t>(h + 40, swap);
    if (ndim < 3) return nullptr;
    int64_t nx = rd<int16_t>(h + 42, swap);
    int64_t ny = rd<int16_t>(h + 44, swap);
    int64_t nz = rd<int16_t>(h + 46, swap);
    int16_t datatype = rd<int16_t>(h + 70, swap);
    float slope = rd<float>(h + 112, swap);
    float inter = rd<float>(h + 116, swap);
    float vox_offset_f = rd<float>(h + 108, swap);
    int64_t off = (int64_t)vox_offset_f;
    if (off < 352) off = 352;
    if (slope == 0.0f) slope = 1.0f;

    int64_t n = nx * ny * nz;
    int itemsize;
    switch (datatype) {
        case 2: itemsize = 1; break;     // uint8
        case 4: itemsize = 2; break;     // int16
        case 8: itemsize = 4; break;     // int32
        case 16: itemsize = 4; break;    // float32
        case 64: itemsize = 8; break;    // float64
        case 256: itemsize = 1; break;   // int8
        case 512: itemsize = 2; break;   // uint16
        case 768: itemsize = 4; break;   // uint32
        default: return nullptr;
    }
    if ((int64_t)raw.size() < off + n * itemsize) return nullptr;

    float* out = (float*)std::malloc(sizeof(float) * (size_t)n);
    if (!out) return nullptr;
    const uint8_t* src = h + off;
    switch (datatype) {
        case 2: convert_to_f32<uint8_t>(src, out, n, false, slope, inter); break;
        case 4: convert_to_f32<int16_t>(src, out, n, swap, slope, inter); break;
        case 8: convert_to_f32<int32_t>(src, out, n, swap, slope, inter); break;
        case 16: convert_to_f32<float>(src, out, n, swap, slope, inter); break;
        case 64: convert_to_f32<double>(src, out, n, swap, slope, inter); break;
        case 256: convert_to_f32<int8_t>(src, out, n, false, slope, inter); break;
        case 512: convert_to_f32<uint16_t>(src, out, n, swap, slope, inter); break;
        case 768: convert_to_f32<uint32_t>(src, out, n, swap, slope, inter); break;
    }
    // NIfTI is Fortran-ordered (x fastest); interpreting the flat buffer as
    // C-ordered (z, y, x) is exactly the same memory layout — no transpose.
    dims_out[0] = nz;
    dims_out[1] = ny;
    dims_out[2] = nx;
    return out;
}

void nifti_native_free(float* p) { std::free(p); }

// ---------------------------------------------------------------------------
// Trilinear / nearest resize, (z, y, x) C-ordered volumes
// ---------------------------------------------------------------------------

// align_corners=False convention matching micformer_tpu_torch.data.image_utils
// (torch F.interpolate parity): src = (i + 0.5) * in/out - 0.5, clamped.
void resize_trilinear_f32(const float* src, int64_t iz, int64_t iy, int64_t ix,
                          float* dst, int64_t oz, int64_t oy, int64_t ox) {
    auto coord = [](int64_t i, int64_t in, int64_t out) {
        float c = ((float)i + 0.5f) * (float)in / (float)out - 0.5f;
        if (c < 0) c = 0;
        if (c > (float)(in - 1)) c = (float)(in - 1);
        return c;
    };
    std::vector<float> czs(oz), cys(oy), cxs(ox);
    for (int64_t i = 0; i < oz; ++i) czs[i] = coord(i, iz, oz);
    for (int64_t i = 0; i < oy; ++i) cys[i] = coord(i, iy, oy);
    for (int64_t i = 0; i < ox; ++i) cxs[i] = coord(i, ix, ox);

    int nthreads = (int)std::min<int64_t>(std::thread::hardware_concurrency(), 8);
    if (nthreads < 1) nthreads = 1;
    auto work = [&](int64_t z0, int64_t z1) {
        for (int64_t z = z0; z < z1; ++z) {
            float cz = czs[z];
            int64_t zl = (int64_t)cz, zh = std::min(zl + 1, iz - 1);
            float fz = cz - (float)zl;
            for (int64_t y = 0; y < oy; ++y) {
                float cy = cys[y];
                int64_t yl = (int64_t)cy, yh = std::min(yl + 1, iy - 1);
                float fy = cy - (float)yl;
                float* drow = dst + (z * oy + y) * ox;
                for (int64_t x = 0; x < ox; ++x) {
                    float cx = cxs[x];
                    int64_t xl = (int64_t)cx, xh = std::min(xl + 1, ix - 1);
                    float fx = cx - (float)xl;
                    const float* s = src;
                    auto at = [&](int64_t zz, int64_t yy, int64_t xx) {
                        return s[(zz * iy + yy) * ix + xx];
                    };
                    float v000 = at(zl, yl, xl), v001 = at(zl, yl, xh);
                    float v010 = at(zl, yh, xl), v011 = at(zl, yh, xh);
                    float v100 = at(zh, yl, xl), v101 = at(zh, yl, xh);
                    float v110 = at(zh, yh, xl), v111 = at(zh, yh, xh);
                    float v00 = v000 + (v001 - v000) * fx;
                    float v01 = v010 + (v011 - v010) * fx;
                    float v10 = v100 + (v101 - v100) * fx;
                    float v11 = v110 + (v111 - v110) * fx;
                    float v0 = v00 + (v01 - v00) * fy;
                    float v1 = v10 + (v11 - v10) * fy;
                    drow[x] = v0 + (v1 - v0) * fz;
                }
            }
        }
    };
    if (oz < 8 || nthreads == 1) { work(0, oz); return; }
    std::vector<std::thread> ts;
    int64_t step = (oz + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t) {
        int64_t lo = t * step, hi = std::min(oz, lo + step);
        if (lo < hi) ts.emplace_back(work, lo, hi);
    }
    for (auto& t : ts) t.join();
}

void resize_nearest_f32(const float* src, int64_t iz, int64_t iy, int64_t ix,
                        float* dst, int64_t oz, int64_t oy, int64_t ox) {
    // torch F.interpolate(mode='nearest') convention: src = floor(i*in/out)
    auto idx = [](int64_t i, int64_t in, int64_t out) {
        int64_t v = (int64_t)std::floor((double)i * (double)in / (double)out);
        if (v > in - 1) v = in - 1;
        return v;
    };
    for (int64_t z = 0; z < oz; ++z) {
        int64_t zz = idx(z, iz, oz);
        for (int64_t y = 0; y < oy; ++y) {
            int64_t yy = idx(y, iy, oy);
            const float* srow = src + (zz * iy + yy) * ix;
            float* drow = dst + (z * oy + y) * ox;
            for (int64_t x = 0; x < ox; ++x) drow[x] = srow[idx(x, ix, ox)];
        }
    }
}

}  // extern "C"
