// Shared device helpers for the superscreen_tpu_torch kernels.
#pragma once

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace sstt {

// 1 / (4 pi), the prefactor of every pairwise kernel in this package.
template <typename T>
__device__ __forceinline__ T one_over_4pi() {
    return T(0.079577471545947667884441881686257181);
}

// Reciprocal square root at the working precision: rsqrtf (at most 2 ulp
// off) in float32, rsqrt (at most 1 ulp off) in float64.
__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

// The same without rsqrtf's subnormal fix-up, for the pairwise kernels
// whose issue rate bounds them.  float32: the special-function unit's
// rsqrt.approx.ftz.f32 (at most 2 ulp off), one instruction; rsqrtf wraps
// it in a test and two scaling multiplies for subnormal inputs.  Flushing
// cannot change a result of those kernels: an input below 2^-126 has a
// reciprocal square root above 2^63, whose cube (each uses r^-3) overflows
// float32 to inf with or without the flush, and every other input is
// normal.  float64: rsqrt.  (q_matrix.cu, bound by its stores, keeps
// rsqrt_t: with this one it ran 4 % slower on the H100.)
__device__ __forceinline__ float rsqrt_ftz(float x) {
    float r;
    asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
    return r;
}
__device__ __forceinline__ double rsqrt_ftz(double x) { return rsqrt(x); }

// An (x, y) pair stored so that one vector load fetches both values.
template <typename T>
struct alignas(2 * sizeof(T)) Vec2 {
    T x;
    T y;
};

// Copies N consecutive values of shared memory into registers with 16-byte
// vector loads; p must be 16-byte aligned.  Every thread of a warp reads
// the same address, so each load is one broadcast.
template <int N, typename T>
__device__ __forceinline__ void load_shared(const T* p, T (&r)[N]) {
    static_assert(N * sizeof(T) % 16 == 0, "whole 16-byte vectors");
#pragma unroll
    for (int i = 0; i < static_cast<int>(N * sizeof(T) / 16); ++i) {
        const float4 v = reinterpret_cast<const float4*>(p)[i];
        memcpy(&r[i * 16 / sizeof(T)], &v, 16);
    }
}

// Columns a pairwise kernel keeps in registers per pass for `cols`
// columns in all: 1, 2, 4 or 8 (a ragged last chunk is zero-padded).
inline int chunk_width(int64_t cols) {
    return cols == 1 ? 1 : cols == 2 ? 2 : cols <= 4 ? 4 : 8;
}

inline unsigned int ceil_div(int64_t a, int64_t b) {
    return static_cast<unsigned int>((a + b - 1) / b);
}

// Source points per split of a source range of n points cut into
// `splits` splits of whole tiles, so that only the last split is ragged.
// ops/cuda_kernels.py chooses `splits` with the same arithmetic.
inline int64_t split_length(int64_t n, int64_t splits, int64_t tile) {
    const int64_t tiles = (n + tile - 1) / tile;
    return ((tiles + splits - 1) / splits) * tile;
}

// Internal linkage: each source file gets its own copy of the kernel, so
// the separately compiled objects of the library never share a kernel
// symbol.
namespace {

// out[k] = 1/(4 pi) * sum_s partial[s * count + k], the splits added in a
// fixed order (deterministic, no atomics).  The second pass of every
// kernel that splits its reduction range over blocks.
template <typename T>
__global__ void reduce_partials_kernel(const T* __restrict__ partial, int64_t splits,
                                       int64_t count, T* __restrict__ out) {
    const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (k >= count) {
        return;
    }
    T sum = T(0);
    for (int64_t s = 0; s < splits; ++s) {
        sum += partial[s * count + k];
    }
    out[k] = one_over_4pi<T>() * sum;
}

template <typename T>
cudaError_t reduce_partials(const T* partial, int64_t splits, int64_t count, T* out,
                            cudaStream_t stream) {
    reduce_partials_kernel<T><<<ceil_div(count, 256), 256, 0, stream>>>(partial, splits,
                                                                        count, out);
    return cudaGetLastError();
}

}  // namespace

}  // namespace sstt
