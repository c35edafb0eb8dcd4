// Shared device helpers for the superscreen_tpu_torch kernels.
#pragma once

#include <cstdint>
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

// An (x, y) pair stored so that one vector load fetches both values.
template <typename T>
struct alignas(2 * sizeof(T)) Vec2 {
    T x;
    T y;
};

inline unsigned int ceil_div(int64_t a, int64_t b) {
    return static_cast<unsigned int>((a + b - 1) / b);
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
