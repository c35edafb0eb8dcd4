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

}  // namespace sstt
