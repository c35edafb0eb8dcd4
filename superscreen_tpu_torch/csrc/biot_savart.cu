// Batched inter-film Biot-Savart field:
//   out[b, i] = 1/(4 pi) sum_j a_j (Jx[b, j] dy - Jy[b, j] dx) (dx^2 + dy^2 + dz2)^(-3/2)
// with dx = x_eval_i - x_src_j, dy = y_eval_i - y_src_j.  Like the JAX
// package, there is no r > 0 guard: a coincident pair at dz2 = 0 gives inf.
//
// Replaces the Pallas TPU kernel pallas_biot_savart_batch
// (_bs_T_tile_kernel) of superscreen_tpu/ops/pallas_kernels.py.
//
// Bound: n1 * n2 pairs, each one reciprocal square root plus about
// 6 + 3B arithmetic operations, against O(n1 + n2) bytes of traffic, so
// the arithmetic bounds it.  In float32 the reciprocal square root runs on
// the special-function units at a quarter of the FMA rate; at B = 1 and
// n1 = n2 = 20000 the 4e8 pairs need about 0.1 ms of each on an H100.
// In float64 rsqrt is a software sequence and the kernel is several times
// slower.
//
// Design: each thread owns one evaluation point and keeps the sums of a
// chunk of BC batch columns in registers.  Source tiles of BS_TILE points
// are staged in shared memory with the area folded into the currents
// (a_j Jx, a_j Jy), so the geometry dx, dy, r^-3 of a pair is computed
// once and applied to all BC columns of the chunk; every thread of a block
// reads the same source entry (a broadcast).  A grid of only n2 / 128
// blocks would leave most of the 132 SMs idle at n2 = 20000, so the
// source range is split over gridDim.y: each split writes its partial sums
// to a scratch buffer, and a second kernel adds the splits in a fixed
// order (deterministic, no atomics) and applies the 1 / (4 pi) factor.

#include "common.cuh"

namespace {

constexpr int BS_THREADS = 128;  // evaluation points per block
constexpr int BS_TILE = 128;     // source points per shared-memory tile

template <typename T, int BC>
__global__ void __launch_bounds__(BS_THREADS)
bs_partial_kernel(const sstt::Vec2<T>* __restrict__ src,
                  const T* __restrict__ areas,
                  const sstt::Vec2<T>* __restrict__ J,  // (B, n1)
                  const sstt::Vec2<T>* __restrict__ dst,
                  T dz2, int64_t n1, int64_t n2, int64_t B,
                  int64_t split_len,
                  T* __restrict__ partial) {  // (splits, B, n2)
    __shared__ sstt::Vec2<T> s_pos[BS_TILE];
    __shared__ sstt::Vec2<T> s_cur[BS_TILE][BC];

    const int64_t i = static_cast<int64_t>(blockIdx.x) * BS_THREADS + threadIdx.x;
    const bool valid = i < n2;
    sstt::Vec2<T> pe;
    pe.x = T(0);
    pe.y = T(0);
    if (valid) {
        pe = dst[i];
    }
    const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * split_len;
    const int64_t j_end = j_begin + split_len < n1 ? j_begin + split_len : n1;

    for (int64_t b0 = 0; b0 < B; b0 += BC) {
        T acc[BC];
#pragma unroll
        for (int c = 0; c < BC; ++c) {
            acc[c] = T(0);
        }
        for (int64_t j0 = j_begin; j0 < j_end; j0 += BS_TILE) {
            const int count = j_end - j0 < BS_TILE ? static_cast<int>(j_end - j0) : BS_TILE;
            __syncthreads();  // the previous tile is no longer read
            for (int t = threadIdx.x; t < count; t += BS_THREADS) {
                const int64_t j = j0 + t;
                s_pos[t] = src[j];
                const T a = areas[j];
#pragma unroll
                for (int c = 0; c < BC; ++c) {
                    sstt::Vec2<T> aj;
                    aj.x = T(0);
                    aj.y = T(0);
                    if (b0 + c < B) {
                        const sstt::Vec2<T> cur = J[(b0 + c) * n1 + j];
                        aj.x = a * cur.x;
                        aj.y = a * cur.y;
                    }
                    s_cur[t][c] = aj;
                }
            }
            __syncthreads();
            for (int t = 0; t < count; ++t) {
                const sstt::Vec2<T> ps = s_pos[t];
                const T dx = pe.x - ps.x;
                const T dy = pe.y - ps.y;
                const T inv = sstt::rsqrt_t(dx * dx + dy * dy + dz2);
                const T r3 = inv * inv * inv;
#pragma unroll
                for (int c = 0; c < BC; ++c) {
                    const sstt::Vec2<T> aj = s_cur[t][c];
                    acc[c] += (aj.x * dy - aj.y * dx) * r3;
                }
            }
        }
        if (valid) {
#pragma unroll
            for (int c = 0; c < BC; ++c) {
                if (b0 + c < B) {
                    partial[(static_cast<int64_t>(blockIdx.y) * B + b0 + c) * n2 + i] = acc[c];
                }
            }
        }
    }
}

template <typename T, int BC>
void launch_partial(const T* src, const T* areas, const T* J, const T* dst, T dz2,
                    int64_t n1, int64_t n2, int64_t B, int64_t splits,
                    int64_t split_len, T* partial, cudaStream_t stream) {
    const dim3 grid(sstt::ceil_div(n2, BS_THREADS), static_cast<unsigned int>(splits));
    bs_partial_kernel<T, BC><<<grid, BS_THREADS, 0, stream>>>(
        reinterpret_cast<const sstt::Vec2<T>*>(src), areas,
        reinterpret_cast<const sstt::Vec2<T>*>(J),
        reinterpret_cast<const sstt::Vec2<T>*>(dst), dz2, n1, n2, B, split_len,
        partial);
}

template <typename T>
int launch_biot_savart(const T* src, const T* areas, const T* J, const T* dst, T dz2,
                       int64_t n1, int64_t n2, int64_t B, int64_t splits,
                       T* partial, T* out, void* stream_ptr) {
    if (n1 <= 0 || n2 <= 0 || B <= 0 || splits <= 0 || splits > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    // Whole source tiles per split, so only the last split is ragged.
    const int64_t tiles = (n1 + BS_TILE - 1) / BS_TILE;
    const int64_t split_len = ((tiles + splits - 1) / splits) * BS_TILE;
    if (B == 1) {
        launch_partial<T, 1>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream);
    } else if (B == 2) {
        launch_partial<T, 2>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream);
    } else if (B <= 4) {
        launch_partial<T, 4>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream);
    } else {
        launch_partial<T, 8>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(sstt::reduce_partials<T>(partial, splits, B * n2, out, stream));
}

}  // namespace

extern "C" int sstt_biot_savart_f32(const float* src, const float* areas, const float* J,
                                    const float* dst, float dz2, int64_t n1, int64_t n2,
                                    int64_t B, int64_t splits, float* partial, float* out,
                                    void* stream) {
    return launch_biot_savart<float>(src, areas, J, dst, dz2, n1, n2, B, splits, partial,
                                     out, stream);
}

extern "C" int sstt_biot_savart_f64(const double* src, const double* areas, const double* J,
                                    const double* dst, double dz2, int64_t n1, int64_t n2,
                                    int64_t B, int64_t splits, double* partial, double* out,
                                    void* stream) {
    return launch_biot_savart<double>(src, areas, J, dst, dz2, n1, n2, B, splits, partial,
                                      out, stream);
}
