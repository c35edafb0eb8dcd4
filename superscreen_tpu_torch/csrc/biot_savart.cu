// Batched inter-film Biot-Savart field:
//   out[b, i] = 1/(4 pi) sum_j a_j (Jx[b, j] dy - Jy[b, j] dx) (dx^2 + dy^2 + dz2)^(-3/2)
// with dx = x_eval_i - x_src_j, dy = y_eval_i - y_src_j.  Like the JAX
// package, there is no r > 0 guard: a coincident pair at dz2 = 0 gives inf.
//
// Replaces the Pallas TPU kernel pallas_biot_savart_batch
// (_bs_T_tile_kernel) of superscreen_tpu/ops/pallas_kernels.py.
//
// Bound: n1 * n2 pairs, each one reciprocal square root and 10 + 4B
// floating-point operations (the geometry K = (dx, dy) r^-3 once, then two
// FMAs per batch column), against O((n1 + n2) B) bytes, so the arithmetic
// bounds it.  An H100 SXM (132 SMs at 1.98 GHz) computes 4.18e12
// reciprocal square roots per second and 66.9e12 FP32 operations: float32
// is bound by the rsqrt at B = 1 (0.178 ms at 27,298 x 27,298) and by the
// FP32 lanes from B = 2 (0.468 ms at B = 8).  In float64 rsqrt is a
// software sequence on the FP64 units and the kernel is several times
// slower.
//
// Design: each thread owns P evaluation points (4 in float32, 8 for a
// chunk of 8 batch columns; 2 in float64) and keeps the sums of a chunk of
// BC in {1, 2, 4, 8} batch columns of each in registers.  Source tiles of
// BS_TILE points are staged in shared memory with the area folded into the
// currents (a_j Jx, a_j Jy).  The inner loop takes U sources per step (4 in
// float32, 2 in float64), reads their positions and currents as 16-byte
// broadcasts, and applies each source to the thread's P points, so one
// shared-memory load and one pass of loop control serve many pairs; the
// reciprocal square root runs without the subnormal fix-up (common.cuh;
// between films d^2 >= dz2 > 0).  From BC = 2 each pair forms
// Kx = dx r^-3 and Ky = dy r^-3 once and each column costs two FMAs; at
// BC = 1, (a Jx dy - a Jy dx) r^-3 takes one instruction fewer (forming K
// there measured 8 % slower).  Loading the next tile ahead, as q_apply.cu
// does, measured 9 % slower here at B = 1 and is not done.  The ragged rest
// of the last tile is taken one source at a time, bounded by its count:
// nothing is padded.  The source range is split over gridDim.y, whole tiles
// per split (ops/cuda_kernels.py picks the number of splits so that the
// grid fills the card in near-whole waves); each split writes its partial
// sums, and a second kernel adds the splits in a fixed order
// (deterministic, no atomics) and applies the 1 / (4 pi) factor.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (float32,
// chip_smoke.py): 0.176 ms at 20,274 x 20,274, B = 1 (56 % of its 0.098 ms
// rsqrt bound), 0.319 ms at 27,298 x 27,298, B = 1 (56 % of 0.178 ms),
// 0.796 ms at B = 8 (59 % of its 0.468 ms FP32 bound); the previous design
// (one point per thread), timed in turns with it on the same card, took
// 0.287, 0.510 and 1.271 ms.

#include "common.cuh"

namespace {

constexpr int BS_THREADS = 128;  // threads per block
constexpr int BS_TILE = 128;     // source points per shared-memory tile

// Evaluation points per thread (P) and sources per unrolled step (U) for a
// chunk of BC batch columns: P = 4 and U = 4 in float32 (the fastest of
// P = 1, 2, 4, 8 and U = 2, 4, 8 on the H100 for BC = 1) except for the
// 8-column chunk, where 8 points halve the shared-memory loads per pair
// (9 % faster at B = 8, 167 registers, no spills); P = 2 and U = 2 in
// float64.
template <typename T, int BC> struct BsBlocking {
    static constexpr int P = sizeof(T) == 4 ? (BC == 8 ? 8 : 4) : 2;
    static constexpr int U = sizeof(T) == 4 ? 4 : 2;
};

template <typename T, int BC>
__host__ __device__ constexpr int bs_points_per_block() {
    return BS_THREADS * BsBlocking<T, BC>::P;
}

template <typename T>
int64_t bs_points_per_block(int64_t B) {
    switch (sstt::chunk_width(B)) {
        case 1: return bs_points_per_block<T, 1>();
        case 2: return bs_points_per_block<T, 2>();
        case 4: return bs_points_per_block<T, 4>();
        default: return bs_points_per_block<T, 8>();
    }
}

// acc[e][c] += (aJx_c dy - aJy_c dx) r^-3 for the P points of a thread;
// cur holds the BC pairs (a Jx, a Jy) of the source.
template <typename T, int P, int BC>
__device__ __forceinline__ void bs_source(T sx, T sy, const T* cur, T dz2, const T (&px)[P],
                                          const T (&py)[P], T (&acc)[P][BC]) {
#pragma unroll
    for (int e = 0; e < P; ++e) {
        const T dx = px[e] - sx;
        const T dy = py[e] - sy;
        const T inv = sstt::rsqrt_ftz(dx * dx + (dy * dy + dz2));  // two FMAs
        const T r3 = inv * inv * inv;
        if constexpr (BC == 1) {
            acc[e][0] += (cur[0] * dy - cur[1] * dx) * r3;
        } else {
            const T kx = dx * r3;
            const T ky = dy * r3;
#pragma unroll
            for (int c = 0; c < BC; ++c) {
                acc[e][c] += cur[2 * c] * ky;
                acc[e][c] -= cur[2 * c + 1] * kx;
            }
        }
    }
}

template <typename T, int BC>
__global__ void __launch_bounds__(BS_THREADS)
bs_partial_kernel(const sstt::Vec2<T>* __restrict__ src,
                  const T* __restrict__ areas,
                  const sstt::Vec2<T>* __restrict__ J,  // (B, n1)
                  const sstt::Vec2<T>* __restrict__ dst,
                  T dz2, int64_t n1, int64_t n2, int64_t B,
                  int64_t split_len,
                  T* __restrict__ partial) {  // (splits, B, n2)
    constexpr int P = BsBlocking<T, BC>::P;
    constexpr int U = BsBlocking<T, BC>::U;
    __shared__ __align__(16) T s_pos[2 * BS_TILE];       // (x, y) of each source
    __shared__ __align__(16) T s_cur[2 * BS_TILE * BC];  // its BC (a Jx, a Jy)

    // Point e of a thread is dst[base + e * BS_THREADS], so the loads and
    // stores of each e are coalesced.  Points past n2 compute on (0, 0) and
    // are never written.
    const int64_t base =
        static_cast<int64_t>(blockIdx.x) * bs_points_per_block<T, BC>() + threadIdx.x;
    T px[P], py[P];
#pragma unroll
    for (int e = 0; e < P; ++e) {
        const int64_t i = base + e * BS_THREADS;
        px[e] = T(0);
        py[e] = T(0);
        if (i < n2) {
            const sstt::Vec2<T> pe = dst[i];
            px[e] = pe.x;
            py[e] = pe.y;
        }
    }
    const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * split_len;
    const int64_t j_end = j_begin + split_len < n1 ? j_begin + split_len : n1;

    for (int64_t b0 = 0; b0 < B; b0 += BC) {
        T acc[P][BC];
#pragma unroll
        for (int e = 0; e < P; ++e) {
#pragma unroll
            for (int c = 0; c < BC; ++c) {
                acc[e][c] = T(0);
            }
        }
        for (int64_t j0 = j_begin; j0 < j_end; j0 += BS_TILE) {
            const int count = j_end - j0 < BS_TILE ? static_cast<int>(j_end - j0) : BS_TILE;
            __syncthreads();  // the previous tile is no longer read
            for (int t = threadIdx.x; t < count; t += BS_THREADS) {
                const int64_t j = j0 + t;
                reinterpret_cast<sstt::Vec2<T>*>(s_pos)[t] = src[j];
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
                    reinterpret_cast<sstt::Vec2<T>*>(s_cur)[t * BC + c] = aj;
                }
            }
            __syncthreads();
            int t = 0;
            for (; t + U <= count; t += U) {
                T sp[2 * U];
                T sc[2 * BC * U];
                sstt::load_shared(s_pos + 2 * t, sp);
                sstt::load_shared(s_cur + 2 * BC * t, sc);
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    bs_source<T, P, BC>(sp[2 * u], sp[2 * u + 1], sc + 2 * BC * u, dz2, px, py,
                                        acc);
                }
            }
            for (; t < count; ++t) {  // the ragged rest of the last tile
                T sc[2 * BC];
#pragma unroll
                for (int c = 0; c < 2 * BC; ++c) {
                    sc[c] = s_cur[2 * BC * t + c];
                }
                bs_source<T, P, BC>(s_pos[2 * t], s_pos[2 * t + 1], sc, dz2, px, py, acc);
            }
        }
#pragma unroll
        for (int e = 0; e < P; ++e) {
            const int64_t i = base + e * BS_THREADS;
            if (i < n2) {
#pragma unroll
                for (int c = 0; c < BC; ++c) {
                    if (b0 + c < B) {
                        partial[(static_cast<int64_t>(blockIdx.y) * B + b0 + c) * n2 + i] =
                            acc[e][c];
                    }
                }
            }
        }
    }
}

template <typename T, int BC>
void launch_partial(const T* src, const T* areas, const T* J, const T* dst, T dz2,
                    int64_t n1, int64_t n2, int64_t B, int64_t splits,
                    int64_t split_len, T* partial, cudaStream_t stream) {
    const dim3 grid(sstt::ceil_div(n2, bs_points_per_block<T, BC>()),
                    static_cast<unsigned int>(splits));
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
    const int64_t split_len = sstt::split_length(n1, splits, BS_TILE);
    switch (sstt::chunk_width(B)) {
        case 1: launch_partial<T, 1>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream); break;
        case 2: launch_partial<T, 2>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream); break;
        case 4: launch_partial<T, 4>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream); break;
        default: launch_partial<T, 8>(src, areas, J, dst, dz2, n1, n2, B, splits, split_len, partial, stream);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(sstt::reduce_partials<T>(partial, splits, B * n2, out, stream));
}

}  // namespace

// Launch geometry for the wrapper's grid arithmetic: evaluation points per
// block for B batch columns, and source points per tile.
extern "C" void sstt_biot_savart_geometry(int is_f64, int64_t B, int64_t* points_per_block,
                                          int64_t* source_tile) {
    *points_per_block = is_f64 ? bs_points_per_block<double>(B) : bs_points_per_block<float>(B);
    *source_tile = BS_TILE;
}

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
