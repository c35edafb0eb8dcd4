// Matrix-free application of the Brandt kernel between two point sets:
//   out[i, c] = 1/(4 pi) sum_j q(eval_i, src_j) V[j, c],
//   q = |eval_i - src_j|^-3, and q = 0 where the two points coincide
// (the zero diagonal of the square kernel).  q is never stored.
//
// Replaces the Pallas TPU kernel pallas_q_apply_rect
// (_q_apply_tile_kernel) of superscreen_tpu/ops/pallas_kernels.py.
//
// Bound: m * n pairs, each one reciprocal square root and about 5 + 2k
// arithmetic operations, against O((m + n) k) bytes of traffic: there is
// no (m, n) traffic, so the arithmetic bounds it.  In float32 the
// reciprocal square root runs on the special-function units at a fraction
// of the FMA rate and bounds small k; the k column sums bound larger k.
// In float64 rsqrt is a software sequence and the kernel is several times
// slower.
//
// Design (as biot_savart.cu): each thread owns one evaluation point and
// keeps the sums of a chunk of KC columns in registers; k is processed in
// chunks of KC, so any number of columns runs with a fixed register
// budget (the self-field passes (iterations + 1) * B + 1 columns).  Source
// tiles of QA_TILE points and their KC-wide rows of V are staged in shared
// memory and read as broadcasts, so the geometry of a pair is computed once
// per chunk.  The source range is split over gridDim.y so that a few
// hundred evaluation blocks still fill the card; each split writes partial
// sums, and a second kernel adds the splits in a fixed order
// (deterministic, no atomics) and applies 1 / (4 pi).  d^2 > 0 is tested
// exactly as the TPU kernel tests it; the ragged last tile is bounded by
// its count, not padded with far-away points.

#include "common.cuh"

namespace {

constexpr int QA_THREADS = 128;  // evaluation points per block
constexpr int QA_TILE = 128;     // source points per shared-memory tile

template <typename T, int KC>
__global__ void __launch_bounds__(QA_THREADS)
qa_partial_kernel(const sstt::Vec2<T>* __restrict__ eval,
                  const sstt::Vec2<T>* __restrict__ src,
                  const T* __restrict__ V,  // (n, k)
                  int64_t m, int64_t n, int64_t k, int64_t split_len,
                  T* __restrict__ partial) {  // (splits, m, k)
    __shared__ sstt::Vec2<T> s_pos[QA_TILE];
    __shared__ T s_v[QA_TILE][KC];

    const int64_t i = static_cast<int64_t>(blockIdx.x) * QA_THREADS + threadIdx.x;
    const bool valid = i < m;
    sstt::Vec2<T> pe;
    pe.x = T(0);
    pe.y = T(0);
    if (valid) {
        pe = eval[i];
    }
    const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * split_len;
    const int64_t j_end = j_begin + split_len < n ? j_begin + split_len : n;

    for (int64_t c0 = 0; c0 < k; c0 += KC) {
        T acc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) {
            acc[c] = T(0);
        }
        for (int64_t j0 = j_begin; j0 < j_end; j0 += QA_TILE) {
            const int count = j_end - j0 < QA_TILE ? static_cast<int>(j_end - j0) : QA_TILE;
            __syncthreads();  // the previous tile is no longer read
            for (int t = threadIdx.x; t < count; t += QA_THREADS) {
                const int64_t j = j0 + t;
                s_pos[t] = src[j];
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    s_v[t][c] = c0 + c < k ? V[j * k + c0 + c] : T(0);
                }
            }
            __syncthreads();
            for (int t = 0; t < count; ++t) {
                const sstt::Vec2<T> ps = s_pos[t];
                const T dx = pe.x - ps.x;
                const T dy = pe.y - ps.y;
                const T d2 = dx * dx + dy * dy;
                const bool positive = d2 > T(0);
                const T inv = sstt::rsqrt_t(positive ? d2 : T(1));
                const T q = positive ? inv * inv * inv : T(0);
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    acc[c] += q * s_v[t][c];
                }
            }
        }
        if (valid) {
            T* row = partial + (static_cast<int64_t>(blockIdx.y) * m + i) * k + c0;
#pragma unroll
            for (int c = 0; c < KC; ++c) {
                if (c0 + c < k) {
                    row[c] = acc[c];
                }
            }
        }
    }
}

template <typename T, int KC>
void launch_partial(const T* eval, const T* src, const T* V, int64_t m, int64_t n,
                    int64_t k, int64_t splits, int64_t split_len, T* partial,
                    cudaStream_t stream) {
    const dim3 grid(sstt::ceil_div(m, QA_THREADS), static_cast<unsigned int>(splits));
    qa_partial_kernel<T, KC><<<grid, QA_THREADS, 0, stream>>>(
        reinterpret_cast<const sstt::Vec2<T>*>(eval),
        reinterpret_cast<const sstt::Vec2<T>*>(src), V, m, n, k, split_len, partial);
}

template <typename T>
int launch_q_apply(const T* eval, const T* src, const T* V, int64_t m, int64_t n,
                   int64_t k, int64_t splits, T* partial, T* out, void* stream_ptr) {
    if (m <= 0 || n <= 0 || k <= 0 || splits <= 0 || splits > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
    // Whole source tiles per split, so only the last split is ragged.
    const int64_t tiles = (n + QA_TILE - 1) / QA_TILE;
    const int64_t split_len = ((tiles + splits - 1) / splits) * QA_TILE;
    if (k == 1) {
        launch_partial<T, 1>(eval, src, V, m, n, k, splits, split_len, partial, stream);
    } else if (k == 2) {
        launch_partial<T, 2>(eval, src, V, m, n, k, splits, split_len, partial, stream);
    } else if (k <= 4) {
        launch_partial<T, 4>(eval, src, V, m, n, k, splits, split_len, partial, stream);
    } else {
        launch_partial<T, 8>(eval, src, V, m, n, k, splits, split_len, partial, stream);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(sstt::reduce_partials<T>(partial, splits, m * k, out, stream));
}

}  // namespace

extern "C" int sstt_q_apply_f32(const float* eval, const float* src, const float* V,
                                int64_t m, int64_t n, int64_t k, int64_t splits,
                                float* partial, float* out, void* stream) {
    return launch_q_apply<float>(eval, src, V, m, n, k, splits, partial, out, stream);
}

extern "C" int sstt_q_apply_f64(const double* eval, const double* src, const double* V,
                                int64_t m, int64_t n, int64_t k, int64_t splits,
                                double* partial, double* out, void* stream) {
    return launch_q_apply<double>(eval, src, V, m, n, k, splits, partial, out, stream);
}
