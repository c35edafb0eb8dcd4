// Matrix-free application of the Brandt kernel between two point sets:
//   out[i, c] = 1/(4 pi) sum_j q(eval_i, src_j) V[j, c],
//   q = |eval_i - src_j|^-3, and q = 0 where the two points coincide
// (the zero diagonal of the square kernel).  q is never stored.
//
// Replaces the Pallas TPU kernel pallas_q_apply_rect
// (_q_apply_tile_kernel) of superscreen_tpu/ops/pallas_kernels.py.
//
// Bound: m * n pairs, each one reciprocal square root and 7 + 2k
// floating-point operations, against O((m + n) k) bytes, so the arithmetic
// bounds it.  An H100 SXM (132 SMs at 1.98 GHz) computes 4.18e12
// reciprocal square roots per second on its special-function units and
// 66.9e12 FP32 operations on its lanes: float32 is bound by the rsqrt for
// k <= 3 (0.178 ms at 27,298 x 27,298, k = 1) and by the column sums above
// (0.234 ms at k = 7).  A pair also costs about ten issued instructions
// (two differences, the squared distance, the rsqrt, the cube, the d^2 > 0
// select, one FMA per column), and each of the SM's four schedulers issues
// one warp instruction per clock, so at k = 1 issue caps the kernel near
// 80 % of the rsqrt bound.  In float64 rsqrt is a software sequence on the
// FP64 units and the kernel is several times slower.
//
// Design: each thread owns P evaluation points (4 in float32, 2 in
// float64) and keeps the sums of a chunk of KC in {1, 2, 4, 8} columns of
// each in registers; k is processed in chunks, so any k runs with a fixed
// register budget (the self-field passes (iterations + 1) B + 1 columns).
// Source tiles of QA_TILE points and their KC-wide rows of V are staged in
// shared memory, each thread loading its source of the next tile from
// global memory before it works through the current one, so the loads
// overlap the arithmetic.  The inner loop takes U sources per step (4 in
// float32, 2 in float64), reads their positions and values as 16-byte
// broadcasts, and applies each source to the thread's P points, so one
// shared-memory load and one pass of loop control serve many pairs; the
// reciprocal square root runs without the subnormal fix-up (common.cuh).
// The ragged rest of the last tile is taken one source at a time, bounded
// by its count: nothing is padded.  The source range is split over
// gridDim.y, whole tiles per split (ops/cuda_kernels.py picks the number of
// splits so that the grid fills the card in near-whole waves); each split
// writes partial sums, and a second kernel adds the splits in a fixed order
// (deterministic, no atomics) and applies 1 / (4 pi).  d^2 > 0 is tested
// exactly as the TPU kernel tests it.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (float32,
// chip_smoke.py): 0.118 ms at the CG matvec's 16,768 x 16,768, k = 1 (57 %
// of its 0.067 ms rsqrt bound), 0.291 ms at 27,298 x 27,298, k = 1 (61 %
// of 0.178 ms), 0.508 ms at k = 7 (46 % of 0.234 ms); the previous design
// (one point per thread), timed in turns with it on the same card, took
// 0.198, 0.507 and 0.765 ms.
// The SASS issues 9.75 instructions per pair at k = 1.

#include "common.cuh"

namespace {

constexpr int QA_THREADS = 128;  // threads per block
constexpr int QA_TILE = 128;     // source points per shared-memory tile: one per thread
static_assert(QA_TILE == QA_THREADS, "each thread stages one source per tile");

// Evaluation points per thread (P) and sources per unrolled step (U):
// P = 4 and U = 4 in float32, the fastest of P = 1, 2, 4, 8 and U = 2, 4, 8
// on the H100 (P = 8 needs 148 registers at KC = 8 and ran 13 % slower);
// P = 2 and U = 2 in float64.
template <typename T> struct QaBlocking {
    static constexpr int P = sizeof(T) == 4 ? 4 : 2;
    static constexpr int U = sizeof(T) == 4 ? 4 : 2;
};

template <typename T>
__host__ __device__ constexpr int qa_points_per_block() {
    return QA_THREADS * QaBlocking<T>::P;
}

// acc[e][c] += q(eval_e, src) v[c] for the P points of a thread; a
// coincident pair (d^2 = 0, where q = inf) adds nothing.  With one column
// the d^2 > 0 test predicates the FMA (one instruction fewer per pair than
// a select); with more, the compiler would branch around the FMAs, so q is
// selected once instead.
template <typename T, int P, int KC>
__device__ __forceinline__ void qa_source(T sx, T sy, const T* v, const T (&px)[P],
                                          const T (&py)[P], T (&acc)[P][KC]) {
#pragma unroll
    for (int e = 0; e < P; ++e) {
        const T dx = px[e] - sx;
        const T dy = py[e] - sy;
        const T d2 = dx * dx + dy * dy;
        const T inv = sstt::rsqrt_ftz(d2);
        if constexpr (KC == 1) {
            if (d2 > T(0)) {
                acc[e][0] += inv * inv * inv * v[0];
            }
        } else {
            const T q = d2 > T(0) ? inv * inv * inv : T(0);
#pragma unroll
            for (int c = 0; c < KC; ++c) {
                acc[e][c] += q * v[c];  // one FMA
            }
        }
    }
}

template <typename T, int KC>
__global__ void __launch_bounds__(QA_THREADS)
qa_partial_kernel(const sstt::Vec2<T>* __restrict__ eval,
                  const sstt::Vec2<T>* __restrict__ src,
                  const T* __restrict__ V,  // (n, k)
                  int64_t m, int64_t n, int64_t k, int64_t split_len,
                  T* __restrict__ partial) {  // (splits, m, k)
    constexpr int P = QaBlocking<T>::P;
    constexpr int U = QaBlocking<T>::U;
    __shared__ __align__(16) T s_pos[2 * QA_TILE];  // (x, y) of each source
    __shared__ __align__(16) T s_v[QA_TILE * KC];   // its KC values of V

    // Point e of a thread is eval[base + e * QA_THREADS], so the loads and
    // stores of each e are coalesced.  Points past m compute on (0, 0) and
    // are never written.
    const int64_t base =
        static_cast<int64_t>(blockIdx.x) * qa_points_per_block<T>() + threadIdx.x;
    T px[P], py[P];
#pragma unroll
    for (int e = 0; e < P; ++e) {
        const int64_t i = base + e * QA_THREADS;
        px[e] = T(0);
        py[e] = T(0);
        if (i < m) {
            const sstt::Vec2<T> pe = eval[i];
            px[e] = pe.x;
            py[e] = pe.y;
        }
    }
    const int64_t j_begin = static_cast<int64_t>(blockIdx.y) * split_len;
    const int64_t j_end = j_begin + split_len < n ? j_begin + split_len : n;

    for (int64_t c0 = 0; c0 < k; c0 += KC) {
        T acc[P][KC];
#pragma unroll
        for (int e = 0; e < P; ++e) {
#pragma unroll
            for (int c = 0; c < KC; ++c) {
                acc[e][c] = T(0);
            }
        }
        // The source this thread stages, loaded from global memory one tile
        // ahead so that the loads overlap the previous tile's arithmetic.
        sstt::Vec2<T> next_pos{T(0), T(0)};
        T next_v[KC] = {};
        auto fetch = [&](int64_t j) {
            if (j < j_end) {
                next_pos = src[j];
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    next_v[c] = c0 + c < k ? V[j * k + c0 + c] : T(0);
                }
            }
        };
        fetch(j_begin + threadIdx.x);
        for (int64_t j0 = j_begin; j0 < j_end; j0 += QA_TILE) {
            const int count = j_end - j0 < QA_TILE ? static_cast<int>(j_end - j0) : QA_TILE;
            __syncthreads();  // the previous tile is no longer read
            if (threadIdx.x < count) {
                reinterpret_cast<sstt::Vec2<T>*>(s_pos)[threadIdx.x] = next_pos;
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    s_v[threadIdx.x * KC + c] = next_v[c];
                }
            }
            __syncthreads();
            fetch(j0 + QA_TILE + threadIdx.x);
            int t = 0;
            for (; t + U <= count; t += U) {
                T sp[2 * U];
                T sv[U * KC];
                sstt::load_shared(s_pos + 2 * t, sp);
                sstt::load_shared(s_v + t * KC, sv);
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    qa_source<T, P, KC>(sp[2 * u], sp[2 * u + 1], sv + u * KC, px, py, acc);
                }
            }
            for (; t < count; ++t) {  // the ragged rest of the last tile
                T sv[KC];
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    sv[c] = s_v[t * KC + c];
                }
                qa_source<T, P, KC>(s_pos[2 * t], s_pos[2 * t + 1], sv, px, py, acc);
            }
        }
#pragma unroll
        for (int e = 0; e < P; ++e) {
            const int64_t i = base + e * QA_THREADS;
            if (i < m) {
                T* row = partial + (static_cast<int64_t>(blockIdx.y) * m + i) * k + c0;
#pragma unroll
                for (int c = 0; c < KC; ++c) {
                    if (c0 + c < k) {
                        row[c] = acc[e][c];
                    }
                }
            }
        }
    }
}

template <typename T, int KC>
void launch_partial(const T* eval, const T* src, const T* V, int64_t m, int64_t n,
                    int64_t k, int64_t splits, int64_t split_len, T* partial,
                    cudaStream_t stream) {
    const dim3 grid(sstt::ceil_div(m, qa_points_per_block<T>()),
                    static_cast<unsigned int>(splits));
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
    const int64_t split_len = sstt::split_length(n, splits, QA_TILE);
    switch (sstt::chunk_width(k)) {
        case 1: launch_partial<T, 1>(eval, src, V, m, n, k, splits, split_len, partial, stream); break;
        case 2: launch_partial<T, 2>(eval, src, V, m, n, k, splits, split_len, partial, stream); break;
        case 4: launch_partial<T, 4>(eval, src, V, m, n, k, splits, split_len, partial, stream); break;
        default: launch_partial<T, 8>(eval, src, V, m, n, k, splits, split_len, partial, stream);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
        return static_cast<int>(err);
    }
    return static_cast<int>(sstt::reduce_partials<T>(partial, splits, m * k, out, stream));
}

}  // namespace

// Launch geometry for the wrapper's grid arithmetic: evaluation points per
// block (the same for any number of columns) and source points per tile.
extern "C" void sstt_q_apply_geometry(int is_f64, int64_t /*k*/, int64_t* points_per_block,
                                      int64_t* source_tile) {
    *points_per_block = is_f64 ? qa_points_per_block<double>() : qa_points_per_block<float>();
    *source_tile = QA_TILE;
}

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
