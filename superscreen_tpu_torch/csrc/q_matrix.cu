// Dense Brandt kernel q_ij = 1 / (4 pi |r_i - r_j|^3), zero where r_i = r_j.
//
// Replaces the Pallas TPU kernel pallas_q_matrix (_q_tile_kernel) of
// superscreen_tpu/ops/pallas_kernels.py.
//
// Two entry points share the kernel: the square matrix q(points, points),
// and a rectangular block q(eval, src) of m evaluation rows against n
// sources, with m n values in rows of n.  A row block of the square matrix
// (eval = points + r0) is the block a model slot of a row-sharded system
// assembles; its diagonal, at column r0 + i of row i, is zero like the
// square matrix's, and the caller sets it.
//
// Bound: the kernel reads 2n coordinates and writes n^2 values, with about
// ten arithmetic operations per value, so the writes bound it: 4 n^2 bytes
// in float32 (1.6 GB at n = 20000), 0.49 ms at 3.35 TB/s.
//
// Design: a block computes a tile of QM_ROWS rows by QM_COLS columns into
// shared memory, one column per thread (its coordinate in registers, the
// tile's row coordinates staged in shared memory and read as broadcasts).
// It then stores each tile row with 16-byte vector stores.  A row starts
// at offset i * n, which is 16-byte aligned only when n is a multiple of 4
// (float32) or 2 (float64), and storing a warp's 128 bytes across cache-line
// boundaries measured ~1.8x slower; so each tile row is stored as a scalar
// head up to the first aligned address, aligned vectors, and a scalar
// tail.  The ragged edges of the matrix are masked, and offsets are 64-bit
// (n^2 overflows int32 from n = 46341).

#include "common.cuh"

namespace {

constexpr int QM_COLS = 256;  // columns per tile, one per thread
constexpr int QM_ROWS = 16;   // rows per tile

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; static constexpr int V = 4; };
template <> struct Vec16<double> { using type = double2; static constexpr int V = 2; };

template <typename T>
__global__ void __launch_bounds__(QM_COLS)
q_matrix_kernel(const sstt::Vec2<T>* __restrict__ eval, int64_t m,
                const sstt::Vec2<T>* __restrict__ pts, int64_t n, T* __restrict__ out) {
    using Vec = typename Vec16<T>::type;
    constexpr int V = Vec16<T>::V;
    constexpr int VECS_PER_ROW = QM_COLS / V;
    __shared__ sstt::Vec2<T> row_pts[QM_ROWS];
    __shared__ T tile[QM_ROWS][QM_COLS];

    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * QM_COLS;
    const int64_t i0 = static_cast<int64_t>(blockIdx.y) * QM_ROWS;
    const int rows = m - i0 < QM_ROWS ? static_cast<int>(m - i0) : QM_ROWS;
    const int cols = n - c0 < QM_COLS ? static_cast<int>(n - c0) : QM_COLS;
    if (threadIdx.x < rows) {
        row_pts[threadIdx.x] = eval[i0 + threadIdx.x];
    }
    __syncthreads();
    if (threadIdx.x < cols) {
        const sstt::Vec2<T> pj = pts[c0 + threadIdx.x];
        for (int r = 0; r < rows; ++r) {
            const T dx = row_pts[r].x - pj.x;
            const T dy = row_pts[r].y - pj.y;
            const T d2 = dx * dx + dy * dy;
            T q = T(0);
            if (d2 > T(0)) {
                const T inv = sstt::rsqrt_t(d2);
                q = sstt::one_over_4pi<T>() * (inv * inv * inv);
            }
            tile[r][threadIdx.x] = q;
        }
    }
    __syncthreads();
    for (int f = threadIdx.x; f < rows * VECS_PER_ROW; f += QM_COLS) {
        const int r = f / VECS_PER_ROW;
        const int k = f - r * VECS_PER_ROW;
        const int64_t start = (i0 + r) * n + c0;  // flat offset of the tile row
        T* seg = out + start;
        // Elements of this tile row before the first 16-byte boundary.
        const int head = static_cast<int>((V - (start & (V - 1))) & (V - 1));
        if (k == 0) {
            for (int e = 0; e < head && e < cols; ++e) {
                seg[e] = tile[r][e];
            }
        }
        const int j = head + k * V;
        if (j + V <= cols) {
            alignas(16) T vals[V];
#pragma unroll
            for (int e = 0; e < V; ++e) {
                vals[e] = tile[r][j + e];
            }
            *reinterpret_cast<Vec*>(seg + j) = *reinterpret_cast<const Vec*>(vals);
        } else {
            for (int e = j; e < cols; ++e) {
                seg[e] = tile[r][e];
            }
        }
    }
}

template <typename T>
int launch_q_matrix(const T* eval, int64_t m, const T* points, int64_t n, T* out,
                    void* stream) {
    if (m <= 0 || n <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const int64_t row_tiles = (m + QM_ROWS - 1) / QM_ROWS;
    if (row_tiles > 65535) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const dim3 grid(sstt::ceil_div(n, QM_COLS), static_cast<unsigned int>(row_tiles));
    q_matrix_kernel<T><<<grid, QM_COLS, 0, static_cast<cudaStream_t>(stream)>>>(
        reinterpret_cast<const sstt::Vec2<T>*>(eval), m,
        reinterpret_cast<const sstt::Vec2<T>*>(points), n, out);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sstt_q_matrix_f32(const float* points, int64_t n, float* out, void* stream) {
    return launch_q_matrix<float>(points, n, points, n, out, stream);
}

extern "C" int sstt_q_matrix_f64(const double* points, int64_t n, double* out, void* stream) {
    return launch_q_matrix<double>(points, n, points, n, out, stream);
}

extern "C" int sstt_q_matrix_rect_f32(const float* eval, int64_t m, const float* src, int64_t n,
                                      float* out, void* stream) {
    return launch_q_matrix<float>(eval, m, src, n, out, stream);
}

extern "C" int sstt_q_matrix_rect_f64(const double* eval, int64_t m, const double* src,
                                      int64_t n, double* out, void* stream) {
    return launch_q_matrix<double>(eval, m, src, n, out, stream);
}
