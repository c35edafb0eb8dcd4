// Mixed-precision residual R = H + A X of a film system: A (m, n) float32,
// X (n, k) float64, H and R (m, k) float64, k <= 8; every product and sum
// in float64 (widening a float32 is exact, so R is the float64 residual of
// the stored float32 system).
//
// Replaces no Pallas kernel: the JAX package computes this residual in
// plain XLA (_residual_f64 of superscreen_tpu/certify.py, row blocks of A
// widened on the fly).  It is written by hand because no single PyTorch
// call computes it and the several-call route (widen a row block, addmm)
// writes and reads 8 n^2 bytes beside the 4 n^2 it must read.
//
// Bound: A is read once, 4 m n bytes (1.12 GB at m = n = 16,768: 0.336 ms
// at 3.35 TB/s); X, H and R are megabytes.  The 2 m n k float64 operations
// take 0.13 ms at k = 8, so the bytes bound it for every k <= 8.
//
// Design: a block of RF_WARPS warps owns RF_WARPS * RF_ROWS rows; each
// warp keeps the sums of its RF_ROWS rows by K columns in registers and
// walks the columns of A in tiles of RF_TILE, lane l reading element
// 32 u + l of each row (128 contiguous bytes per warp and row, any n: no
// alignment is asked of the row starts).  The tile of X is staged in
// shared memory once per block, column-major (xs[c][j]) so that the lanes
// of a warp read neighbouring words, and serves all the block's rows: X
// goes through L2 once per block, not once per row.  Two buffers let the
// next tile be staged while this one is consumed, with one barrier per
// tile.  At the end each warp adds its lanes' sums with a butterfly of
// shuffles: a fixed order, no atomics, so two launches give the same bits.

#include "common.cuh"

namespace {

constexpr int RF_WARPS = 8;
constexpr int RF_ROWS = 4;               // rows per warp
constexpr int RF_UNROLL = 4;             // 32-column chunks per tile
constexpr int RF_TILE = 32 * RF_UNROLL;  // columns of A (rows of X) per tile
constexpr int RF_THREADS = 32 * RF_WARPS;
constexpr int RF_BLOCK_ROWS = RF_WARPS * RF_ROWS;

// Stages rows [j0, j0 + RF_TILE) of X into xs[c][j], zero past n and past
// the k columns X really has.
template <int K>
__device__ __forceinline__ void stage_tile(const double* __restrict__ X, int64_t n, int k,
                                           int64_t j0, double (*xs)[RF_TILE]) {
    for (int e = threadIdx.x; e < RF_TILE * K; e += RF_THREADS) {
        const int j = e / K;
        const int c = e - j * K;
        double v = 0.0;
        if (j0 + j < n && c < k) {
            v = X[(j0 + j) * k + c];
        }
        xs[c][j] = v;
    }
}

template <int K>
__global__ void __launch_bounds__(RF_THREADS, 2)
residual_f64_kernel(const float* __restrict__ A, const double* __restrict__ X,
                    const double* __restrict__ H, int64_t m, int64_t n, int k,
                    double* __restrict__ R) {
    __shared__ double xs[2][K][RF_TILE];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int64_t row0 = static_cast<int64_t>(blockIdx.x) * RF_BLOCK_ROWS + warp * RF_ROWS;

    const float* rows[RF_ROWS];
    bool live[RF_ROWS];
#pragma unroll
    for (int r = 0; r < RF_ROWS; ++r) {
        live[r] = row0 + r < m;
        rows[r] = A + (live[r] ? row0 + r : 0) * n;
    }
    double acc[RF_ROWS][K];
#pragma unroll
    for (int r = 0; r < RF_ROWS; ++r) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
            acc[r][c] = 0.0;
        }
    }

    const int64_t tiles = (n + RF_TILE - 1) / RF_TILE;
    stage_tile<K>(X, n, k, 0, xs[0]);
    __syncthreads();
    for (int64_t t = 0; t < tiles; ++t) {
        const int64_t j0 = t * RF_TILE;
        // This tile's elements of A first, so that their loads are in
        // flight while the next tile of X is staged.
        float a[RF_ROWS][RF_UNROLL];
#pragma unroll
        for (int r = 0; r < RF_ROWS; ++r) {
#pragma unroll
            for (int u = 0; u < RF_UNROLL; ++u) {
                const int64_t j = j0 + 32 * u + lane;
                a[r][u] = (live[r] && j < n) ? __ldcs(rows[r] + j) : 0.0f;
            }
        }
        if (t + 1 < tiles) {
            stage_tile<K>(X, n, k, j0 + RF_TILE, xs[(t + 1) & 1]);
        }
        const double(*x)[RF_TILE] = xs[t & 1];
#pragma unroll
        for (int u = 0; u < RF_UNROLL; ++u) {
            double xv[K];
#pragma unroll
            for (int c = 0; c < K; ++c) {
                xv[c] = x[c][32 * u + lane];
            }
#pragma unroll
            for (int r = 0; r < RF_ROWS; ++r) {
                const double av = static_cast<double>(a[r][u]);
#pragma unroll
                for (int c = 0; c < K; ++c) {
                    acc[r][c] = fma(av, xv[c], acc[r][c]);
                }
            }
        }
        // The next iteration overwrites the buffer read here, and reads the
        // one written here.
        __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < RF_ROWS; ++r) {
#pragma unroll
        for (int c = 0; c < K; ++c) {
            double v = acc[r][c];
#pragma unroll
            for (int offset = 16; offset > 0; offset >>= 1) {
                v += __shfl_xor_sync(0xffffffffu, v, offset);
            }
            if (lane == r * K + c && live[r] && c < k) {
                const int64_t at = (row0 + r) * k + c;
                R[at] = H[at] + v;
            }
        }
    }
}

template <int K>
cudaError_t launch(const float* A, const double* X, const double* H, int64_t m, int64_t n,
                   int k, double* R, cudaStream_t stream) {
    static_assert(RF_ROWS * K <= 32, "one lane per (row, column) of a warp's sums");
    residual_f64_kernel<K><<<sstt::ceil_div(m, RF_BLOCK_ROWS), RF_THREADS, 0, stream>>>(
        A, X, H, m, n, k, R);
    return cudaGetLastError();
}

}  // namespace

// R = H + A X for 1 <= k <= 8 columns (wider right-hand sides are cut into
// chunks of 8 by the caller).  A (m, n) float32 row-major, X (n, k), H and
// R (m, k) float64 row-major.
extern "C" int sstt_residual_f64(const float* A, const double* X, const double* H, int64_t m,
                                 int64_t n, int64_t k, double* R, void* stream) {
    if (m <= 0 || k <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    if (k > 8 || n < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cols = static_cast<int>(k);
    switch (sstt::chunk_width(k)) {
        case 1: return static_cast<int>(launch<1>(A, X, H, m, n, cols, R, s));
        case 2: return static_cast<int>(launch<2>(A, X, H, m, n, cols, R, s));
        case 4: return static_cast<int>(launch<4>(A, X, H, m, n, cols, R, s));
        default: return static_cast<int>(launch<8>(A, X, H, m, n, cols, R, s));
    }
}
