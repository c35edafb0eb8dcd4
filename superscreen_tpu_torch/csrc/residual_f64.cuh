// Pieces shared by the two routes of residual_f64 (R = H + A X with a
// float32 A and every product and sum in float64): the stream route
// (residual_f64.cu) and the FP64 tensor-core route (residual_f64_mma.cu).
// ops/cuda_kernels.py (residual_plan) mirrors the constants below; the C
// entry point refuses a plan whose rows or tile width differ from them.
#pragma once

#include <atomic>
#include <cstdint>

#include "common.cuh"

namespace sstt {
namespace residual {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Blocks each SM holds at once (the dynamic shared memory of every
// instantiation stays under half of the SM's 228 KB): the persistent grid
// is 132 SMs times this.
constexpr int BLOCKS_PER_SM = 2;

// Stream route: each lane owns STREAM_ROWS_PER_LANE rows of a work item,
// each warp an eighth of the columns of every tile.
constexpr int STREAM_ROWS_PER_LANE = 2;
constexpr int STREAM_ROWS = 32 * STREAM_ROWS_PER_LANE;
constexpr int STREAM_TILE = 64;            // columns of A per stage
constexpr int STREAM_STAGES = 4;
// The widest k of the stream route with TMA (every row of A 16-byte
// aligned) and with its windows: RESIDUAL_MMA_MIN_K_ALIGNED - 1 and
// RESIDUAL_MMA_MIN_K - 1 of ops/cuda_kernels.py, where the tensor-core
// route takes over.
constexpr int STREAM_MAX_K = 11;
constexpr int STREAM_WINDOWS_MAX_K = 5;
// A row's window: the tile and one chunk more (stage_window); 68 floats,
// so that a quarter warp's 16-byte reads of 8 rows hit 8 bank groups.
constexpr int STREAM_A_STRIDE = STREAM_TILE + 4;

// Tensor-core route: warp w owns rows [16 w, 16 w + 16) of a 128-row work
// item and all of its 8 NT columns.
constexpr int MMA_ROWS = 16 * WARPS;
constexpr int MMA_TILE = 32;               // columns of A per stage (2 k-steps of 16)
constexpr int MMA_STAGES = 3;
constexpr int MMA_A_STRIDE = MMA_TILE + 4;  // floats: the tile and one chunk more

// What the C entry point is given: the plan of ops/cuda_kernels.residual_plan.
struct Args {
    const float* A;       // (m, n), row-major, rows n apart
    const void* X;        // (n, k): element (j, c) at X[j * xs_row + c * xs_col]
    int64_t xs_row;
    int64_t xs_col;
    const void* H;        // (m, k) row-major, or null
    int h_double;
    void* R;              // (m, k) row-major
    int r_double;
    double* partial;      // (splits, m, k) when splits > 1
    int64_t m, n, k;
    int64_t tiles;        // ceil(n / tile)
    int64_t splits;       // the column range of A cut into splits ...
    int64_t split_tiles;  // ... of split_tiles whole tiles each
    int64_t row_blocks;
    int64_t col_blocks;   // 1 on the stream route
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

template <int BYTES>
__device__ __forceinline__ void cp_async_small(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Elements of T by which p lies past the 16-byte boundary at or below it.
template <typename T>
__device__ __forceinline__ int shift_of(const T* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (16 / sizeof(T) - 1);
}

// Starts copying, for each of `rows` rows, a window of `chunks` 16-byte
// chunks of T into shared memory (row r at dst + r * dst_stride, a
// multiple of 16 bytes).  Row r runs from src + r * src_stride (global
// column 0); its window starts shift_of(row + col0) elements before
// column col0, at a 16-byte boundary, so that every chunk inside columns
// [0, total) is one 16-byte cp.async whatever the row's alignment (an odd
// n, a row view).  A chunk across column 0 or `total` is copied element by
// element, with zeros at columns >= total (and, never read, < 0); rows at
// or past rows_valid are zero.  A row whose shift is 0 skips the last
// chunk, which only a shifted row reads.  Consecutive threads take
// consecutive chunks of a row.
template <typename T>
__device__ __forceinline__ void stage_window(T* dst, int dst_stride, const T* src,
                                             int64_t src_stride, int rows, int rows_valid,
                                             int64_t col0, int64_t total, int chunks) {
    constexpr int E = 16 / sizeof(T);
    for (int i = threadIdx.x; i < rows * chunks; i += THREADS) {
        const int r = i / chunks;
        const int q = i - r * chunks;
        T* d = dst + r * dst_stride + q * E;
        const T* row = src + r * src_stride;
        const int shift = shift_of(row + col0);
        if (q == chunks - 1 && shift == 0) {
            continue;
        }
        const int64_t g = col0 - shift + q * E;  // the chunk's first column
        if (r < rows_valid && g >= 0 && g + E <= total) {
            cp_async16(d, row + g);
        } else {
#pragma unroll
            for (int e = 0; e < E; ++e) {
                if (r < rows_valid && g + e >= 0 && g + e < total) {
                    cp_async_small<sizeof(T)>(d + e, row + g + e);
                } else {
                    d[e] = T(0);
                }
            }
        }
    }
}

__device__ __forceinline__ double load_as_double(const void* p, int is_double, int64_t at) {
    return is_double ? static_cast<const double*>(p)[at]
                     : static_cast<double>(static_cast<const float*>(p)[at]);
}

// R[at] = H[at] + sum (sum alone without H), rounded once to R's dtype.
__device__ __forceinline__ void store_result(const Args& a, int64_t at, double sum) {
    const double v = a.H ? load_as_double(a.H, a.h_double, at) + sum : sum;
    if (a.r_double) {
        static_cast<double*>(a.R)[at] = v;
    } else {
        static_cast<float*>(a.R)[at] = __double2float_rn(v);
    }
}

// store_result, or the split's partial sum when the columns of A are split.
__device__ __forceinline__ void store_sum(const Args& a, int64_t split, int64_t at, double sum) {
    if (a.splits > 1) {
        a.partial[split * a.m * a.k + at] = sum;
    } else {
        store_result(a, at, sum);
    }
}

// Raises the dynamic shared-memory limit of `kernel` to `bytes` on the
// current device, once per device (`done` holds a bit per device).  The
// caller checks the result like a launch's.
template <typename Kernel>
cudaError_t allow_shared_bytes(Kernel kernel, int bytes, std::atomic<unsigned>& done) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess || (done.load() >> device & 1u)) {
        return err;
    }
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess) {
        done.fetch_or(1u << device);
    }
    return err;
}

// Blocks of THREADS threads with `bytes` of dynamic shared memory that one
// SM holds at once (-1 if the runtime refuses the question).
template <typename Kernel>
int occupancy(Kernel kernel, int bytes) {
    int blocks = 0;
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, bytes) !=
            cudaSuccess) {
        return -1;
    }
    return blocks;
}

// Launches of the stream route (residual_f64.cu) and of the tensor-core
// route (residual_f64_mma.cu) for `width` columns (k on the stream route,
// 8 NT on the tensor-core route); each sets its shared-memory attribute at
// first use and returns the first CUDA error.
cudaError_t launch_stream(const Args& args, int width, int x_double, int grid, cudaStream_t s);
cudaError_t launch_mma(const Args& args, int width, int x_double, int grid, cudaStream_t s);
// Blocks per SM that the occupancy calculator gives an instantiation, and
// its dynamic shared memory; a width the route does not have gives 0.
int occupancy_stream(int width, int x_double, int64_t* smem_bytes);
int occupancy_mma(int width, int x_double, int64_t* smem_bytes);

}  // namespace residual
}  // namespace sstt
