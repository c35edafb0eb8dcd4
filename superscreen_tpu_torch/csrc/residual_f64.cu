// Mixed-precision residual R = H + A X of a film system: A (m, n) float32,
// X (n, k) float32 or float64 (row-major, or column-major as the transpose
// of a contiguous (k, n)), H (m, k) float32, float64 or absent, R (m, k)
// float64 or float32 (the float64 sum rounded once).  Every product and
// sum is float64; widening a float32 is exact, so R is the float64
// residual of the stored float32 system.  One call reads A once, at any k.
//
// Replaces no Pallas kernel: the JAX package computes this residual in
// plain XLA (_residual_f64 of superscreen_tpu/certify.py:104, row blocks of
// A widened on the fly).  It is written by hand because no single PyTorch
// call computes it and the several-call route (widen a row block, addmm)
// writes and reads 8 n^2 bytes beside the 4 n^2 it must read.
//
// Two routes, chosen by ops/cuda_kernels.residual_plan from k and the
// alignment of A's rows:
// - the stream route (this file), k <= 11 where every row is 16-byte
//   aligned (TMA copies) and k <= 5 otherwise (cp.async windows): 4 m n
//   bytes of A bound it (0.336 ms at m = n = 16,768 and 3.35 TB/s), while
//   its 2 m n k float64 operations would take 0.18 ms at k = 11 on the
//   FP64 units.  Lanes own rows and warps own columns: each lane keeps the
//   sums of 2 rows by k columns in registers, reads its 8 columns of a row
//   with two or three 16-byte shared loads, and every value of X it
//   multiplies them with is a broadcast (one read serves the 64 rows of
//   the work item).  Past those k its instructions per FMA bound it.
// - the tensor-core route (residual_f64_mma.cu), larger k: the FP64
//   tensor cores' 67 TFLOP/s bound it from k ~ 40, the bytes below.
//
// What both routes share (residual_f64.cuh):
// - A persistent grid of 132 SMs x 2 blocks walks work items: a block of
//   rows (and of columns of R on the tensor-core route) times one split of
//   the columns of A into whole tiles (split-K), so that a few row blocks
//   (m = 5,594) still fill the card and m = 20,274 has no tail wave; the
//   splits of one row block are adjacent items, so that the blocks in
//   flight walk few rows (few pages) at once.  The
//   splits' float64 partial sums go to a scratch buffer and a second pass
//   of the same call adds them in a fixed order, with H: no atomics, so
//   two launches give the same bits.
// - A and X stream through a ring of shared-memory stages with 16-byte
//   cp.async copies in flight (4 stages here, 3 on the tensor-core route).
//   Each row lands as a window that starts at the 16-byte boundary below
//   the tile, so that a row that is not 16-byte aligned (an odd n, a row
//   view) is copied in 16-byte pieces too, with an element-wise head and
//   tail only at the matrix's first and last column; the arithmetic adds
//   the row's shift (0-3 floats) where it reads.  On the stream route,
//   where A is 16-byte aligned and n a multiple of 4 (every row aligned),
//   each tile of A arrives instead by TMA: two boxes of 64 rows by 32
//   columns, one thread's two instructions per stage, completing on the
//   stage's mbarrier, with zeros past row m and column n and the 128-byte
//   swizzle (16-byte chunk c of row r at c ^ (r % 8)), under which the 8
//   rows that a quarter warp reads fall in 8 bank groups.  The tensor map
//   is encoded per call by cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (the ctypes build does not link libcuda).
//   cp.async.bulk without a tensor map, one 256-byte copy per row and
//   tile, took 0.664 ms at 16,768^2, k = 1, against the windows' 0.412
//   (H100 80GB HBM3, 700 W, tools/kernel_turns.py): 64 small copies per
//   stage pace the TMA unit.
// - Each tile of X is widened (and, column-major, transposed) once per
//   stage into a float64 buffer that all warps read.

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked

#include <utility>

#include "residual_f64.cuh"

namespace sstt {
namespace residual {
namespace {

constexpr int ROWS_PER_LANE = STREAM_ROWS_PER_LANE;

// TMA's stream route: boxes of TMA_BOX_ROWS rows by TMA_BOX_COLS columns
// (128 bytes, the widest row the 128-byte swizzle takes), two per tile.
constexpr int TMA_BOX_COLS = 32;
constexpr int TMA_BOX_ROWS = STREAM_ROWS;
constexpr int TMA_BOX_BYTES = TMA_BOX_ROWS * TMA_BOX_COLS * 4;
// The 128-byte swizzle repeats every 1,024 bytes, where each box must start.
constexpr int TMA_ALIGN = 1024;

// The box of `map` at column x and row y into shared memory at `dst`,
// completing as transaction bytes on the mbarrier at shared address `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, int x, int y,
                                         unsigned bar) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3}], [%4];\n"
        ::"r"(d), "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

// The one arrival of the barrier's phase, which then waits for `bytes`.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
    asm volatile(
        "{\n"
        ".reg .pred done;\n"
        "WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
        "@!done bra WAIT;\n"
        "}\n" ::"r"(bar), "r"(parity) : "memory");
}

template <int K, typename XT>
struct StreamSmem {
    static constexpr int A_BYTES = STREAM_ROWS * STREAM_A_STRIDE * 4;
    // The raw X tile: one window of STREAM_TILE rows of X (row-major), or
    // K windows of STREAM_TILE values, one per column (column-major); each
    // window one chunk longer than its values (stage_window).
    static constexpr int XE = 16 / static_cast<int>(sizeof(XT));
    static constexpr int X_COL_STRIDE = STREAM_TILE + XE;
    static constexpr int X_BYTES = K * X_COL_STRIDE * static_cast<int>(sizeof(XT));
    // Each stage starts at a multiple of TMA_ALIGN bytes.
    static constexpr int STAGE_BYTES = (A_BYTES + X_BYTES + TMA_ALIGN - 1) / TMA_ALIGN * TMA_ALIGN;
    static constexpr int RING_BYTES = STREAM_STAGES * STAGE_BYTES;
    // Row stride of the cross-warp sums: odd, so that 16 lanes' rows
    // fall in 16 bank pairs.
    static constexpr int KP = K % 2 == 0 ? K + 1 : K;
    static constexpr int RED_BYTES = WARPS * STREAM_ROWS * KP * 8;
    // Row stride of the widened X tile: even, so that pairs of columns
    // are one 16-byte broadcast.
    static constexpr int KX = (K + 1) & ~1;
    static constexpr int XD_OFFSET = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
    // The stages' mbarriers (TMA).
    static constexpr int BAR_OFFSET = XD_OFFSET + STREAM_TILE * KX * 8;
    // TMA_ALIGN more: the kernel moves its base up to a multiple of it.
    static constexpr int BYTES = BAR_OFFSET + STREAM_STAGES * 8 + TMA_ALIGN;
};

// v[s + j]: the j-th value of a row window shifted by s (0-3) elements.
__device__ __forceinline__ float pick(const float (&v)[12], int s, int j) {
    return s == 0 ? v[j] : s == 1 ? v[j + 1] : s == 2 ? v[j + 2] : v[j + 3];
}

// TMA: every row of A is 16-byte aligned, and the tiles of A arrive by
// TMA through `map` (A as n columns by m rows); otherwise by the windows,
// and `map` is not read.
template <int K, typename XT, bool TMA>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    stream_kernel(const Args a, const __grid_constant__ CUtensorMap map) {
    using S = StreamSmem<K, XT>;
    constexpr int XE = S::XE;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + (TMA_ALIGN - static_cast<unsigned>(__cvta_generic_to_shared(smem_raw)) % TMA_ALIGN) %
                       TMA_ALIGN;
    double* xd = reinterpret_cast<double*>(smem + S::XD_OFFSET);
    const unsigned bars = static_cast<unsigned>(__cvta_generic_to_shared(smem + S::BAR_OFFSET));
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const XT* X = static_cast<const XT*>(a.X);
    const bool x_rows = a.xs_col == 1;  // row-major (n, k), rows k apart
    const int64_t items = a.row_blocks * a.splits;
    // Bit s: the parity of stage s's mbarrier phase that its next tile
    // completes.
    unsigned parity = 0;
    if (TMA) {
        if (threadIdx.x == 0) {
            for (int s = 0; s < STREAM_STAGES; ++s) {
                mbar_init(bars + 8 * s);
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        __syncthreads();
    }

    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        // The splits of one row block are adjacent: the blocks in flight
        // walk few rows (few pages) at several column ranges.
        const int64_t split = item % a.splits;
        const int64_t row0 = (item / a.splits) * STREAM_ROWS;
        const int rows_valid = static_cast<int>(min(static_cast<int64_t>(STREAM_ROWS), a.m - row0));
        const int64_t t0 = split * a.split_tiles;
        const int64_t t1 = min(t0 + a.split_tiles, a.tiles);
        // The window shift of this lane's rows (lane and lane + 32: 128 n
        // bytes apart, the same shift); tiles start at multiples of 16 bytes.
        const int shift = shift_of(a.A + (row0 + lane) * a.n);

        auto load_stage = [&](int64_t t) {
            const int st = static_cast<int>((t - t0) % STREAM_STAGES);
            unsigned char* stage = smem + st * S::STAGE_BYTES;
            const int64_t j0 = t * STREAM_TILE;
            if (TMA) {
                if (threadIdx.x == 0) {  // zeros past row m and column n count as bytes
                    mbar_expect(bars + 8 * st, 2 * TMA_BOX_BYTES);
                    for (int b = 0; b < 2; ++b) {
                        tma_load(stage + b * TMA_BOX_BYTES, map,
                                 static_cast<int>(j0) + b * TMA_BOX_COLS, static_cast<int>(row0),
                                 bars + 8 * st);
                    }
                }
            } else {
                stage_window<float>(reinterpret_cast<float*>(stage), STREAM_A_STRIDE,
                                    a.A + row0 * a.n, a.n, STREAM_ROWS, rows_valid, j0, a.n,
                                    STREAM_TILE / 4 + 1);
            }
            XT* xs = reinterpret_cast<XT*>(stage + S::A_BYTES);
            if (x_rows) {  // one contiguous run of STREAM_TILE rows of X
                stage_window<XT>(xs, 0, X, 0, 1, 1, j0 * K, a.n * K, STREAM_TILE * K / XE + 1);
            } else {       // K runs of STREAM_TILE values, one per column of X
                stage_window<XT>(xs, S::X_COL_STRIDE, X, a.xs_col, K, K, j0, a.n,
                                 STREAM_TILE / XE + 1);
            }
        };

        double acc[ROWS_PER_LANE][K];
#pragma unroll
        for (int r = 0; r < ROWS_PER_LANE; ++r) {
#pragma unroll
            for (int c = 0; c < K; ++c) {
                acc[r][c] = 0.0;
            }
        }
#pragma unroll
        for (int s = 0; s < STREAM_STAGES - 1; ++s) {
            if (t0 + s < t1) {
                load_stage(t0 + s);
            }
            cp_async_commit();
        }
        for (int64_t t = t0; t < t1; ++t) {
            const int st = static_cast<int>((t - t0) % STREAM_STAGES);
            cp_async_wait<STREAM_STAGES - 2>();
            if (TMA) {
                mbar_wait(bars + 8 * st, parity >> st & 1u);
                parity ^= 1u << st;
            }
            __syncthreads();
            const int64_t j0 = t * STREAM_TILE;
            const unsigned char* stage = smem + st * S::STAGE_BYTES;
            const XT* xr = reinterpret_cast<const XT*>(stage + S::A_BYTES);
            const int x_shift = shift_of(X + j0 * K);
            for (int o = threadIdx.x; o < STREAM_TILE * K; o += THREADS) {
                const int p = o / K;
                const int c = o - p * K;
                const XT v = x_rows ? xr[x_shift + o]
                                    : xr[c * S::X_COL_STRIDE + shift_of(X + c * a.xs_col + j0) + p];
                xd[p * S::KX + c] = static_cast<double>(v);
            }
            // The stage read in the previous iteration is free: every
            // thread has passed the barrier above.
            if (t + STREAM_STAGES - 1 < t1) {
                load_stage(t + STREAM_STAGES - 1);
            }
            cp_async_commit();
            __syncthreads();
            float av[ROWS_PER_LANE][8];
            if (TMA) {
                // This warp's 8 columns of each of the lane's rows: chunks
                // 2 (warp % 4) and the next of box warp / 4, row R's chunk
                // c at c ^ (R % 8) (R % 8 = lane % 8).
                const float* box =
                    reinterpret_cast<const float*>(stage) + (warp >> 2) * (TMA_BOX_BYTES / 4);
#pragma unroll
                for (int r = 0; r < ROWS_PER_LANE; ++r) {
                    const float* row = box + (lane + 32 * r) * TMA_BOX_COLS;
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int c = (2 * (warp & 3) + q) ^ (lane & 7);
                        const float4 v = *reinterpret_cast<const float4*>(row + 4 * c);
                        av[r][4 * q] = v.x;
                        av[r][4 * q + 1] = v.y;
                        av[r][4 * q + 2] = v.z;
                        av[r][4 * q + 3] = v.w;
                    }
                }
            } else {
                // This warp's 8 columns of each of the lane's rows: three
                // aligned 16-byte reads of the shifted window, then the 8 values.
                const float* as = reinterpret_cast<const float*>(stage) + 8 * warp;
#pragma unroll
                for (int r = 0; r < ROWS_PER_LANE; ++r) {
                    const float* row = as + (lane + 32 * r) * STREAM_A_STRIDE;
                    float v[12];
                    // Unshifted rows (every row where 4 n bytes is a multiple
                    // of 16 and A is aligned) read two chunks and pick nothing.
                    const int chunks = shift == 0 ? 2 : 3;
#pragma unroll
                    for (int q = 0; q < 3; ++q) {
                        if (q < chunks) {
                            const float4 c = *reinterpret_cast<const float4*>(row + 4 * q);
                            v[4 * q] = c.x;
                            v[4 * q + 1] = c.y;
                            v[4 * q + 2] = c.z;
                            v[4 * q + 3] = c.w;
                        }
                    }
                    if (shift == 0) {
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            av[r][j] = v[j];
                        }
                    } else {
#pragma unroll
                        for (int j = 0; j < 8; ++j) {
                            av[r][j] = pick(v, shift, j);
                        }
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                double ad[ROWS_PER_LANE];
#pragma unroll
                for (int r = 0; r < ROWS_PER_LANE; ++r) {
                    ad[r] = static_cast<double>(av[r][j]);
                }
                const double* x = xd + (8 * warp + j) * S::KX;
#pragma unroll
                for (int c = 0; c < K; c += 2) {
                    double xv[2];
                    if (c + 1 < K) {
                        const double2 v = *reinterpret_cast<const double2*>(x + c);
                        xv[0] = v.x;
                        xv[1] = v.y;
                    } else {
                        xv[0] = x[c];
                    }
#pragma unroll
                    for (int u = 0; u < 2; ++u) {
                        if (c + u < K) {
#pragma unroll
                            for (int r = 0; r < ROWS_PER_LANE; ++r) {
                                acc[r][c + u] = fma(ad[r], xv[u], acc[r][c + u]);
                            }
                        }
                    }
                }
            }
        }
        cp_async_wait<0>();
        __syncthreads();
        // The warps' sums of each row, added in warp order.
        double* red = reinterpret_cast<double*>(smem);
#pragma unroll
        for (int r = 0; r < ROWS_PER_LANE; ++r) {
#pragma unroll
            for (int c = 0; c < K; ++c) {
                red[(warp * STREAM_ROWS + lane + 32 * r) * S::KP + c] = acc[r][c];
            }
        }
        __syncthreads();
        for (int o = threadIdx.x; o < STREAM_ROWS * K; o += THREADS) {
            const int r = o / K;
            const int c = o - r * K;
            double sum = red[r * S::KP + c];
#pragma unroll
            for (int w = 1; w < WARPS; ++w) {
                sum += red[(w * STREAM_ROWS + r) * S::KP + c];
            }
            if (r < rows_valid) {
                store_sum(a, split, (row0 + r) * K + c, sum);
            }
        }
        if (TMA) {
            // Order this thread's writes of red before the next item's TMA
            // copies to the same bytes.
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        __syncthreads();  // the next item's copies overwrite red
    }
}

// R = H + the splits' partial sums, added in split order.
__global__ void finish_kernel(const Args a) {
    const int64_t count = a.m * a.k;
    const int64_t at = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
    if (at >= count) {
        return;
    }
    double sum = a.partial[at];
    for (int64_t s = 1; s < a.splits; ++s) {
        sum += a.partial[s * count + at];
    }
    store_result(a, at, sum);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime (null
// where libcuda lacks it).
EncodeTiled encode_tiled() {
    static const EncodeTiled encode = [] {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t err = cudaGetDriverEntryPointByVersion(
            "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
        const cudaError_t err =
            cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
        return err == cudaSuccess && found == cudaDriverEntryPointSuccess
                   ? reinterpret_cast<EncodeTiled>(fn)
                   : nullptr;
    }();
    return encode;
}

// A (m rows of n floats, rows 4 n bytes apart, 16-byte aligned) as TMA's
// boxes of TMA_BOX_ROWS x TMA_BOX_COLS with the 128-byte swizzle.
cudaError_t encode_rows(const Args& a, CUtensorMap* map) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) {
        return cudaErrorNotSupported;
    }
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.n), static_cast<cuuint64_t>(a.m)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(a.n) * 4};
    const cuuint32_t box[2] = {TMA_BOX_COLS, TMA_BOX_ROWS};
    const cuuint32_t steps[2] = {1, 1};
    const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(a.A),
                                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int K, typename XT, bool TMA>
cudaError_t launch_copy(const Args& a, const CUtensorMap& map, int grid, cudaStream_t s) {
    static std::atomic<unsigned> done{0};
    const int bytes = StreamSmem<K, XT>::BYTES;
    const cudaError_t err = allow_shared_bytes(stream_kernel<K, XT, TMA>, bytes, done);
    if (err != cudaSuccess) {
        return err;
    }
    stream_kernel<K, XT, TMA><<<grid, THREADS, bytes, s>>>(a, map);
    return cudaGetLastError();
}

// Rows of A that are all 16-byte aligned take TMA, others the windows
// (built for k <= STREAM_WINDOWS_MAX_K only).
template <int K, typename XT>
cudaError_t launch_k(const Args& a, int grid, cudaStream_t s) {
    CUtensorMap map{};
    const bool tma = reinterpret_cast<uintptr_t>(a.A) % 16 == 0 && a.n % 4 == 0 && a.n > 0;
    if (!tma) {
        if constexpr (K <= STREAM_WINDOWS_MAX_K) {
            return launch_copy<K, XT, false>(a, map, grid, s);
        }
        return cudaErrorInvalidValue;
    }
    const cudaError_t err = encode_rows(a, &map);
    return err != cudaSuccess ? err : launch_copy<K, XT, true>(a, map, grid, s);
}

// The fewer blocks per SM of the copy routes that width K has.
template <int K, typename XT>
int occupancy_k(int64_t* smem_bytes) {
    const int bytes = StreamSmem<K, XT>::BYTES;
    *smem_bytes = bytes;
    const int tma = occupancy(stream_kernel<K, XT, true>, bytes);
    if constexpr (K <= STREAM_WINDOWS_MAX_K) {
        const int windows = occupancy(stream_kernel<K, XT, false>, bytes);
        return tma < windows ? tma : windows;
    }
    return tma;
}

template <typename XT, int... Ks>
cudaError_t launch_width(int width, const Args& a, int grid, cudaStream_t s,
                         std::integer_sequence<int, Ks...>) {
    cudaError_t err = cudaErrorInvalidValue;
    ((width == Ks + 1 ? (err = launch_k<Ks + 1, XT>(a, grid, s), 0) : 0), ...);
    return err;
}

template <typename XT, int... Ks>
int occupancy_width(int width, int64_t* smem_bytes, std::integer_sequence<int, Ks...>) {
    int blocks = 0;
    ((width == Ks + 1 ? (blocks = occupancy_k<Ks + 1, XT>(smem_bytes), 0) : 0), ...);
    return blocks;
}

using Widths = std::make_integer_sequence<int, STREAM_MAX_K>;

}  // namespace

cudaError_t launch_stream(const Args& a, int width, int x_double, int grid, cudaStream_t s) {
    return x_double ? launch_width<double>(width, a, grid, s, Widths{})
                    : launch_width<float>(width, a, grid, s, Widths{});
}

int occupancy_stream(int width, int x_double, int64_t* smem_bytes) {
    *smem_bytes = 0;
    return x_double ? occupancy_width<double>(width, smem_bytes, Widths{})
                    : occupancy_width<float>(width, smem_bytes, Widths{});
}

}  // namespace residual
}  // namespace sstt

using sstt::residual::Args;

// R = H + A X, one call: route 0 is the stream route (width = k <= 11 with
// every row of A 16-byte aligned, <= 5 otherwise),
// route 1 the tensor-core route (width = 8 NT columns of R per work item);
// rows and tile are the plan's rows per work item and columns of A per
// stage, which must be this build's; the columns of A are cut into
// `splits` runs of `split_tiles` tiles (the last may be shorter, none is
// empty), with partial sums in `partial` ((splits, m, k) float64) when
// splits > 1.  X's element (j, c) is at j * xs_row + c * xs_col, with
// xs_col = 1 (row-major; rows k apart on the stream route) or xs_row = 1.
// Returns the first CUDA error.
extern "C" int sstt_residual_f64(const float* A, const void* X, int x_double, int64_t xs_row,
                                 int64_t xs_col, const void* H, int h_double, void* R,
                                 int r_double, int64_t m, int64_t n, int64_t k, int route,
                                 int64_t width, int64_t rows, int64_t tile, int64_t grid,
                                 int64_t splits, int64_t split_tiles, double* partial,
                                 void* stream) {
    using namespace sstt::residual;
    if (m <= 0 || k <= 0) {
        return static_cast<int>(cudaSuccess);
    }
    const bool streamed = route == 0;
    const bool shape_ok =
        n >= 0 && (route == 0 || route == 1) && grid >= 1 && splits >= 1 && split_tiles >= 1 &&
        (splits == 1 || partial != nullptr) && (xs_col == 1 || xs_row == 1) &&
        rows == (streamed ? STREAM_ROWS : MMA_ROWS) && tile == (streamed ? STREAM_TILE : MMA_TILE) &&
        (streamed ? width == k && width <= STREAM_MAX_K && (xs_col != 1 || xs_row == k)
                  : width == 16 || width == 32 || width == 64);
    if (!shape_ok) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    Args a{A, X, xs_row, xs_col, H, h_double, R, r_double, partial, m, n, k,
           (n + tile - 1) / tile, splits, split_tiles, (m + rows - 1) / rows,
           streamed ? 1 : (k + width - 1) / width};
    const int64_t items = a.row_blocks * a.col_blocks * splits;
    if (splits * split_tiles < a.tiles || (splits > 1 && (splits - 1) * split_tiles >= a.tiles) ||
        grid > items || grid > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = streamed ? launch_stream(a, static_cast<int>(width), x_double,
                                               static_cast<int>(grid), s)
                               : launch_mma(a, static_cast<int>(width), x_double,
                                            static_cast<int>(grid), s);
    if (err == cudaSuccess && splits > 1) {
        sstt::residual::finish_kernel<<<sstt::ceil_div(m * k, THREADS), THREADS, 0, s>>>(a);
        err = cudaGetLastError();
    }
    return static_cast<int>(err);
}

// Blocks per SM (the occupancy calculator's) and dynamic shared memory of
// the instantiation that a plan with this route and width launches.
extern "C" void sstt_residual_geometry(int route, int64_t width, int x_double,
                                       int64_t* blocks_per_sm, int64_t* smem_bytes) {
    using namespace sstt::residual;
    *blocks_per_sm = route == 0 ? occupancy_stream(static_cast<int>(width), x_double, smem_bytes)
                                : occupancy_mma(static_cast<int>(width), x_double, smem_bytes);
}
