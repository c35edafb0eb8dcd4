// The FP64 tensor-core route of residual_f64 (R = H + A X, A float32,
// every product and sum float64): the route ops/cuda_kernels.residual_plan
// takes for wide right-hand sides (the adjoint scan's k = 64, the vortex
// landscape's blocks of 2,048 identity columns).  residual_f64.cu holds the
// stream route, the C entry point and the note on what the two share.
//
// Bound: 2 m n k float64 operations over the FP64 tensor cores' 67 TFLOP/s
// (13.7 ms at m = n = 15,000 and k = 2,048); 4 m n bytes of A over 3.35
// TB/s below k ~ 40.  wgmma has no float64 form, so the products are
// mma.sync m16n8k16 .f64 (DMMA, Hopper's widest float64 shape): warp w of
// a work item owns 16 rows by BN = 8 NT columns of R, and per k-step of 16
// columns of A loads its A fragment (8 values) once and multiplies it with
// NT fragments of X.  Each element of A is read from shared memory and
// widened to float64 once per stage tile, by the one lane whose fragment
// holds it; X is widened where its fragment is loaded.  Rows land as
// shifted 16-byte windows (residual_f64.cuh, stage_window), and each lane
// adds its row's (and, for a column-major X, its column's) shift to its
// fragment reads.  Work items are (row block, column block of R, split of
// the columns of A), the column blocks and then the splits of one row
// block adjacent, so that the blocks in flight share their rows of A in L2
// and walk few pages.

#include <utility>

#include "residual_f64.cuh"

namespace sstt {
namespace residual {
namespace {

template <int NT, typename XT>
struct MmaSmem {
    static constexpr int BN = 8 * NT;
    static constexpr int A_BYTES = MMA_ROWS * MMA_A_STRIDE * 4;
    // Row strides of the X tile, padded by 32 bytes (room for a window's
    // extra chunk): row-major, MMA_TILE rows of BN values; column-major, BN
    // rows of MMA_TILE.  Unshifted, the 4 x 8 lanes of a fragment load
    // fall in distinct banks either way.
    static constexpr int PAD = 32 / static_cast<int>(sizeof(XT));
    static constexpr int XE = 16 / static_cast<int>(sizeof(XT));
    static constexpr int X_ROW_STRIDE = BN + PAD;
    static constexpr int X_COL_STRIDE = MMA_TILE + PAD;
    static constexpr int X_ELEMS = MMA_TILE * X_ROW_STRIDE > BN * X_COL_STRIDE
                                       ? MMA_TILE * X_ROW_STRIDE
                                       : BN * X_COL_STRIDE;
    static constexpr int STAGE_BYTES = A_BYTES + X_ELEMS * static_cast<int>(sizeof(XT));
    // Narrow tiles, where the bytes of A bound the route, keep one stage
    // more in flight; two blocks of either still fit an SM.
    static constexpr int STAGES = NT < 8 ? MMA_STAGES + 1 : MMA_STAGES;
    static constexpr int BYTES = STAGES * STAGE_BYTES;
};

// d += a b for one m16n8k16 float64 fragment, g = lane / 4, t = lane % 4:
// a[v] = A[g + 8 (v % 2)][t + 4 (v / 2)], b[v] = B[t + 4 v][g],
// d[v] = D[g + 8 (v / 2)][2 t + v % 2].
__device__ __forceinline__ void dmma(double (&d)[4], const double (&a)[8], const double (&b)[4]) {
    asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
          "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

// One stage's products for a warp: `as` points at the lane's first A
// value (row 16 w + g, column t, shifted), `x_at(kk, v, nt)` gives the
// lane's X value for k-step kk, fragment value v and column tile nt.
template <int NT, typename XAt>
__device__ __forceinline__ void stage_products(double (&acc)[NT][4], const float* as, XAt x_at) {
#pragma unroll
    for (int kk = 0; kk < MMA_TILE; kk += 16) {
        double af[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
            af[v] = static_cast<double>(as[(v & 1) * 8 * MMA_A_STRIDE + kk + 4 * (v >> 1)]);
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            double bf[4];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
                bf[v] = x_at(kk, v, nt);
            }
            dmma(acc[nt], af, bf);
        }
    }
}

template <int NT, typename XT>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) mma_kernel(const Args a) {
    using S = MmaSmem<NT, XT>;
    constexpr int BN = S::BN;
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const XT* X = static_cast<const XT*>(a.X);
    const bool x_rows = a.xs_col == 1;
    const int64_t items = a.col_blocks * a.row_blocks * a.splits;

    for (int64_t item = blockIdx.x; item < items; item += gridDim.x) {
        const int64_t cb = item % a.col_blocks;
        const int64_t rest = item / a.col_blocks;
        const int64_t split = rest % a.splits;
        const int64_t rb = rest / a.splits;
        const int64_t row0 = rb * MMA_ROWS;
        const int64_t c0 = cb * BN;
        const int rows_valid = static_cast<int>(min(static_cast<int64_t>(MMA_ROWS), a.m - row0));
        const int cols_valid = static_cast<int>(min(static_cast<int64_t>(BN), a.k - c0));
        const int64_t t0 = split * a.split_tiles;
        const int64_t t1 = min(t0 + a.split_tiles, a.tiles);
        // Window shifts of the lane's rows of A (16 w + g and + 8: 32 n
        // bytes apart, the same shift) and, column-major, of its columns
        // of X; tiles start at multiples of 16 bytes.
        const int a_shift = shift_of(a.A + (row0 + 16 * warp + g) * a.n);
        int x_shift[NT];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
            x_shift[nt] = x_rows ? 0 : shift_of(X + (c0 + 8 * nt + g) * a.xs_col);
        }

        auto load_stage = [&](int64_t t) {
            unsigned char* stage = smem + static_cast<int>((t - t0) % S::STAGES) * S::STAGE_BYTES;
            const int64_t j0 = t * MMA_TILE;
            stage_window<float>(reinterpret_cast<float*>(stage), MMA_A_STRIDE, a.A + row0 * a.n,
                                a.n, MMA_ROWS, rows_valid, j0, a.n, MMA_TILE / 4 + 1);
            XT* xs = reinterpret_cast<XT*>(stage + S::A_BYTES);
            if (x_rows) {
                stage_window<XT>(xs, S::X_ROW_STRIDE, X + j0 * a.xs_row, a.xs_row, MMA_TILE,
                                 static_cast<int>(min(static_cast<int64_t>(MMA_TILE), a.n - j0)),
                                 c0, a.k, BN / S::XE + 1);
            } else {
                stage_window<XT>(xs, S::X_COL_STRIDE, X + c0 * a.xs_col, a.xs_col, BN, cols_valid,
                                 j0, a.n, MMA_TILE / S::XE + 1);
            }
        };

        double acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                acc[nt][e] = 0.0;
            }
        }
#pragma unroll
        for (int s = 0; s < S::STAGES - 1; ++s) {
            if (t0 + s < t1) {
                load_stage(t0 + s);
            }
            cp_async_commit();
        }
        for (int64_t t = t0; t < t1; ++t) {
            cp_async_wait<S::STAGES - 2>();
            __syncthreads();
            // The stage read in the previous iteration is free.
            if (t + S::STAGES - 1 < t1) {
                load_stage(t + S::STAGES - 1);
            }
            cp_async_commit();
            const unsigned char* stage =
                smem + static_cast<int>((t - t0) % S::STAGES) * S::STAGE_BYTES;
            const float* as = reinterpret_cast<const float*>(stage) +
                              (16 * warp + g) * MMA_A_STRIDE + a_shift + tq;
            const XT* xs = reinterpret_cast<const XT*>(stage + S::A_BYTES);
            if (x_rows) {
                // Row kk + t + 4 v of the tile is row j of X, shifted by its own
                // window shift (constant unless k * sizeof(XT) is not a
                // multiple of 16).
                const XT* xrow = X + (t * MMA_TILE + tq) * a.xs_row + c0;
                stage_products<NT>(acc, as, [&](int kk, int v, int nt) {
                    const int r = kk + tq + 4 * v;
                    const int shift = shift_of(xrow + (kk + 4 * v) * a.xs_row);
                    return static_cast<double>(xs[r * S::X_ROW_STRIDE + shift + 8 * nt + g]);
                });
            } else {
                stage_products<NT>(acc, as, [&](int kk, int v, int nt) {
                    return static_cast<double>(
                        xs[(8 * nt + g) * S::X_COL_STRIDE + x_shift[nt] + kk + tq + 4 * v]);
                });
            }
        }
        cp_async_wait<0>();
        __syncthreads();  // the next item's copies overwrite the ring
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int r = 16 * warp + g + 8 * (e >> 1);
                const int c = 8 * nt + 2 * tq + (e & 1);
                if (r < rows_valid && c < cols_valid) {
                    store_sum(a, split, (row0 + r) * a.k + c0 + c, acc[nt][e]);
                }
            }
        }
    }
}

template <int NT, typename XT>
cudaError_t launch_nt(const Args& a, int grid, cudaStream_t s) {
    static std::atomic<unsigned> done{0};
    const int bytes = MmaSmem<NT, XT>::BYTES;
    const cudaError_t err = allow_shared_bytes(mma_kernel<NT, XT>, bytes, done);
    if (err != cudaSuccess) {
        return err;
    }
    mma_kernel<NT, XT><<<grid, THREADS, bytes, s>>>(a);
    return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_width(int width, const Args& a, int grid, cudaStream_t s) {
    switch (width) {
        case 16: return launch_nt<2, XT>(a, grid, s);
        case 32: return launch_nt<4, XT>(a, grid, s);
        case 64: return launch_nt<8, XT>(a, grid, s);
        default: return cudaErrorInvalidValue;
    }
}

template <int NT, typename XT>
int occupancy_nt(int64_t* smem_bytes) {
    *smem_bytes = MmaSmem<NT, XT>::BYTES;
    return occupancy(mma_kernel<NT, XT>, MmaSmem<NT, XT>::BYTES);
}

template <typename XT>
int occupancy_width(int width, int64_t* smem_bytes) {
    switch (width) {
        case 16: return occupancy_nt<2, XT>(smem_bytes);
        case 32: return occupancy_nt<4, XT>(smem_bytes);
        case 64: return occupancy_nt<8, XT>(smem_bytes);
        default: *smem_bytes = 0; return 0;
    }
}

}  // namespace

cudaError_t launch_mma(const Args& a, int width, int x_double, int grid, cudaStream_t s) {
    return x_double ? launch_width<double>(width, a, grid, s)
                    : launch_width<float>(width, a, grid, s);
}

int occupancy_mma(int width, int x_double, int64_t* smem_bytes) {
    return x_double ? occupancy_width<double>(width, smem_bytes)
                    : occupancy_width<float>(width, smem_bytes);
}

}  // namespace residual
}  // namespace sstt
