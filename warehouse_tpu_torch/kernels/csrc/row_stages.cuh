// The row-parallel learner stages shared by the recurrent PPO learner
// (K8/K9, sgd_rnn.cu: stages A, E and F) and the MLP PPO learner (K3/K4,
// sgd.cu: the forward, the dgrads and the weight gradients): products over
// all of a minibatch's rows at once, on mma_tiles.cuh's tile GEMMs.
//
// - rows_gemm_kernel: C = f(A Bt^T) over the rows of A as 64 x 128 tiles,
//   its k-slices through a cp.async ring; f in the epilogue: tanh(. + b),
//   . + b, or . (1 - a^2) (a dgrad through tanh). Bt is a weight copy
//   zero-padded to whole tiles (pad_jobs.cuh pad_copy).
// - wgrad_tn_kernel: weight gradients dW = delta^T prev over a range of
//   rows as 128 x 128 output tiles, one launch for several products
//   (FTask; a net with more products launches MAXT of them at a time),
//   split-K over row ranges with one partial per range (no atomics), and
//   the biases' sums in row order.
//
// bf16 operands (BF) run on the tensor cores as m16n8k16 with float32 sums
// (a zeroed fragment per 16-product chunk, then a rounded add); float32 as
// FFMA register blocks on the CUDA cores, each output's k's in order. Every
// sum runs in an order fixed by the shapes alone.
#pragma once

#include <cuda_runtime.h>

#include "mma_tiles.cuh"
#include "pad_jobs.cuh"

namespace {

constexpr int MAXT = 6;  // products of one wgrad_tn_kernel launch

__host__ __device__ inline int rup(long x, int m) {
  return (int)((x + m - 1) / m * m);
}

size_t smem_gemm() { return sizeof(float) * 2 * (BM + BN) * ldt<true>(); }
size_t smem_wgrad() { return sizeof(float) * 2 * 2 * EN * lde<false>(); }

// ---- products over the rows as 64 x 128 tile GEMMs --------------------------

enum Epi { EPI_TANH, EPI_BIAS, EPI_DTANH };

struct GemmArgs {
  const float* A;  // [rows, lda]: K columns read
  long lda, rows;
  const float* Bt;  // [grid.y BN rows, ldb]: W's rows of k, zero-padded
  long ldb;
  int K;               // a multiple of BK
  const float* bias;   // EPI_TANH / EPI_BIAS (null: none)
  const float* act;    // EPI_DTANH: the activation a of 1 - a^2
  long ldact;
  float* C;            // [rows, ldc]: columns < n, zeros in [n, ldc)
  long ldc;
  int n;
};

// C = f(A Bt^T): tanh(. + b) (a tanh layer), . + b (a linear product, the
// recurrent learner's gates' input side), or . (1 - a^2) (a dgrad through
// tanh). bf16 on the tensor cores,
// float32 as gemm_64x128_f32's register blocks.
template <bool BF, int EPI>
__global__ void __launch_bounds__(GNT) rows_gemm_kernel(GemmArgs p) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long q0 = (long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nvalid = p.rows - q0 < BM ? (int)(p.rows - q0) : BM;
  auto put = [&](int row, int j, float v) {
    if (row >= nvalid || j >= p.ldc) return;
    const long q = q0 + row;
    if (j >= p.n) {
      v = 0.f;
    } else if (EPI == EPI_TANH) {
      v = tanhf(v + p.bias[j]);
    } else if (EPI == EPI_BIAS) {
      if (p.bias) v += p.bias[j];
    } else {
      const float a = p.act[q * p.ldact + j];
      v *= 1.f - a * a;
    }
    p.C[q * p.ldc + j] = v;
  };
  const float* A = p.A + q0 * p.lda;
  const float* Bt = p.Bt + (long)n0 * p.ldb;
  if constexpr (BF) {
    const int g = lane >> 2, t = lane & 3, wm = warp >> 2, wn = warp & 3;
    float acc[2][4][4];
    zero_frags(acc);
    gemm_64x128<BF>(acc, A, p.lda, nvalid, Bt, p.ldb, p.K, smem);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          put(wm * 32 + 16 * mi + g + 8 * (r >> 1),
              n0 + wn * 32 + 8 * ni + 2 * t + (r & 1), acc[mi][ni][r]);
  } else {
    const int tr = tid / 16, tc = tid % 16;
    float acc[4][8] = {};
    gemm_64x128_f32(acc, A, p.lda, nvalid, Bt, p.ldb, p.K, smem);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) put(tr + 16 * i, n0 + tc + 16 * j, acc[i][j]);
  }
}

// ---- weight gradients as split-K 128 x 128 tiles ----------------------------

// A weight-gradient product's output tiles of 128 x 128 for a product out x in.
int f_tile_count(int out, int in) {
  return ((out + EJ - 1) / EJ) * ((in + EK - 1) / EK);
}

struct FTask {
  const float* delta;  // [rows, ldd]: the product's out columns
  long ldd;
  int out;
  const float* prev;   // [rows, ldp]: its in columns
  long ldp;
  int in;
  long w_off, b_off;   // b_off < 0: no bias from this product
  int b_lo, b_hi;      // the bias sums delta's columns [b_lo, b_hi)
  int i_tiles, tile0;
};

struct FArgs {
  FTask t[MAXT];
  int n;
  long rows, chunk, n_params;
  float* part;
};

FTask ftask(const float* delta, long ldd, int out, const float* prev, long ldp,
            int in, long w_off, long b_off, int b_lo, int b_hi, int* tiles) {
  FTask f = {delta, ldd, out, prev, ldp, in, w_off, b_off, b_lo, b_hi,
             (in + EK - 1) / EK, *tiles};
  *tiles += f_tile_count(out, in);
  return f;
}

template <bool BF>
__global__ void __launch_bounds__(GNT) wgrad_tn_kernel(FArgs p) {
  extern __shared__ __align__(16) float smem[];
  int l = 0;
  while (l + 1 < p.n && (int)blockIdx.x >= p.t[l + 1].tile0) ++l;
  const FTask& w = p.t[l];
  const int tile = blockIdx.x - w.tile0;
  const int j0 = tile / w.i_tiles * EJ, k0 = tile % w.i_tiles * EK;
  const long q0 = (long)blockIdx.y * p.chunk;
  const long q1 = q0 + p.chunk < p.rows ? q0 + p.chunk : p.rows;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* out = p.part + (long)blockIdx.y * p.n_params;
  auto put = [&](int j, int k, float v) {
    if (j < w.out && k < w.in) out[w.w_off + (long)j * w.in + k] = v;
  };
  float bsum = 0.f;
  const float* A = w.delta + j0;
  const float* B = w.prev + k0;
  const int a_cols = (w.out + 3) / 4 * 4 - j0;
  const int b_cols = (w.in + 3) / 4 * 4 - k0;
  if constexpr (BF) {
    const int g = lane >> 2, t = lane & 3, wj = warp >> 2, wk = warp & 3;
    float acc[4][4][4];
    zero_frags(acc);
    gemm_tn_128x128<BF>(acc, k0 == 0 ? &bsum : nullptr, A, w.ldd, a_cols, B,
                        w.ldp, b_cols, q0, q1, smem);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          put(j0 + wj * 64 + 16 * mi + g + 8 * (r >> 1),
              k0 + wk * 32 + 8 * ni + 2 * t + (r & 1), acc[mi][ni][r]);
  } else {
    const int tj = tid / 16, tk = tid % 16;
    float acc[8][8] = {};
    gemm_tn_128x128_f32(acc, k0 == 0 ? &bsum : nullptr, A, w.ldd, a_cols, B,
                        w.ldp, b_cols, q0, q1, smem);
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        put(j0 + 4 * tj + i % 4 + 64 * (i / 4),
            k0 + 4 * tk + j % 4 + 64 * (j / 4), acc[i][j]);
  }
  const int o = j0 + tid;
  if (k0 == 0 && tid < EJ && w.b_off >= 0 && o >= w.b_lo && o < w.b_hi)
    out[w.b_off + o - w.b_lo] = bsum;
}

// ---- host side ----------------------------------------------------------------

// wgrad_tn_kernel over `tasks` (ftask's, in order) on SF row ranges of
// `chunk` rows, MAXT products a launch, each launch's tiles numbered from
// 0: one launch for a net of up to MAXT products, as before any depth was
// taken. *launched gets the launches added.
template <bool BF>
cudaError_t launch_wgrad(std::vector<FTask> tasks, long rows, long chunk,
                         long n_params, float* part, int SF, size_t smem,
                         cudaStream_t stream, long* launched = nullptr) {
  for (size_t t0 = 0; t0 < tasks.size(); t0 += MAXT) {
    FArgs fa;
    fa.rows = rows;
    fa.chunk = chunk;
    fa.n_params = n_params;
    fa.part = part;
    fa.n = 0;
    int tiles = 0;
    for (size_t t = t0; t < tasks.size() && fa.n < MAXT; ++t) {
      FTask f = tasks[t];
      f.tile0 = tiles;
      tiles += f_tile_count(f.out, f.in);
      fa.t[fa.n++] = f;
    }
    wgrad_tn_kernel<BF><<<dim3(tiles, SF), GNT, smem, stream>>>(fa);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    if (launched) ++*launched;
  }
  return cudaSuccess;
}

template <class Kernel>
cudaError_t opt_in(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One rows_gemm_kernel launch; its grid covers ldc columns.
template <bool BF, int EPI>
cudaError_t launch_gemm(const GemmArgs& ga, cudaStream_t stream) {
  const size_t smem = smem_gemm();
  cudaError_t e = opt_in(rows_gemm_kernel<BF, EPI>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((ga.rows + BM - 1) / BM),
                  (unsigned)((ga.ldc + BN - 1) / BN));
  rows_gemm_kernel<BF, EPI><<<grid, GNT, smem, stream>>>(ga);
  return cudaGetLastError();
}

GemmArgs gemm_args(const float* A, long lda, long rows, const float* Bt,
                   int K, const float* bias, const float* act, long ldact,
                   float* C, long ldc, int n) {
  return GemmArgs{A, lda, rows, Bt, K, K, bias, act, ldact, C, ldc, n};
}

}  // namespace
