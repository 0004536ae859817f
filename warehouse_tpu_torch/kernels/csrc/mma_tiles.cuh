// Warp-level tensor-core products and the tile GEMMs built on them, shared
// by the kernels that run their products as tiles: the CNN learner
// (K11/K12, sgd_cnn.cu), the recurrent learner (K8/K9, sgd_rnn.cu), the
// MLP learners (K3-K6) and the acting kernels' stages (K2, K7, K10).
// mma.sync on tiles that a stage keeps in shared memory (or, for small
// weights, reads through L1).
//
// A warp computes acc[MT][NT] (MT tiles of 16 rows by NT tiles of 8
// columns, each the m16n8 accumulator fragment: c0, c1 at row g, columns
// 2t and 2t + 1; c2, c3 at row g + 8; g = lane / 4, t = lane % 4) and adds
// the product of one chunk of 16 k's to it. The operands are read through
// loaders, so that a stage can gather them (an implicit convolution, a
// position's shifted row, a strided sample run, a gate's rows) without
// copying them into an mma layout first:
//
//   la.one(mi, r, h, e), la.pair(mi, r, h, e): A at row 16 mi + g + 8 r of
//     the warp's rows and k = 8 h + e of the chunk (pair: e and e + 1, e
//     even); h is a compile-time 0 or 1, so a loader may keep the chunk's
//     two halves of 8 k's apart (two sample runs, two positions);
//   lb.one(ni, h, e), lb.pair(ni, h, e): B at k = 8 h + e, column 8 ni + g.
//
// Two routes, chosen by the stage's flag BF, and a third for one stage:
//
// - BF (matmul_dtype="bfloat16"): m16n8k16 on the tensor cores with bf16
//   operands and float32 accumulators. The operands are rounded to bf16
//   (round to nearest, ties to even: __floats2bfloat162_rn, as XLA's
//   convert) where the loader's float32 values are packed, and the
//   products, exact in float32, are summed in float32, as the TPU kernel's
//   dot with preferred_element_type=float32. The tensor cores align a sum
//   to its largest term and truncate, which over a long sum in one
//   accumulator drifts; so each chunk of 16 products goes to a zeroed
//   fragment, which is then added to the running sum with a rounded add.
// - float32: IEEE float32 FFMA on the CUDA cores over the same tiles and
//   loaders: the thread's own fragment (rows g, g + 8 of each m16 tile,
//   columns 2t, 2t + 1 of each n8 tile) as a register block, 2 MT + 2 NT
//   loads a k for 4 MT NT FMAs, each sum in k order. TF32 products on the
//   tensor cores (three: 3xTF32, or six of three pieces each) are off the
//   float32 twin by 1e-6 of an activation, the tensor cores' truncation,
//   and the JAX suite's float32 bounds on a phase's Adam moments do not
//   hold on the CNN learner's cases at that distance. Single-pass TF32 is
//   never used.
// - 3xTF32 (split_tf32, mma_tf32: m16n8k8, each float32 operand a TF32 high
//   part and a TF32 remainder, three products, float32 sums): the recurrent
//   acting kernel's cell stage only (K7, act_rnn.cu), which has no
//   optimizer moments to carry the distance; there each slice's products
//   go to a zeroed fragment and join the sum by a rounded add, which keeps
//   its rows within the float32 stage bound. It beat the FFMA route's cell
//   stage there (PERF.md §6).
//
// The tile GEMMs at the end: gemm_64x128 (C = A Bt^T, both operands with
// k contiguous: a forward product on W [out, in], or a dgrad on a
// transposed copy) and gemm_tn_128x128 (C = A^T B over a range of rows,
// both operands with k the slow index: a weight gradient), each with its
// k-slices staged by cp.async through a double-buffered ring.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Two floats as bf16x2: v.x in the low half (the lower k or row index).
__device__ __forceinline__ uint32_t pack_bf16(float2 v) {
  __nv_bfloat162 b = __floats2bfloat162_rn(v.x, v.y);
  return *reinterpret_cast<uint32_t*>(&b);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x's TF32 high part (round to nearest, ties away) and the TF32 of the
// remainder: the two operands of 3xTF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int MT, int NT>
__device__ __forceinline__ void zero_frags(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
}

// acc += A[rows, k0..k0+16) B[k0..k0+16, cols) for one chunk of 16 k's.
// A B loader's col(ni, dc, h, e) is B at k = 8 h + e and column 8 ni + g
// + dc: the float32 route reads columns 2t and 2t + 1 of each n8 tile.
template <bool BF, int MT, int NT, class LA, class LB>
__device__ __forceinline__ void mma_k16(float (&acc)[MT][NT][4], const LA& la,
                                        const LB& lb) {
  const int t = threadIdx.x & 3;
  if constexpr (BF) {
    uint32_t b[NT][2];
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      b[ni][0] = pack_bf16(lb.pair(ni, 0, 2 * t));
      b[ni][1] = pack_bf16(lb.pair(ni, 1, 2 * t));
    }
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const uint32_t a[4] = {pack_bf16(la.pair(mi, 0, 0, 2 * t)),
                             pack_bf16(la.pair(mi, 1, 0, 2 * t)),
                             pack_bf16(la.pair(mi, 0, 1, 2 * t)),
                             pack_bf16(la.pair(mi, 1, 1, 2 * t))};
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(c, a, b[ni]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], c[r]);
      }
    }
  } else {
    const int dc = 2 * t - ((threadIdx.x & 31) >> 2);  // column 2t from g
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float a[MT][2], b[NT][2];
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int r = 0; r < 2; ++r) a[mi][r] = la.one(mi, r, h, e);
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int c = 0; c < 2; ++c) b[ni][c] = lb.col(ni, dc + c, h, e);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni)
#pragma unroll
            for (int r = 0; r < 2; ++r)
#pragma unroll
              for (int c = 0; c < 2; ++c)
                acc[mi][ni][2 * r + c] =
                    fmaf(a[mi][r], b[ni][c], acc[mi][ni][2 * r + c]);
      }
  }
}

// mma_k16<true>'s chunk from operands already packed as bf16 pairs (a: the
// m16n8k16 A fragments, b: the B fragments, in the order mma_k16 packs
// them), with the same sums: a stage that keeps an operand packed in shared
// memory across many products skips the conversion.
template <int MT, int NT>
__device__ __forceinline__ void mma_packed(float (&acc)[MT][NT][4],
                                           const uint32_t (&a)[MT][4],
                                           const uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(c, a[mi], b[ni]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[mi][ni][r] = __fadd_rn(acc[mi][ni][r], c[r]);
    }
}

// ---- loaders ------------------------------------------------------------------

// A's rows in shared memory with k contiguous, LD floats apart; p is the
// lane's row g at the chunk's first k.
template <int LD>
struct RowLoader {
  const float* p;
  __device__ float one(int mi, int r, int h, int e) const {
    return p[(16 * mi + 8 * r) * LD + 8 * h + e];
  }
  __device__ float2 pair(int mi, int r, int h, int e) const {
    return *reinterpret_cast<const float2*>(p + (16 * mi + 8 * r) * LD +
                                            8 * h + e);
  }
};

// B's columns stored as rows of k, LD floats apart; p is the lane's column
// g at the chunk's first k.
template <int LD>
struct ColLoader {
  const float* p;
  __device__ float one(int ni, int h, int e) const {
    return p[8 * ni * LD + 8 * h + e];
  }
  __device__ float2 pair(int ni, int h, int e) const {
    return *reinterpret_cast<const float2*>(p + 8 * ni * LD + 8 * h + e);
  }
  __device__ float col(int ni, int dc, int h, int e) const {
    return p[(8 * ni + dc) * LD + 8 * h + e];
  }
};

// A[m][k] = s[k][m] (k the slow index, LD floats apart); p = s + the
// lane's row g at the chunk's first k.
template <int LD>
struct KRowLoader {
  const float* p;
  __device__ float one(int mi, int r, int h, int e) const {
    return p[(8 * h + e) * LD + 16 * mi + 8 * r];
  }
  __device__ float2 pair(int mi, int r, int h, int e) const {
    return make_float2(one(mi, r, h, e), one(mi, r, h, e + 1));
  }
};

// B[k][n] = s[k][n]; p = s + the lane's column g at the chunk's first k.
template <int LD>
struct KColLoader {
  const float* p;
  __device__ float one(int ni, int h, int e) const {
    return p[(8 * h + e) * LD + 8 * ni];
  }
  __device__ float2 pair(int ni, int h, int e) const {
    return make_float2(one(ni, h, e), one(ni, h, e + 1));
  }
  __device__ float col(int ni, int dc, int h, int e) const {
    return p[(8 * h + e) * LD + 8 * ni + dc];
  }
};

// MT m16 tiles whose lane rows (g, g + 8) are each a run of 16 contiguous
// k's at p[mi][r].
template <int MT>
struct RowsLoader {
  const float* p[MT][2];
  __device__ float one(int mi, int r, int h, int e) const {
    return p[mi][r][8 * h + e];
  }
  __device__ float2 pair(int mi, int r, int h, int e) const {
    return *reinterpret_cast<const float2*>(p[mi][r] + 8 * h + e);
  }
};

// MT m16 tiles whose lane rows take each half of the chunk from a run of
// 8 contiguous k's of its own, p[mi][r][h] (a tap's channels).
template <int MT>
struct TapRowsLoader {
  const float* p[MT][2][2];
  __device__ float one(int mi, int r, int h, int e) const {
    return p[mi][r][h][e];
  }
  __device__ float2 pair(int mi, int r, int h, int e) const {
    return *reinterpret_cast<const float2*>(p[mi][r][h] + e);
  }
};

// B's columns as rows of LD floats, each half of the chunk a run of 8
// from its own base p[h] (the lane's column g).
template <int LD>
struct TapColLoader {
  const float* p[2];
  __device__ float one(int ni, int h, int e) const {
    return p[h][8 * ni * LD + e];
  }
  __device__ float2 pair(int ni, int h, int e) const {
    return *reinterpret_cast<const float2*>(p[h] + 8 * ni * LD + e);
  }
  __device__ float col(int ni, int dc, int h, int e) const {
    return p[h][(8 * ni + dc) * LD + e];
  }
};

// The chunk's two halves of 8 k's each from a base of its own (null:
// zeros), element e at base[h] + e ks; A's row 16 mi + 8 r (B's column
// 8 ni) further on. The bases hold the lane's row (column) g.
struct HalfRowLoader {
  const float* base[2];
  int ks;
  __device__ float one(int mi, int r, int h, int e) const {
    return base[h] ? base[h][e * ks + 16 * mi + 8 * r] : 0.f;
  }
  __device__ float2 pair(int mi, int r, int h, int e) const {
    return make_float2(one(mi, r, h, e), one(mi, r, h, e + 1));
  }
};

struct HalfColLoader {
  const float* base[2];
  int ks;
  __device__ float one(int ni, int h, int e) const {
    return base[h] ? base[h][e * ks + 8 * ni] : 0.f;
  }
  __device__ float col(int ni, int dc, int h, int e) const {
    return base[h] ? base[h][e * ks + 8 * ni + dc] : 0.f;
  }
  __device__ float2 pair(int ni, int h, int e) const {
    return make_float2(one(ni, h, e), one(ni, h, e + 1));
  }
};

// A's rows in shared memory with k contiguous, ld floats apart (a runtime
// stride); p is the lane's row g at the chunk's first k.
struct RtRowLoader {
  const float* p;
  int ld;
  __device__ float one(int mi, int r, int h, int e) const {
    return p[(16 * mi + 8 * r) * ld + 8 * h + e];
  }
  __device__ float2 pair(int mi, int r, int h, int e) const {
    return *reinterpret_cast<const float2*>(p + (16 * mi + 8 * r) * ld +
                                            8 * h + e);
  }
};

// B's columns stored as rows of k, ld floats apart; column tile ni's
// rows start ns floats after tile ni - 1's (8 ld for contiguous tiles, a
// gate's stride for one tile a gate). p is the lane's column g at the
// chunk's first k; it may point to device memory (read through L1).
struct RtColLoader {
  const float* p;
  long ns;
  int ld;
  __device__ float one(int ni, int h, int e) const {
    return p[ni * ns + 8 * h + e];
  }
  __device__ float2 pair(int ni, int h, int e) const {
    return *reinterpret_cast<const float2*>(p + ni * ns + 8 * h + e);
  }
  __device__ float col(int ni, int dc, int h, int e) const {
    return p[ni * ns + (long)dc * ld + 8 * h + e];
  }
};

// ---- cp.async: 16-byte copies from device to shared memory -----------------

// Copies 16 bytes from src, or writes 16 zero bytes when !pred (src is then
// not read, but must be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

// Copies one float from src, or writes a zero when !pred.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- tile GEMMs ---------------------------------------------------------------

constexpr int GNT = 256;                   // threads of a tile GEMM: 8 warps
constexpr int BM = 64, BN = 128, BK = 32;  // gemm_64x128's tile, k-slice
constexpr int EJ = 128, EK = 128, EN = 32;  // gemm_tn_128x128's; rows a slice

// Row stride of gemm_64x128's ring slices: a warp's float32 reads (row g,
// k t) and bf16 float2 reads (row g, k 2t) then hit distinct banks.
template <bool BF>
__host__ __device__ constexpr int ldt() {
  return BK + (BF ? 8 : 4);
}
template <bool BF>
__host__ __device__ constexpr int lde() {
  return EJ + (BF ? 4 : 8);
}

// k-slice [k0, k0 + BK) of BM rows of A (rows >= a_rows as zeros) and of BN
// rows of Bt into one ring stage.
template <bool BF>
__device__ __forceinline__ void load_slice(float* As, float* Bs, const float* A,
                                           long lda, int a_rows,
                                           const float* Bt, long ldb, int k0) {
  constexpr int LD = ldt<BF>();
  for (int i = threadIdx.x; i < BM * BK / 4; i += GNT) {
    const int r = i / (BK / 4), c4 = i % (BK / 4) * 4;
    const bool ok = r < a_rows;
    cp_async16(As + r * LD + c4, ok ? A + r * lda + k0 + c4 : A, ok);
  }
  for (int i = threadIdx.x; i < BN * BK / 4; i += GNT) {
    const int r = i / (BK / 4), c4 = i % (BK / 4) * 4;
    cp_async16(Bs + r * LD + c4, Bt + r * ldb + k0 + c4, true);
  }
}

// acc += A[BM rows, K] Bt[BN rows, K]^T, the k-slices through a
// double-buffered ring; 8 warps as 2 x 4, each 32 x 32. K % BK == 0.
template <bool BF>
__device__ void gemm_64x128(float (&acc)[2][4][4], const float* A, long lda,
                            int a_rows, const float* Bt, long ldb, int K,
                            float* ring) {
  constexpr int LD = ldt<BF>();
  float* As[2] = {ring, ring + (BM + BN) * LD};
  float* Bs[2] = {ring + BM * LD, ring + (BM + BN) * LD + BM * LD};
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
  const int wm = warp >> 2, wn = warp & 3;
  const int nk = K / BK;
  load_slice<BF>(As[0], Bs[0], A, lda, a_rows, Bt, ldb, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load_slice<BF>(As[(kt + 1) & 1], Bs[(kt + 1) & 1], A, lda, a_rows, Bt,
                     ldb, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = As[kt & 1] + (wm * 32 + g) * LD;
    const float* bs = Bs[kt & 1] + (wn * 32 + g) * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16)
      mma_k16<BF>(acc, RowLoader<LD>{as + kk}, ColLoader<LD>{bs + kk});
    __syncthreads();
  }
}

// ---- float32 register blocks for whole tiles ----------------------------------
//
// The float32 route of gemm_64x128 and gemm_tn_128x128 through mma_k16's
// fragment layout reads each operand as scalars (12 or 16 shared loads for
// 32 or 64 FMAs a k). The two loops below compute the same tiles in the
// classic layout instead: a thread owns a strided block of rows and
// columns and reads them as float4, so a k costs 3 (NT) or 1 (TN) 16-byte
// loads per 32 or 64 FMAs. Each output still sums its k's in order with
// fmaf, so the bits are the fragment route's. The thread's outputs, as
// (row, column) of the tile, are tile_f32_nt / tile_f32_tn's.

// The float32 route of mma_k16 over K k's (a multiple of 4) for operands
// whose k's are contiguous: A's rows (the lane's row g at a, ld floats
// apart, 16-byte aligned) and B's columns (the lane's column 2t of tile 0
// at b, column 2t + 1 ldb floats further, tile ni bns floats from tile 0),
// read as float4 along k: per 4 k's 2 MT + 2 NT 16-byte loads for 16 MT NT
// FMAs, where mma_k16's loaders take 4 MT + 4 NT scalar loads a k. The
// fragment layout and each output's k order are mma_k16<false>'s, so the
// bits are too. For a B read through L1 (a recurrence's weights).
template <int MT, int NT>
__device__ __forceinline__ void ffma_k4(float (&acc)[MT][NT][4],
                                        const float* a, int lda,
                                        const float* b, long bns, int ldb,
                                        int K) {
  for (int k = 0; k < K; k += 4) {
    float4 av[MT][2], bv[NT][2];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        av[mi][r] = *reinterpret_cast<const float4*>(
            a + (16 * mi + 8 * r) * lda + k);
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        bv[ni][c] = *reinterpret_cast<const float4*>(b + ni * bns +
                                                     (long)c * ldb + k);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& o = acc[mi][ni][2 * r + c];
            o = fmaf(av[mi][r].x, bv[ni][c].x, o);
            o = fmaf(av[mi][r].y, bv[ni][c].y, o);
            o = fmaf(av[mi][r].z, bv[ni][c].z, o);
            o = fmaf(av[mi][r].w, bv[ni][c].w, o);
          }
  }
}

// gemm_64x128 on the float32 route: acc[i][j] at row tr + 16 i, column
// tc + 16 j (tr = tid / 16, tc = tid % 16).
__device__ void gemm_64x128_f32(float (&acc)[4][8], const float* A, long lda,
                                int a_rows, const float* Bt, long ldb, int K,
                                float* ring) {
  constexpr int LD = ldt<false>();
  float* As[2] = {ring, ring + (BM + BN) * LD};
  float* Bs[2] = {ring + BM * LD, ring + (BM + BN) * LD + BM * LD};
  const int tr = threadIdx.x / 16, tc = threadIdx.x % 16;
  const int nk = K / BK;
  load_slice<false>(As[0], Bs[0], A, lda, a_rows, Bt, ldb, 0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk)
      load_slice<false>(As[(kt + 1) & 1], Bs[(kt + 1) & 1], A, lda, a_rows,
                        Bt, ldb, (kt + 1) * BK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = As[kt & 1] + tr * LD;
    const float* bs = Bs[kt & 1] + tc * LD;
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(as + 16 * i * LD + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(bs + 16 * j * LD + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
        }
    }
    __syncthreads();
  }
}

// acc += A[q0:q1, :EJ]^T B[q0:q1, :EK] (k = the rows, in row order): A
// and B each from their first column on, a_cols and b_cols of them valid
// (zeros past them and past q1; both multiples of 4, the rows 16-byte
// aligned), the row slices through a double-buffered ring of 2 x 2 EN
// rows; 8 warps as 2 x 4, each 64 x 32. With bsum set, threads < EJ add
// their column of A over the rows into *bsum (a bias's sum, in row order).
template <bool BF>
__device__ void gemm_tn_128x128(float (&acc)[4][4][4], float* bsum,
                                const float* A, long lda, int a_cols,
                                const float* B, long ldb, int b_cols, long q0,
                                long q1, float* smem) {
  constexpr int LE = lde<BF>();
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2;
  const int wj = warp >> 2, wk = warp & 3;
  float* Ad[2] = {smem, smem + 2 * EN * LE};
  float* Bd[2] = {smem + EN * LE, smem + 3 * EN * LE};
  auto load = [&](int s, long qc) {
    for (int i = tid; i < EN * EJ / 4; i += GNT) {
      const int r = i / (EJ / 4), c4 = i % (EJ / 4) * 4;
      const long q = qc + r;
      const bool oka = q < q1 && c4 < a_cols, okb = q < q1 && c4 < b_cols;
      cp_async16(Ad[s] + r * LE + c4, oka ? A + q * lda + c4 : A, oka);
      cp_async16(Bd[s] + r * LE + c4, okb ? B + q * ldb + c4 : B, okb);
    }
  };
  const int nk = (int)((q1 - q0 + EN - 1) / EN);
  load(0, q0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, q0 + (long)(kt + 1) * EN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = Ad[kt & 1] + wj * 64 + g;
    const float* bs = Bd[kt & 1] + wk * 32 + g;
#pragma unroll
    for (int kk = 0; kk < EN; kk += 16)
      mma_k16<BF>(acc, KRowLoader<LE>{as + kk * LE},
                  KColLoader<LE>{bs + kk * LE});
    if (bsum && tid < EJ)
      for (int r = 0; r < EN; ++r) *bsum += Ad[kt & 1][r * LE + tid];
    __syncthreads();
  }
}

// gemm_tn_128x128 on the float32 route: acc[i][j] at row (of A's columns)
// 4 tj + i % 4 + 64 (i / 4), column 4 tk + j % 4 + 64 (j / 4) (tj = tid /
// 16, tk = tid % 16).
__device__ void gemm_tn_128x128_f32(float (&acc)[8][8], float* bsum,
                                    const float* A, long lda, int a_cols,
                                    const float* B, long ldb, int b_cols,
                                    long q0, long q1, float* smem) {
  constexpr int LE = lde<false>();
  const int tid = threadIdx.x, tj = tid / 16, tk = tid % 16;
  float* Ad[2] = {smem, smem + 2 * EN * LE};
  float* Bd[2] = {smem + EN * LE, smem + 3 * EN * LE};
  auto load = [&](int s, long qc) {
    for (int i = tid; i < EN * EJ / 4; i += GNT) {
      const int r = i / (EJ / 4), c4 = i % (EJ / 4) * 4;
      const long q = qc + r;
      const bool oka = q < q1 && c4 < a_cols, okb = q < q1 && c4 < b_cols;
      cp_async16(Ad[s] + r * LE + c4, oka ? A + q * lda + c4 : A, oka);
      cp_async16(Bd[s] + r * LE + c4, okb ? B + q * ldb + c4 : B, okb);
    }
  };
  const int nk = (int)((q1 - q0 + EN - 1) / EN);
  load(0, q0);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, q0 + (long)(kt + 1) * EN);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* as = Ad[kt & 1] + 4 * tj;
    const float* bs = Bd[kt & 1] + 4 * tk;
#pragma unroll 4
    for (int r = 0; r < EN; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + r * LE);
      const float4 a1 = *reinterpret_cast<const float4*>(as + r * LE + 64);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + r * LE);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + r * LE + 64);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (bsum && tid < EJ)
      for (int r = 0; r < EN; ++r) *bsum += Ad[kt & 1][r * LE + tid];
    __syncthreads();
  }
}

}  // namespace
