// Warp-level tensor-core products for the CNN learner (K11/K12,
// sgd_cnn.cu): mma.sync on tiles that a stage keeps in shared memory.
//
// A warp computes acc[MT][NT] (MT tiles of 16 rows by NT tiles of 8
// columns, each the m16n8 accumulator fragment: c0, c1 at row g, columns
// 2t and 2t + 1; c2, c3 at row g + 8; g = lane / 4, t = lane % 4) and adds
// the product of one chunk of 16 k's to it. The operands are read through
// loaders, so that a stage can gather them (an implicit convolution, a
// position's shifted row, a strided sample run) without copying them into
// an mma layout first:
//
//   la.one(mi, r, h, e), la.pair(mi, r, h, e): A at row 16 mi + g + 8 r of
//     the warp's rows and k = 8 h + e of the chunk (pair: e and e + 1, e
//     even); h is a compile-time 0 or 1, so a loader may keep the chunk's
//     two halves of 8 k's apart (two sample runs, two positions);
//   lb.one(ni, h, e), lb.pair(ni, h, e): B at k = 8 h + e, column 8 ni + g.
//
// Two routes, chosen by the stage's flag BF:
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
//   hold on the card's CNN cases at that distance. Single-pass TF32 is
//   never used.
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

}  // namespace
