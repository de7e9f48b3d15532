// Tile machinery shared by the edge kernels (fused_edge.cu, edge_flat.cu).
//
// A block of kThreads threads computes a [kRows, H] product acc = A @ W for
// kRows = 64 rows. The A operand lives in shared memory as f32, k-major
// (aT[k * kLda + r]), so a warp reads its rows as one broadcast; W is a
// row-major [K, H] matrix in device memory (in practice L2) that streams
// through shared memory in kKt-row tiles, double-buffered with cp.async.
// Thread (tx, ty) accumulates rows ty*RM .. ty*RM+RM-1 (RM = H / 32) and the
// columns tx*4..tx*4+3 and H/2+tx*4..H/2+tx*4+3 in an RM x 8 register tile,
// with FP32 FMAs (no tensor cores).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace edge_tiles {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // rows of the A operand per block
constexpr int kLda = kRows + 4;      // k-major stride of the A operand
constexpr int kMaxLanes = 64;        // widest embedding, rounded up to kKt
constexpr int kKt = 16;              // k-rows of one streamed weight tile

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and back: the operand rounding of a product in T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Four consecutive values at p (aligned to their vector width), rounded to T.
__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b,
                                       float c, float d) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(a, b);
  q[1] = __floats2bfloat162_rn(c, d);
}

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// RM consecutive floats at p (aligned to their vector width).
template <int RM>
__device__ __forceinline__ void load_rows(const float* p, float (&a)[RM]) {
  if constexpr (RM % 4 == 0) {
#pragma unroll
    for (int m = 0; m < RM; m += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + m);
      a[m] = v.x;
      a[m + 1] = v.y;
      a[m + 2] = v.z;
      a[m + 3] = v.w;
    }
  } else if constexpr (RM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x;
    a[1] = v.y;
  } else {
    a[0] = p[0];
  }
}

template <int RM>
__device__ __forceinline__ void store_rows(float* p, const float (&a)[RM]) {
  if constexpr (RM % 4 == 0) {
#pragma unroll
    for (int m = 0; m < RM; m += 4) {
      *reinterpret_cast<float4*>(p + m) =
          make_float4(a[m], a[m + 1], a[m + 2], a[m + 3]);
    }
  } else if constexpr (RM == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  } else {
    p[0] = a[0];
  }
}

// Stores the RM x 8 register tile v k-major into aT (aT[c * kLda + r]), so
// that it becomes the A operand of the next product.
template <int H>
__device__ __forceinline__ void store_tile_kmajor(float* aT,
                                                  const float (&v)[H / 32][8],
                                                  int tid) {
  constexpr int RM = H / 32;
  constexpr int TX = H / 8;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float col[RM];
#pragma unroll
    for (int m = 0; m < RM; ++m) col[m] = v[m][n];
    const int c = n < 4 ? tx * 4 + n : H / 2 + tx * 4 + (n - 4);
    store_rows<RM>(aT + c * kLda + ty * RM, col);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [k0, k0 + kKt) of the row-major [kvalid, H] weight W into dst;
// rows at or past kvalid are zero-filled.
template <typename T, int H>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ W,
                                          int k0, int kvalid, int tid) {
  constexpr int kRowBytes = H * static_cast<int>(sizeof(T));
  constexpr int kChunksPerRow = kRowBytes / 16;
  constexpr int kChunks = kKt * kChunksPerRow;
  const char* base = reinterpret_cast<const char*>(W);
  char* out = reinterpret_cast<char*>(dst);
  for (int idx = tid; idx < kChunks; idx += kThreads) {
    const int row = idx / kChunksPerRow;
    const int cb = (idx % kChunksPerRow) * 16;
    const bool ok = (k0 + row) < kvalid;
    const char* src =
        ok ? base + static_cast<size_t>(k0 + row) * kRowBytes + cb : base;
    cp_async16(out + row * kRowBytes + cb, src, ok ? 16 : 0);
  }
}

// acc[m][n] = sum_k aT[k][ty*RM + m] * W[k][col(n)] over k < K (a multiple
// of kKt); W rows at or past kvalid read as 0. Ends on a barrier, so the
// caller may overwrite aT afterwards.
template <typename T, int H>
__device__ __forceinline__ void gemm_block(const float* aT,
                                           const T* __restrict__ W, int K,
                                           int kvalid, T* btile,
                                           float (&acc)[H / 32][8], int tid) {
  constexpr int RM = H / 32;
  constexpr int TX = H / 8;
  const int tx = tid % TX;
  const int ty = tid / TX;
#pragma unroll
  for (int m = 0; m < RM; ++m) {
#pragma unroll
    for (int n = 0; n < 8; ++n) acc[m][n] = 0.0f;
  }
  const int ntiles = K / kKt;
  load_tile<T, H>(btile, W, 0, kvalid, tid);
  cp_async_commit();
  for (int t = 0; t < ntiles; ++t) {
    const T* cur = btile + (t & 1) * kKt * H;
    if (t + 1 < ntiles) {
      load_tile<T, H>(btile + ((t + 1) & 1) * kKt * H, W, (t + 1) * kKt,
                      kvalid, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kKt; ++kk) {
      float a[RM];
      load_rows<RM>(aT + (t * kKt + kk) * kLda + ty * RM, a);
      const T* brow = cur + kk * H;
      const float4 b0 = load4(brow + tx * 4);
      const float4 b1 = load4(brow + H / 2 + tx * 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < RM; ++m) {
#pragma unroll
        for (int n = 0; n < 8; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
      }
    }
    // every thread is done with `cur` before the next tile overwrites it
    __syncthreads();
  }
}

// Bytes of the double-buffered weight tiles.
template <typename T, int H>
__host__ __device__ constexpr size_t tile_bytes() {
  return size_t(2) * kKt * H * sizeof(T);
}

}  // namespace edge_tiles
