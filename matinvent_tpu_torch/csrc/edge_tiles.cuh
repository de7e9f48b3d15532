// Tensor-core tile machinery shared by the edge kernels (fused_edge.cu,
// edge_flat.cu), for NVIDIA Hopper (sm_90a).
//
// A block of kThreads = 256 threads (8 warps) computes the [kRows, H]
// product acc = A @ W of a kRows = 64-row tile with `mma.sync`; the warps
// tile the output as WARPS_M x WARPS_N (Geo<H>), each warp MI x NI
// fragments of 16 x 8. The accumulators are f32 in the mma C layout:
// lane (g = lane / 4, t = lane % 4) holds rows g and g + 8 of each 16-row
// fragment at columns 2t, 2t + 1 (for_each_acc walks them).
//
// Two routes, one per compute dtype:
//  * bf16 (Bf16Tiles): mma.m16n8k16 with bf16 operands. A (the tile, row
//    major) and W (row-major [K, H], i.e. k-major) both sit in shared memory
//    as bf16, read with ldmatrix (W with .trans). Rows are 16-byte chunks
//    XOR-swizzled by swz() so that the 8 rows of each ldmatrix phase, and
//    the fragment stores of the epilogues, hit 8 distinct 16-byte bank
//    groups. The weights are loaded once per (persistent) block and stay
//    resident.
//  * f32 (Tf32x3Tiles): 3xTF32, mma.m16n8k8 on a split a = a_hi + a_lo of
//    each operand (cvt.rna.tf32), summing a_lo b_hi + a_hi b_lo + a_hi b_hi
//    in f32: the product keeps about f32 accuracy (the dropped a_lo b_lo is
//    2^-22 relative). A sits in shared memory as f32 with a padded row
//    stride; W (320 KB at H = 256, too large to stay resident) streams from
//    L2 through a 4-stage cp.async ring of kKt-row tiles. Fragments are read
//    with 32-bit loads from padded rows, conflict-free.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace edge_tiles {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;      // edge rows of one tile
constexpr int kMaxLanes = 64;  // widest embedding; stored width of its tile

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

// Two consecutive values at p (aligned to 2 elements) of read-only device
// memory, as f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(__ldg(reinterpret_cast<const __nv_bfloat162*>(p)));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// silu in f32 from the special-function unit (exp2 and reciprocal
// approximations, a few ulp) in place of expf and an IEEE division, which
// made the elementwise epilogues the kernels' largest cost. For x < -87 the
// denominator overflows and the result is -0 (silu(x) is below 1e-36 there).
__device__ __forceinline__ float silu(float x) {
  return __fdividef(x, 1.0f + __expf(-x));
}

// sin (or cos) of a phase from the special-function unit after a
// two-constant reduction to [-pi, pi]: absolute error about 4e-7 for the
// edge embedding's phases (|ph| < 2 pi * 64), against sinf's slow path.
__device__ __forceinline__ float sin_or_cos(float ph, bool sine) {
  const float k = rintf(ph * 0.159154943f);          // turns
  const float r = fmaf(k, 1.74845553e-7f, fmaf(k, -6.28318548f, ph));
  return sine ? __sinf(r) : __cosf(r);
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

// Warp tiling of a [kRows, H] output: WARPS_M x WARPS_N warps, each
// MI x NI fragments of 16 x 8 (NI even: ldmatrix.x4.trans loads two).
template <int H>
struct Geo {
  static constexpr int WARPS_N = H / 16 < 4 ? H / 16 : 4;
  static constexpr int WARPS_M = kWarps / WARPS_N;
  static constexpr int MI = kRows / (16 * WARPS_M);
  static constexpr int NI = H / (8 * WARPS_N);
  static_assert(WARPS_M * WARPS_N == kWarps && MI * 16 * WARPS_M == kRows &&
                    NI * 8 * WARPS_N == H && NI % 2 == 0,
                "unsupported width");
};

template <int H>
using Acc = float[Geo<H>::MI][Geo<H>::NI][4];

// Calls f(row, col, v0, v1) for each pair of accumulators of this thread
// (columns col and col + 1 of row `row`).
template <int H, typename F>
__device__ __forceinline__ void for_each_acc(Acc<H>& acc, int warp, int lane,
                                             F&& f) {
  using G = Geo<H>;
  const int r0 = (warp / G::WARPS_N) * G::MI * 16 + lane / 4;
  const int c0 = (warp % G::WARPS_N) * G::NI * 8 + 2 * (lane % 4);
#pragma unroll
  for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < G::NI; ++ni) {
      f(r0 + mi * 16, c0 + ni * 8, acc[mi][ni][0], acc[mi][ni][1]);
      f(r0 + mi * 16 + 8, c0 + ni * 8, acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

template <int H>
__device__ __forceinline__ void zero_acc(Acc<H>& acc) {
#pragma unroll
  for (int mi = 0; mi < Geo<H>::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < Geo<H>::NI; ++ni) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;
    }
  }
}

// The epilogue that reduces over rows stages the f32 results of kSumRows
// rows at a time, [kSumRows][H + 8] (the padding spreads a fragment store's
// 8 rows over the banks); each thread then sums one column down the rows.
constexpr int kSumRows = 32;
template <int H>
constexpr size_t kSumBytes = size_t(kSumRows) * (H + 8) * 4;

// Prefetches the bytes [p, p + bytes) into L1 (or only L2), a 128-byte
// line per thread.
template <bool kL1>
__device__ __forceinline__ void prefetch(const void* p, size_t bytes,
                                         int tid) {
  const char* c = static_cast<const char*>(p);
  for (size_t off = size_t(tid) * 128; off < bytes;
       off += size_t(kThreads) * 128) {
    if constexpr (kL1) {
      asm volatile("prefetch.global.L1 [%0];\n" ::"l"(c + off));
    } else {
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(c + off));
    }
  }
}

// Lanes [l0, l0 + 8) of an embedding row of `lanes` values, as f32; lanes
// past `lanes` read as 0. One 16-byte load where the row allows it.
template <typename T>
__device__ __forceinline__ void load_lanes8(const T* row, int l0, int lanes,
                                            float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    if (lanes % 8 == 0 && l0 + 8 <= lanes) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + l0));
      const T* h = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = to_float(h[k]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = l0 + k < lanes ? to_float(__ldg(row + l0 + k)) : 0.0f;
  }
}

// ------------------------------------------------------------------ bf16

// Element offset of 16-byte chunk `chunk` of row `row` in a bf16 matrix of
// CH chunks (8 elements each) per row, XOR-swizzled: any 8 consecutive rows
// (from a multiple of 8) at one chunk index land in 8 distinct 16-byte bank
// groups of the 128-byte bank line.
template <int CH>
__device__ __forceinline__ int swz(int row, int chunk) {
  static_assert(CH == 4 || CH % 8 == 0, "row must be 64 bytes or 128k bytes");
  if constexpr (CH == 4) {
    return row * 32 + ((chunk ^ ((row >> 1) & 3)) << 3);
  } else {
    return row * (CH * 8) + ((chunk ^ (row & 7)) << 3);
  }
}

// Element offset of (row, col) in such a matrix.
template <int CH>
__device__ __forceinline__ int swz_at(int row, int col) {
  return swz<CH>(row, col >> 3) + (col & 7);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copies rows [0, rows) of the row-major [kvalid, H] bf16 matrix W into the
// swizzled sW (H / 8 chunks per row); rows at or past kvalid become 0.
// Asynchronous: the caller commits, waits and synchronises.
template <int H>
__device__ __forceinline__ void load_resident(__nv_bfloat16* sW,
                                              const __nv_bfloat16* W,
                                              int rows, int kvalid, int tid) {
  constexpr int CH = H / 8;
  for (int idx = tid; idx < rows * CH; idx += kThreads) {
    const int k = idx / CH;
    const int c = idx % CH;
    const bool ok = k < kvalid;
    const __nv_bfloat16* src = ok ? W + static_cast<size_t>(k) * H + c * 8 : W;
    cp_async16(sW + swz<CH>(k, c), src, ok ? 16 : 0);
  }
}

// acc = sA[:, :16 ksteps] @ sB[:16 ksteps, :], both swizzled bf16 in shared
// memory: sA [kRows][CHA * 8], sB [16 ksteps][H].
template <int H, int CHA>
__device__ __forceinline__ void gemm_bf16(const __nv_bfloat16* sA,
                                          const __nv_bfloat16* sB, int ksteps,
                                          Acc<H>& acc, int warp, int lane) {
  using G = Geo<H>;
  constexpr int CHB = H / 8;
  const int arow = (warp / G::WARPS_N) * G::MI * 16 + (lane & 15);
  const int bcol = (warp % G::WARPS_N) * G::NI + (lane >> 4);  // chunk
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
  zero_acc<H>(acc);
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    unsigned a[G::MI][4];
#pragma unroll
    for (int mi = 0; mi < G::MI; ++mi) {
      ldmatrix_x4(a[mi], sA + swz<CHA>(arow + mi * 16, ks * 2 + (lane >> 4)));
    }
#pragma unroll
    for (int nj = 0; nj < G::NI / 2; ++nj) {
      unsigned b[4];
      ldmatrix_x4_trans(b, sB + swz<CHB>(ks * 16 + brow, bcol + nj * 2));
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// Shared-memory layout of the bf16 route: both weights resident, then the
// embedding tile and the e tile, which together hold the f32 j-sum staging
// rows once the second product has read e.
template <int H>
struct Bf16Tiles {
  using T = __nv_bfloat16;
  static constexpr size_t kWdBytes = size_t(kMaxLanes) * H * 2;
  static constexpr size_t kW1Bytes = size_t(H) * H * 2;
  static constexpr size_t kEmbBytes = size_t(kRows) * kMaxLanes * 2;
  static constexpr size_t kEBytes = size_t(kRows) * H * 2;
  static_assert(kSumBytes<H> <= kEmbBytes + kEBytes, "j-sum staging");
  static constexpr size_t kBytes = kWdBytes + kW1Bytes + kEmbBytes + kEBytes;

  T* wd;
  T* w1;
  T* emb;
  T* e;
  float* sums;  // [kSumRows][H + 8] f32 over emb and e

  __device__ explicit Bf16Tiles(unsigned char* smem)
      : wd(reinterpret_cast<T*>(smem)),
        w1(reinterpret_cast<T*>(smem + kWdBytes)),
        emb(reinterpret_cast<T*>(smem + kWdBytes + kW1Bytes)),
        e(reinterpret_cast<T*>(smem + kWdBytes + kW1Bytes + kEmbBytes)),
        sums(reinterpret_cast<float*>(emb)) {}

  // Loads both weights (once per block); ends on a barrier.
  __device__ void prepare(const T* Wd, const T* W1, int Kd, int lanes,
                          int tid) {
    load_resident<H>(wd, Wd, Kd, lanes, tid);
    load_resident<H>(w1, W1, H, H, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  // Embedding tile element (r, l), l < kMaxLanes; 8 at a time.
  __device__ void store_emb8(int r, int chunk, const float (&v)[8]) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    }
    *reinterpret_cast<uint4*>(emb + swz<kMaxLanes / 8>(r, chunk)) = u;
  }
  __device__ void store_e(int r, int c, float v0, float v1) {
    store2(e + swz_at<H / 8>(r, c), v0, v1);
  }
  __device__ void gemm1(int Kd, Acc<H>& acc, int warp, int lane, int) {
    gemm_bf16<H, kMaxLanes / 8>(emb, wd, Kd / 16, acc, warp, lane);
  }
  __device__ void gemm2(Acc<H>& acc, int warp, int lane, int) {
    gemm_bf16<H, H / 8>(e, w1, H / 16, acc, warp, lane);
  }
};

// ------------------------------------------------------------- f32 3xTF32

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi and lo TF32 values (lo carries the next bits of x).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int kKt = 16;     // k-rows of one streamed weight tile
constexpr int kStages = 4;  // depth of the cp.async ring

// Rows [k0, k0 + kKt) of the row-major [kvalid, H] f32 matrix W into dst
// (row stride H + 8); rows at or past kvalid are zero-filled.
template <int H>
__device__ __forceinline__ void load_stage(float* dst, const float* W, int k0,
                                           int kvalid, int tid) {
  constexpr int CH = H / 4;  // 16-byte chunks per row
  for (int idx = tid; idx < kKt * CH; idx += kThreads) {
    const int row = idx / CH;
    const int c = idx % CH;
    const bool ok = k0 + row < kvalid;
    const float* src = ok ? W + static_cast<size_t>(k0 + row) * H + c * 4 : W;
    cp_async16(dst + row * (H + 8) + c * 4, src, ok ? 16 : 0);
  }
}

// acc = sA[:, :K] @ W[:K, :] in 3xTF32, sA f32 [kRows][lda] in shared
// memory, W row-major [kvalid, H] in device memory (rows past kvalid read
// as 0) streamed through `ring`; K is a multiple of kKt. Ends on a barrier,
// so the caller may overwrite sA and the ring afterwards.
template <int H>
__device__ __forceinline__ void gemm_tf32x3(const float* sA, int lda,
                                            const float* W, int K, int kvalid,
                                            float* ring, Acc<H>& acc, int warp,
                                            int lane, int tid) {
  using G = Geo<H>;
  constexpr int kLdb = H + 8;
  constexpr int kStage = kKt * kLdb;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int arow = (warp / G::WARPS_N) * G::MI * 16 + g;
  const int bcol = (warp % G::WARPS_N) * G::NI * 8 + g;
  zero_acc<H>(acc);
  const int ntiles = K / kKt;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load_stage<H>(ring + s * kStage, W, s * kKt, kvalid, tid);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    {
      const int nxt = kt + kStages - 1;
      if (nxt < ntiles) {
        load_stage<H>(ring + (nxt % kStages) * kStage, W, nxt * kKt, kvalid,
                      tid);
      }
      cp_async_commit();
    }
    const float* sB = ring + (kt % kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < kKt; kk += 8) {
      const int ka = kt * kKt + kk;
      unsigned ahi[G::MI][4], alo[G::MI][4];
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        const float* p = sA + (arow + mi * 16) * lda + ka + t;
        split_tf32(p[0], ahi[mi][0], alo[mi][0]);
        split_tf32(p[8 * lda], ahi[mi][1], alo[mi][1]);
        split_tf32(p[4], ahi[mi][2], alo[mi][2]);
        split_tf32(p[8 * lda + 4], ahi[mi][3], alo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const float* q = sB + (kk + t) * kLdb + bcol + ni * 8;
        unsigned bhi0, blo0, bhi1, blo1;
        split_tf32(q[0], bhi0, blo0);
        split_tf32(q[4 * kLdb], bhi1, blo1);
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
          mma_tf32(acc[mi][ni], alo[mi], bhi0, bhi1);
          mma_tf32(acc[mi][ni], ahi[mi], blo0, blo1);
          mma_tf32(acc[mi][ni], ahi[mi], bhi0, bhi1);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Shared-memory layout of the f32 route: the embedding tile and the e tile
// (which together hold the f32 j-sum staging rows once the second product
// has read e), then the weight ring.
template <int H>
struct Tf32x3Tiles {
  using T = float;
  static constexpr int kLdEmb = kMaxLanes + 4;
  static constexpr int kLdE = H + 4;
  static constexpr size_t kEmbBytes = size_t(kRows) * kLdEmb * 4;
  static constexpr size_t kEBytes = size_t(kRows) * kLdE * 4;
  static constexpr size_t kRingBytes = size_t(kStages) * kKt * (H + 8) * 4;
  static_assert(kSumBytes<H> <= kEmbBytes + kEBytes, "j-sum staging");
  static constexpr size_t kBytes = kEmbBytes + kEBytes + kRingBytes;

  float* emb;
  float* e;
  float* ring;
  float* sums;  // [kSumRows][H + 8] f32 over emb and e
  const float* Wd;
  const float* W1;
  int lanes;

  __device__ explicit Tf32x3Tiles(unsigned char* smem)
      : emb(reinterpret_cast<float*>(smem)),
        e(reinterpret_cast<float*>(smem + kEmbBytes)),
        ring(reinterpret_cast<float*>(smem + kEmbBytes + kEBytes)),
        sums(reinterpret_cast<float*>(smem)) {}

  __device__ void prepare(const float* wd, const float* w1, int, int l, int) {
    Wd = wd;
    W1 = w1;
    lanes = l;
  }
  __device__ void store_emb8(int r, int chunk, const float (&v)[8]) {
    float* p = emb + r * kLdEmb + chunk * 8;
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ void store_e(int r, int c, float v0, float v1) {
    store2(e + r * kLdE + c, v0, v1);
  }
  __device__ void gemm1(int Kd, Acc<H>& acc, int warp, int lane, int tid) {
    gemm_tf32x3<H>(emb, kLdEmb, Wd, Kd, lanes, ring, acc, warp, lane, tid);
  }
  __device__ void gemm2(Acc<H>& acc, int warp, int lane, int tid) {
    gemm_tf32x3<H>(e, kLdE, W1, H, H, ring, acc, warp, lane, tid);
  }
};

// The route of compute dtype T.
template <typename T, int H>
struct TilesOf;
template <int H>
struct TilesOf<float, H> {
  using type = Tf32x3Tiles<H>;
};
template <int H>
struct TilesOf<__nv_bfloat16, H> {
  using type = Bf16Tiles<H>;
};

// Blocks of `kernel` that fit on the card at once (SMs times resident
// blocks per SM), the size of a persistent grid; 0 if the card cannot say.
template <typename K>
inline int resident_blocks(K kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    smem) != cudaSuccess) {
    return 0;
  }
  return sms * per_sm;
}

}  // namespace edge_tiles
