// Fused fc edge branch of one CSPLayer, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel matinvent_tpu/ops/fused_edge.py:73 `_kernel`
// (launched by `fused_edge_chain`, :119). For a batch of crystals it computes
//
//     fd    = (x_j - x_i) mod 1                             [B, A, A, 3]
//     emb   = concat(sin(2 pi m fd), cos(2 pi m fd))        6*nf lanes
//     e     = silu(emb @ w_d + term_i[i] + term_j[j])
//     s     = silu(e @ w_1 + b_1)
//     out_i = u_i * sum_j s_ij * u_j                        [B, A, H]
//
// with f32 accumulation and the compute dtype T (float or bf16) for the
// node terms, the weights and the output. The phases, the elementwise chain
// and the j-sum stay in f32; emb and e are rounded to T before their
// products, as the Pallas kernel casts them for the MXU.
//
// What bounds it: at the sampler's shapes (H = 256, caps A <= 20) each
// crystal's A*A edge rows cost 2*(64*H + H*H) flops against 3*A*H elements of
// node terms and output, so the work is far above the card's ridge point and
// the kernel is bound by arithmetic: the FP32 FMA rate here, since no tensor
// cores are used yet. The design keeps every [A*A, H] intermediate out of
// device memory:
//  * one block of 256 threads owns one crystal and a run of whole rows i
//    (floor(64 / A) of them, i.e. at most 64 edge rows), so the j-reduction
//    never crosses blocks and needs no atomics;
//  * the Fourier embedding and e live in shared memory, stored k-major so a
//    warp reads its rows as one broadcast;
//  * w_d and w_1 stream from L2 in 16-row tiles, double-buffered with
//    cp.async, and each thread accumulates an (H/32) x 8 register tile;
//  * 2 blocks fit on one SM (about 100 KB of shared memory each).
// The padded rows of a crystal (u_i = 0) come out as exactly 0.
//
// The launch function has a plain C interface (raw pointers, the stream),
// returns cudaGetLastError(), and is bound from Python with ctypes
// (matinvent_tpu_torch/ops/fused_edge.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;            // edge rows (i, j) per block
constexpr int kLda = kRows + 4;      // k-major stride of the A operand
constexpr int kMaxLanes = 64;        // 6 * num_freqs rounded up to kKt
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
// of kKt); W rows at or past kvalid read as 0. Thread (tx, ty) owns rows
// ty*RM .. ty*RM+RM-1 and columns tx*4..tx*4+3 and H/2+tx*4..H/2+tx*4+3.
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

template <typename T, int H>
__host__ __device__ constexpr size_t operand_bytes() {
  // max of the embedding [kMaxLanes][kLda], e [H][kLda] and the
  // reduction buffer [kRows][H + 4], all f32
  constexpr size_t emb = size_t(kMaxLanes) * kLda * 4;
  constexpr size_t e = size_t(H) * kLda * 4;
  constexpr size_t red = size_t(kRows) * (H + 4) * 4;
  constexpr size_t m = emb > e ? emb : e;
  return m > red ? m : red;
}

template <typename T, int H>
__host__ __device__ constexpr size_t smem_bytes() {
  return operand_bytes<T, H>() + size_t(2) * kKt * H * sizeof(T);
}

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 2)
    fused_edge_kernel(const T* __restrict__ ti, const T* __restrict__ tj,
                      const float* __restrict__ fr,
                      const float* __restrict__ ui,
                      const float* __restrict__ uj, const T* __restrict__ wd,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      T* __restrict__ out, int A, int num_freqs, int rows_i,
                      int n_chunks) {
  constexpr int RM = H / 32;
  constexpr int TX = H / 8;
  constexpr int kLdr = H + 4;  // row stride of the reduction buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // one f32 region, used in turn as the embedding, as e and as s * u_j
  float* opnd = reinterpret_cast<float*>(smem_raw);
  T* btile = reinterpret_cast<T*>(smem_raw + operand_bytes<T, H>());
  __shared__ float frs[kRows][3];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.x / n_chunks;
  const int i0 = (blockIdx.x % n_chunks) * rows_i;
  const int n_i = min(rows_i, A - i0);
  const int rows = n_i * A;  // live edge rows of this block
  const int D = 6 * num_freqs;
  const int Kd = ((D + kKt - 1) / kKt) * kKt;

  for (int idx = tid; idx < A * 3; idx += kThreads) {
    frs[idx / 3][idx % 3] = fr[static_cast<size_t>(b) * A * 3 + idx];
  }
  __syncthreads();

  // Fourier embedding, k-major: opnd[l * kLda + r]. Lane l < 3nf is
  // sin(2 pi m fd_s) with (s, m) = divmod(l, nf); the next 3nf lanes are
  // the cosines; lanes past 6nf are 0 (their weight rows are zero-filled).
  for (int idx = tid; idx < Kd * kRows; idx += kThreads) {
    const int l = idx / kRows;
    const int r = idx % kRows;
    float v = 0.0f;
    if (r < rows && l < D) {
      const int i = i0 + r / A;
      const int j = r % A;
      const int rem = l % (3 * num_freqs);
      const int s = rem / num_freqs;
      const int m = rem % num_freqs;
      float fd = frs[j][s] - frs[i][s];
      fd = fd - floorf(fd);
      const float ph = fd * static_cast<float>(6.283185307179586 * m);
      v = l < 3 * num_freqs ? sinf(ph) : cosf(ph);
    }
    opnd[l * kLda + r] = round_to<T>(v);
  }
  __syncthreads();

  float acc[RM][8];
  gemm_block<T, H>(opnd, wd, Kd, D, btile, acc, tid);

  // e = silu(emb @ w_d + term_i + term_j), stored k-major over columns
  const int c0 = tx * 4;
  const int c1 = H / 2 + tx * 4;
  float e[RM][8];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = ty * RM + m;
    if (r < rows) {
      const int i = i0 + r / A;
      const int j = r % A;
      const T* tip = ti + (static_cast<size_t>(b) * A + i) * H;
      const T* tjp = tj + (static_cast<size_t>(b) * A + j) * H;
      const float4 p0 = load4(tip + c0);
      const float4 p1 = load4(tip + c1);
      const float4 q0 = load4(tjp + c0);
      const float4 q1 = load4(tjp + c1);
      const float pi_[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
      const float qj[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        e[m][n] = round_to<T>(silu(acc[m][n] + pi_[n] + qj[n]));
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) e[m][n] = 0.0f;
    }
  }
  // gemm_block ended on a barrier, so the embedding is no longer read
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float col[RM];
#pragma unroll
    for (int m = 0; m < RM; ++m) col[m] = e[m][n];
    const int c = n < 4 ? c0 + n : c1 + (n - 4);
    store_rows<RM>(opnd + c * kLda + ty * RM, col);
  }
  __syncthreads();

  gemm_block<T, H>(opnd, w1, H, H, btile, acc, tid);

  // s * u_j, row-major [r][c] for the reduction over j
  float bias[8];
  {
    const float4 v0 = load4(b1 + c0);
    const float4 v1 = load4(b1 + c1);
    bias[0] = v0.x; bias[1] = v0.y; bias[2] = v0.z; bias[3] = v0.w;
    bias[4] = v1.x; bias[5] = v1.y; bias[6] = v1.z; bias[7] = v1.w;
  }
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = ty * RM + m;
    if (r < rows) {
      const float w = uj[static_cast<size_t>(b) * A + (r % A)];
      float s[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n] = silu(acc[m][n] + bias[n]) * w;
      *reinterpret_cast<float4*>(opnd + r * kLdr + c0) =
          make_float4(s[0], s[1], s[2], s[3]);
      *reinterpret_cast<float4*>(opnd + r * kLdr + c1) =
          make_float4(s[4], s[5], s[6], s[7]);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < n_i * H; idx += kThreads) {
    const int il = idx / H;
    const int c = idx % H;
    const float* p = opnd + (il * A) * kLdr + c;
    float sum = 0.0f;
    for (int j = 0; j < A; ++j) sum += p[j * kLdr];
    const size_t row = static_cast<size_t>(b) * A + i0 + il;
    out[row * H + c] = from_float<T>(sum * ui[row]);
  }
}

template <typename T, int H>
cudaError_t launch_typed(const void* ti, const void* tj, const void* fr,
                         const void* ui, const void* uj, const void* wd,
                         const void* w1, const void* b1, void* out, int B,
                         int A, int num_freqs, cudaStream_t stream) {
  const int rows_i = kRows / A;
  const int n_chunks = (A + rows_i - 1) / rows_i;
  constexpr size_t smem = smem_bytes<T, H>();
  cudaError_t err = cudaFuncSetAttribute(
      fused_edge_kernel<T, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  fused_edge_kernel<T, H><<<B * n_chunks, kThreads, smem, stream>>>(
      static_cast<const T*>(ti), static_cast<const T*>(tj),
      static_cast<const float*>(fr), static_cast<const float*>(ui),
      static_cast<const float*>(uj), static_cast<const T*>(wd),
      static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<T*>(out), A, num_freqs, rows_i, n_chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_h(const void* ti, const void* tj, const void* fr,
                     const void* ui, const void* uj, const void* wd,
                     const void* w1, const void* b1, void* out, int B, int A,
                     int H, int num_freqs, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch_typed<T, 32>(ti, tj, fr, ui, uj, wd, w1, b1, out, B, A,
                                 num_freqs, stream);
    case 64:
      return launch_typed<T, 64>(ti, tj, fr, ui, uj, wd, w1, b1, out, B, A,
                                 num_freqs, stream);
    case 128:
      return launch_typed<T, 128>(ti, tj, fr, ui, uj, wd, w1, b1, out, B, A,
                                  num_freqs, stream);
    case 256:
      return launch_typed<T, 256>(ti, tj, fr, ui, uj, wd, w1, b1, out, B, A,
                                  num_freqs, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. term_i/term_j/out [B, A, H], frac
// [B, A, 3] f32, ui/uj [B, A] f32, wd [6*num_freqs, H], w1 [H, H] (in, out),
// b1 [H]; all contiguous and 16-byte aligned. Returns a cudaError_t.
extern "C" int fused_edge_chain_launch(const void* ti, const void* tj,
                                       const void* fr, const void* ui,
                                       const void* uj, const void* wd,
                                       const void* w1, const void* b1,
                                       void* out, int B, int A, int H,
                                       int num_freqs, int dtype,
                                       void* stream) {
  if (B <= 0 || A <= 0 || A > kRows || num_freqs <= 0 ||
      6 * num_freqs > kMaxLanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_h<float>(ti, tj, fr, ui, uj, wd, w1, b1, out, B, A, H,
                          num_freqs, s);
  } else if (dtype == 1) {
    err = launch_h<__nv_bfloat16>(ti, tj, fr, ui, uj, wd, w1, b1, out, B, A,
                                  H, num_freqs, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
