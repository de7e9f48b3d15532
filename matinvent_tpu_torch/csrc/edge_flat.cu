// Flat edge MLP over row-flattened edges, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel experiments/fused_edge_flat_r5.py:41
// `_flat_kernel` (launched by `make_flat`, :52). For R edge rows it computes
//
//     e   = silu(emb @ w_d + ts)          emb [R, lanes], ts [R, H]
//     out = silu(e @ w_1 + b_1)           [R, H]
//
// in the compute dtype T with f32 accumulation and an f32 elementwise chain;
// e is rounded to T before the second product. It is the "flattened form"
// of the fused edge kernel (fused_edge.cu): the same two products without
// the in-kernel embedding, the broadcast adds and the j-reduction, which
// stay outside.
//
// What bounds it: at the harness's shape (R = 81,200, lanes = 64, H = 256,
// bf16) the card's tensor cores would need 13.3 GFLOP / 989 TFLOP/s = 13 us
// against 94 MB of rows in and out at 3.35 TB/s = 28 us, so the function is
// bound by bytes; this kernel uses FP32 FMAs and is bound by their rate.
// Design, shared with fused_edge.cu (edge_tiles.cuh): one block of 256
// threads per 64 rows; the rows of emb and then e sit k-major in shared
// memory, w_d and w_1 stream from L2 in 16-row tiles, and e never reaches
// device memory. The last block's rows past R are neither read nor written.

#include "edge_tiles.cuh"

namespace {

using namespace edge_tiles;

template <typename T, int H>
__global__ void __launch_bounds__(kThreads, 2)
    edge_flat_kernel(const T* __restrict__ emb, const T* __restrict__ ts,
                     const T* __restrict__ wd, const T* __restrict__ w1,
                     const T* __restrict__ b1, T* __restrict__ out, int R,
                     int lanes) {
  constexpr int RM = H / 32;
  constexpr int TX = H / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* opnd = reinterpret_cast<float*>(smem_raw);  // emb, then e
  T* btile = reinterpret_cast<T*>(smem_raw + size_t(H) * kLda * 4);

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int first = static_cast<int>(blockIdx.x) * kRows;
  const int rows = min(kRows, R - first);
  const size_t r0 = static_cast<size_t>(first);
  const int Kd = ((lanes + kKt - 1) / kKt) * kKt;

  for (int idx = tid; idx < kRows * Kd; idx += kThreads) {
    const int r = idx / Kd;
    const int l = idx % Kd;
    float v = 0.0f;
    if (r < rows && l < lanes) v = to_float(emb[(r0 + r) * lanes + l]);
    opnd[l * kLda + r] = v;
  }
  __syncthreads();

  float acc[RM][8];
  gemm_block<T, H>(opnd, wd, Kd, lanes, btile, acc, tid);

  const int c0 = tx * 4;
  const int c1 = H / 2 + tx * 4;
  float e[RM][8];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = ty * RM + m;
    if (r < rows) {
      const T* tp = ts + (r0 + r) * H;
      const float4 p0 = load4(tp + c0);
      const float4 p1 = load4(tp + c1);
      const float t[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int n = 0; n < 8; ++n) e[m][n] = round_to<T>(silu(acc[m][n] + t[n]));
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) e[m][n] = 0.0f;
    }
  }
  // gemm_block ended on a barrier, so emb is no longer read
  store_tile_kmajor<H>(opnd, e, tid);
  __syncthreads();

  gemm_block<T, H>(opnd, w1, H, H, btile, acc, tid);

  const float4 v0 = load4(b1 + c0);
  const float4 v1 = load4(b1 + c1);
  const float bias[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = ty * RM + m;
    if (r < rows) {
      float s[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n] = silu(acc[m][n] + bias[n]);
      T* op = out + (r0 + r) * H;
      store4(op + c0, s[0], s[1], s[2], s[3]);
      store4(op + c1, s[4], s[5], s[6], s[7]);
    }
  }
}

}  // namespace

// dtype: 1 = bfloat16 (the only instance: the harness's H = 256 in bf16).
// emb [R, lanes], ts/out [R, H], wd [lanes, H], w1 [H, H] (in, out), b1 [H];
// all contiguous and 16-byte aligned. Returns a cudaError_t.
extern "C" int edge_flat_launch(const void* emb, const void* ts,
                                const void* wd, const void* w1,
                                const void* b1, void* out, int R, int lanes,
                                int H, int dtype, void* stream) {
  if (R <= 0 || lanes <= 0 || lanes > kMaxLanes || H != 256 || dtype != 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  using T = __nv_bfloat16;
  constexpr int kH = 256;
  constexpr size_t smem = size_t(kH) * kLda * 4 + tile_bytes<T, kH>();
  auto* kernel = edge_flat_kernel<T, kH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (R + kRows - 1) / kRows;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(emb), static_cast<const T*>(ts),
      static_cast<const T*>(wd), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<T*>(out), R, lanes);
  return static_cast<int>(cudaGetLastError());
}
