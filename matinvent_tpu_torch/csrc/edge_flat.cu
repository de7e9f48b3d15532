// Flat edge MLP over row-flattened edges, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel experiments/fused_edge_flat_r5.py:41
// `_flat_kernel` (launched by `make_flat`, :52). For R edge rows it computes
//
//     e   = silu(emb @ w_d + ts)          emb [R, lanes], ts [R, H]
//     out = silu(e @ w_1 + b_1)           [R, H]
//
// in bf16 with f32 accumulation and an f32 elementwise chain; e is rounded
// to bf16 before the second product. It is the "flattened form" of the
// fused edge kernel (fused_edge.cu): the same two products without the
// in-kernel embedding, the broadcast adds and the j-reduction, which stay
// outside.
//
// What bounds it: at the harness's shape (R = 81,200, lanes = 64, H = 256)
// the tensor cores need 13.3 GFLOP / 989 TFLOP/s = 13 us against 94 MB of
// rows in and out at 3.35 TB/s = 28 us, so the function is bound by bytes.
// Design, on fused_edge.cu's tiles (edge_tiles.cuh, bf16 route): persistent
// blocks of 256 threads keep w_d and w_1 resident in shared memory (200 KB
// with the emb and e tiles, one block per SM) and walk the 64-row tiles;
// both products run as bf16 mma.m16n8k16, e never reaches device memory,
// and the output is stored from the accumulator fragments. Rows past R are
// neither read nor written.

#include "edge_tiles.cuh"

namespace {

using namespace edge_tiles;

template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    edge_flat_kernel(const __nv_bfloat16* __restrict__ emb,
                     const __nv_bfloat16* __restrict__ ts,
                     const __nv_bfloat16* __restrict__ wd,
                     const __nv_bfloat16* __restrict__ w1,
                     const __nv_bfloat16* __restrict__ b1,
                     __nv_bfloat16* __restrict__ out, int R, int lanes,
                     int n_tiles) {
  using G = Geo<H>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float b1s[H];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Kd = ((lanes + 15) / 16) * 16;

  Bf16Tiles<H> tiles(smem_raw);
  tiles.prepare(wd, w1, Kd, lanes, tid);
  for (int c = tid; c < H; c += kThreads) b1s[c] = to_float(b1[c]);

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const size_t first = static_cast<size_t>(tile) * kRows;
    const int rows = min(kRows, static_cast<int>(R - first));
    // this tile's rows of ts, read by the first epilogue, on their way to L2
    prefetch<false>(ts + first * H, size_t(rows) * H * 2, tid);
    // the previous tile's products are done with emb and e
    __syncthreads();
    const int chunks = Kd / 8;
    for (int idx = tid; idx < kRows * chunks; idx += kThreads) {
      const int r = idx / chunks;
      const int l0 = (idx % chunks) * 8;
      float v[8];
      if (r < rows) {
        load_lanes8(emb + (first + r) * lanes, l0, lanes, v);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = 0.0f;
      }
      tiles.store_emb8(r, l0 / 8, v);
    }
    __syncthreads();

    Acc<H> acc;
    tiles.gemm1(Kd, acc, warp, lane, tid);
    // e = silu(emb @ w_d + ts), rounded to bf16; 0 past R. Per fragment
    // half the rows of ts are loaded first, all together
    {
      const int rbase = (warp / G::WARPS_N) * G::MI * 16 + lane / 4;
      const int cbase = (warp % G::WARPS_N) * G::NI * 8 + 2 * (lane % 4);
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + mi * 16 + h * 8;
          const bool live = r < rows;
          // a row past R reads the tile's first row and discards it
          const __nv_bfloat16* tp = ts + (first + (live ? r : 0)) * H + cbase;
          float2 t[G::NI];
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) t[ni] = load2(tp + ni * 8);
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) {
            const float* v = acc[mi][ni] + 2 * h;
            tiles.store_e(
                r, cbase + ni * 8,
                live ? round_to<__nv_bfloat16>(silu(v[0] + t[ni].x)) : 0.0f,
                live ? round_to<__nv_bfloat16>(silu(v[1] + t[ni].y)) : 0.0f);
          }
        }
      }
    }
    __syncthreads();

    tiles.gemm2(acc, warp, lane, tid);
    for_each_acc<H>(acc, warp, lane, [&](int r, int c, float v0, float v1) {
      if (r < rows) {
        store2(out + (first + r) * H + c, silu(v0 + b1s[c]),
               silu(v1 + b1s[c + 1]));
      }
    });
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
  constexpr size_t smem = Bf16Tiles<kH>::kBytes;
  auto* kernel = edge_flat_kernel<kH>;
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = resident_blocks(kernel, smem);
    if (slots == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int n_tiles = (R + kRows - 1) / kRows;
  const int grid = n_tiles < slots ? n_tiles : slots;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(emb), static_cast<const T*>(ts),
      static_cast<const T*>(wd), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<T*>(out), R, lanes, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory (bytes) of one block of the H = 256 bf16 instance.
extern "C" int edge_flat_smem_bytes() {
  return static_cast<int>(Bf16Tiles<256>::kBytes);
}
