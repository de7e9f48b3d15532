// Fused fc edge branch of one CSPLayer, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel matinvent_tpu/ops/fused_edge.py:73 `_kernel`
// (launched by `fused_edge_chain`, :119). For a batch of crystals it computes
//
//     fd    = (x_j - x_i) mod 1                             [B, A, A, 3]
//     ph_l  = fd . fmat[:, l]                               phases, lane l
//     emb_l = sin(ph_l) for l < n_sin, else cos(ph_l)       `lanes` lanes
//     e     = silu(emb @ w_d + term_i[i] + term_j[j])
//     s     = silu(e @ w_1 + b_1)
//     out_i = u_i * sum_j s_ij * u_j                        [B, A, H]
//
// with f32 accumulation and the compute dtype T (float or bf16) for the
// node terms, the weights and the output. The phases, the elementwise chain
// and the j-sum stay in f32; emb and e are rounded to T before their
// products, as the Pallas kernel casts them for the MXU. The sampler passes
// fmat = 2 pi m on the lane (s, m) (space-major, sin half then cos half) and
// 6 nf lanes.
//
// The same body, with parts switched off at compile time, also replaces the
// two ablation kernels of the fused-edge harnesses (the production launch
// is mode kFull, so an ablation is measured on the kernel that samples):
//   experiments/fused_edge_ab_r5.py:47 `_kernel_variant`
//     kNoSin     raw phases instead of sin/cos          (Emb::kPhase)
//     kNoBcast   no term_i + term_j, j-slice for j-sum  (!kBcast, !kAgg)
//     kNoAgg     out_i = u_i * s_{i, jsel}              (!kAgg)
//     kGemmOnly  all three removed
//   experiments/fused_edge_flat_r5.py:83 `_demb_kernel`
//     kDemb      emb read from a precomputed [B, A, A, lanes] input
// The j-slice index jsel is a kernel argument, so every row's products
// still run when only the rows j = jsel reach the output.
//
// What bounds it: each crystal's A*A edge rows cost 2*(64*H + H*H) flops
// against 3*A*H elements of node terms and output, so the work is far above
// the card's ridge point and the kernel is bound by the tensor cores. The
// design (edge_tiles.cuh for the products):
//  * the B*A rows (b, i) are packed across crystals into 64-row tiles of
//    rows_i = floor(64 / A) whole rows i each (60 live rows of 64 at
//    A = 20), so the j-sum of a row i never leaves its tile;
//  * persistent blocks of 256 threads (as many as fit on the SMs) walk the
//    tiles; bf16 blocks keep both weights resident in shared memory and
//    run both products as bf16 mma.m16n8k16; f32 blocks run them as 3xTF32
//    mma.m16n8k8 with the weights streamed from L2 through a cp.async ring;
//  * fd is computed once per edge row into shared memory; emb and e live in
//    shared memory in the compute dtype and never reach device memory;
//  * the j-sum stages 32 rows of f32 s * u_j at a time in shared memory
//    (over the emb and e tiles, which the products no longer read) and each
//    thread sums one column down the rows, writing out_i when row i's run of
//    A rows ends: the f32 sum is taken in another order than the plain
//    version's, but in the same order on every run.
// Shared memory per block at H = 256: bf16 200 KB dynamic (w_d 64x256 32 KB,
// w_1 256x256 128 KB, emb 64x64 8 KB, e 64x256 32 KB; emb and e then hold
// the j-sum's 32x264 f32 staging rows)
// plus 3.3 KB static, one block per SM; f32 148 KB dynamic (emb 64x68 f32
// 17 KB, e 64x260 f32 65 KB, ring 4 x 16x264 f32 66 KB) plus 3.3 KB static.
// The padded rows of a crystal (u_i = 0) come out as exactly 0.
//
// The launch function has a plain C interface (raw pointers, the stream),
// returns cudaGetLastError(), and is bound from Python with ctypes
// (matinvent_tpu_torch/ops/fused_edge.py).

#include "edge_tiles.cuh"

namespace {

using namespace edge_tiles;

// Cycle counts of the kernel's phases in block 0 (thread 0's clock after a
// barrier that closes each phase), summed over its tiles, for
// matinvent_tpu_torch/experiments/edge_cycles.py. Compiled in only with
// -DFUSED_EDGE_CYCLES, which adds the barriers; the kernels that sample
// have neither.
#ifdef FUSED_EDGE_CYCLES
__device__ unsigned long long edge_cycles[8];
#define EDGE_PHASE(k)                                                 \
  do {                                                                \
    __syncthreads();                                                  \
    if (threadIdx.x == 0 && blockIdx.x == 0) {                        \
      const long long now = clock64();                                \
      edge_cycles[k] += static_cast<unsigned long long>(now - clk);   \
      clk = now;                                                      \
    }                                                                 \
  } while (0)
#else
#define EDGE_PHASE(k) \
  do {                \
  } while (0)
#endif

// Where a block's embedding lanes come from.
enum class Emb {
  kSinCos,  // sin / cos of the phases (the production kernel)
  kPhase,   // the raw phases, no transcendentals
  kRead,    // read from a precomputed [B, A, A, lanes] input
};

// Modes of fused_edge_launch.
enum Mode { kFull, kNoSin, kNoBcast, kNoAgg, kGemmOnly, kDemb };

struct EdgeArgs {
  const void* ti;
  const void* tj;
  const float* fr;
  const float* fmat;
  const void* de;
  const float* ui;
  const float* uj;
  const void* wd;
  const void* w1;
  const void* b1;
  void* out;
  int B, A, lanes, n_sin, jsel;
};

template <typename T, int H, Emb E, bool kBcast, bool kAgg>
__global__ void __launch_bounds__(kThreads, 1)
    fused_edge_kernel(const T* __restrict__ ti, const T* __restrict__ tj,
                      const float* __restrict__ fr,
                      const float* __restrict__ fmat,
                      const T* __restrict__ de, const float* __restrict__ ui,
                      const float* __restrict__ uj, const T* __restrict__ wd,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      T* __restrict__ out, int B, int A, int lanes, int n_sin,
                      int jsel, int rows_i, int n_tiles) {
  using Tiles = typename TilesOf<T, H>::type;
  using G = Geo<H>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float fd_s[kRows][3];     // fd of each edge row
  __shared__ float fms[3][kMaxLanes];  // fmat
  __shared__ int ti_row[kRows];        // row (b, i) of term_i, -1 if dead
  __shared__ int tj_row[kRows];        // row (b, j) of term_j
  __shared__ float w_row[kRows];       // weight of the row in the j-sum
  __shared__ float b1s[H];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Kd = ((lanes + 15) / 16) * 16;
  const int n_q = B * A;  // rows (b, i)

#ifdef FUSED_EDGE_CYCLES
  long long clk = clock64();
#endif
  Tiles tiles(smem_raw);
  tiles.prepare(wd, w1, Kd, lanes, tid);
  for (int c = tid; c < H; c += kThreads) b1s[c] = to_float(b1[c]);
  if constexpr (E != Emb::kRead) {
    for (int idx = tid; idx < 3 * lanes; idx += kThreads) {
      fms[idx / lanes][idx % lanes] = fmat[idx];
    }
  }

  EDGE_PHASE(0);  // weights resident (bf16), constants
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int q0 = tile * rows_i;
    const int n_i = min(rows_i, n_q - q0);
    if constexpr (kBcast) {
      // the rows (b, i) and (b, j) of term_i and term_j this tile reads, so
      // that the first epilogue finds them in L1
      const int qb = (q0 / A) * A;
      const int qe = ((q0 + n_i - 1) / A + 1) * A;
      prefetch<true>(ti + static_cast<size_t>(q0) * H,
                     size_t(n_i) * H * sizeof(T), tid);
      prefetch<true>(tj + static_cast<size_t>(qb) * H,
                     size_t(qe - qb) * H * sizeof(T), tid);
    }
    // the previous tile's readers of the row tables and the j-sum are done
    __syncthreads();
    if (tid < kRows) {
      const int r = tid;
      int qi = -1, qj = 0;
      float w = 0.0f;
      if (r < n_i * A) {
        const int il = r / A;
        const int j = r - il * A;
        qi = q0 + il;
        qj = (qi / A) * A + j;
        w = kAgg ? uj[qj] : (j == jsel ? 1.0f : 0.0f);
        if constexpr (E != Emb::kRead) {
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const float d = fr[qj * 3 + s] - fr[qi * 3 + s];
            fd_s[r][s] = d - floorf(d);
          }
        }
      }
      ti_row[r] = qi;
      tj_row[r] = qj;
      w_row[r] = w;
    }
    __syncthreads();
    EDGE_PHASE(1);  // row tables and fd

    // the embedding tile, 8 lanes per item; lanes past `lanes` and dead
    // rows are 0 (the weight rows past `lanes` are zero-filled too)
    const int chunks = Kd / 8;
    for (int idx = tid; idx < kRows * chunks; idx += kThreads) {
      const int r = idx / chunks;
      const int l0 = (idx % chunks) * 8;
      const bool live = ti_row[r] >= 0;
      float v[8];
      if constexpr (E == Emb::kRead) {
        if (live) {
          load_lanes8(de + (static_cast<size_t>(q0) * A + r) * lanes, l0,
                      lanes, v);
        } else {
#pragma unroll
          for (int k = 0; k < 8; ++k) v[k] = 0.0f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int l = l0 + k;
          float x = 0.0f;
          if (live && l < lanes) {
            // rounded as written (no contraction), as the plain version sums
            const float ph = __fadd_rn(
                __fadd_rn(__fmul_rn(fd_s[r][0], fms[0][l]),
                          __fmul_rn(fd_s[r][1], fms[1][l])),
                __fmul_rn(fd_s[r][2], fms[2][l]));
            if constexpr (E == Emb::kSinCos) {
              x = sin_or_cos(ph, l < n_sin);
            } else {
              x = ph;
            }
          }
          v[k] = x;
        }
      }
      tiles.store_emb8(r, l0 / 8, v);
    }
    __syncthreads();
    EDGE_PHASE(2);  // embedding tile

    Acc<H> acc;
    tiles.gemm1(Kd, acc, warp, lane, tid);
    EDGE_PHASE(3);  // first product

    // e = silu(emb @ w_d + term_i + term_j), rounded to T; 0 on dead rows.
    // Per fragment half the node terms are loaded first, all together, so
    // that their latencies overlap
    {
      const int rbase = (warp / G::WARPS_N) * G::MI * 16 + lane / 4;
      const int cbase = (warp % G::WARPS_N) * G::NI * 8 + 2 * (lane % 4);
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + mi * 16 + h * 8;
          const int qi = ti_row[r];
          if constexpr (kBcast) {
            // a dead row reads row 0 and discards it
            const T* tip = ti + static_cast<size_t>(max(qi, 0)) * H + cbase;
            const T* tjp = tj + static_cast<size_t>(tj_row[r]) * H + cbase;
            float2 p[G::NI], q[G::NI];
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) {
              p[ni] = load2(tip + ni * 8);
              q[ni] = load2(tjp + ni * 8);
            }
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) {
              float* v = acc[mi][ni] + 2 * h;
              v[0] = v[0] + p[ni].x + q[ni].x;
              v[1] = v[1] + p[ni].y + q[ni].y;
            }
          }
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) {
            const float* v = acc[mi][ni] + 2 * h;
            const bool live = qi >= 0;
            tiles.store_e(r, cbase + ni * 8,
                          live ? round_to<T>(silu(v[0])) : 0.0f,
                          live ? round_to<T>(silu(v[1])) : 0.0f);
          }
        }
      }
    }
    __syncthreads();
    EDGE_PHASE(4);  // first epilogue: node terms, silu, e

    tiles.gemm2(acc, warp, lane, tid);
    EDGE_PHASE(5);  // second product
    // s * u_j (or s on the rows j = jsel) in the fragments, f32
    {
      const int r0 = (warp / G::WARPS_N) * G::MI * 16 + lane / 4;
      const int c0 = (warp % G::WARPS_N) * G::NI * 8 + 2 * (lane % 4);
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float w = w_row[r0 + mi * 16 + h * 8];
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) {
            const int c = c0 + ni * 8;
            float* v = acc[mi][ni] + 2 * h;
            v[0] = silu(v[0] + b1s[c]) * w;
            v[1] = silu(v[1] + b1s[c + 1]) * w;
          }
        }
      }
    }
    // the j-sum: kSumRows rows at a time are staged in f32 (over emb and e,
    // which every warp has read by the barrier), then thread c sums column c
    // down the rows in order and writes out_i = u_i * sum_j when row i's run
    // of A rows ends; the sum is taken in the same order on every run
    EDGE_PHASE(6);  // second silu and u_j
    constexpr int kLdS = H + 8;
    const int live_rows = n_i * A;
    float run = 0.0f;  // row i's sum so far (thread c: column c)
    int il = 0;        // the tile's row i whose run is being summed
    for (int r0 = 0; r0 < live_rows; r0 += kSumRows) {
      __syncthreads();
      for_each_acc<H>(acc, warp, lane, [&](int r, int c, float v0, float v1) {
        if (r >= r0 && r < r0 + kSumRows) {
          store2(tiles.sums + (r - r0) * kLdS + c, v0, v1);
        }
      });
      __syncthreads();
      if (tid < H) {
        const int r1 = min(r0 + kSumRows, live_rows);
        int r = r0;
        while (r < r1) {
          // the rows of row i's run that lie in this chunk, two sums apart
          const int end = (il + 1) * A;
          const int stop = min(r1, end);
          float s0 = 0.0f, s1 = 0.0f;
          for (; r + 1 < stop; r += 2) {
            s0 += tiles.sums[(r - r0) * kLdS + tid];
            s1 += tiles.sums[(r + 1 - r0) * kLdS + tid];
          }
          if (r < stop) s0 += tiles.sums[(r++ - r0) * kLdS + tid];
          run += s0 + s1;
          if (r == end) {
            const size_t q = static_cast<size_t>(q0 + il);
            out[q * H + tid] = from_float<T>(run * ui[q]);
            run = 0.0f;
            ++il;
          }
        }
      }
    }
    EDGE_PHASE(7);  // j-sum and output
  }
}

template <typename T, int H, Emb E, bool kBcast, bool kAgg>
cudaError_t launch_typed(const EdgeArgs& a, cudaStream_t stream) {
  using Tiles = typename TilesOf<T, H>::type;
  constexpr size_t smem = Tiles::kBytes;
  auto* kernel = fused_edge_kernel<T, H, E, kBcast, kAgg>;
  // per instance, once: the shared-memory opt-in and the resident slots
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    slots = resident_blocks(kernel, smem);
    if (slots == 0) return cudaErrorInvalidConfiguration;
  }
  const int rows_i = kRows / a.A;
  const int n_tiles = (a.B * a.A + rows_i - 1) / rows_i;
  const int grid = n_tiles < slots ? n_tiles : slots;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.ti), static_cast<const T*>(a.tj), a.fr, a.fmat,
      static_cast<const T*>(a.de), a.ui, a.uj, static_cast<const T*>(a.wd),
      static_cast<const T*>(a.w1), static_cast<const T*>(a.b1),
      static_cast<T*>(a.out), a.B, a.A, a.lanes, a.n_sin, a.jsel, rows_i,
      n_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_full(const EdgeArgs& a, int H, cudaStream_t stream) {
  switch (H) {
    case 32:
      return launch_typed<T, 32, Emb::kSinCos, true, true>(a, stream);
    case 64:
      return launch_typed<T, 64, Emb::kSinCos, true, true>(a, stream);
    case 128:
      return launch_typed<T, 128, Emb::kSinCos, true, true>(a, stream);
    case 256:
      return launch_typed<T, 256, Emb::kSinCos, true, true>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The ablations exist for the harnesses' shape only: bf16, H = 256.
cudaError_t launch_ablation(int mode, const EdgeArgs& a, cudaStream_t stream) {
  using T = __nv_bfloat16;
  switch (mode) {
    case kNoSin:
      return launch_typed<T, 256, Emb::kPhase, true, true>(a, stream);
    case kNoBcast:
      return launch_typed<T, 256, Emb::kSinCos, false, false>(a, stream);
    case kNoAgg:
      return launch_typed<T, 256, Emb::kSinCos, true, false>(a, stream);
    case kGemmOnly:
      return launch_typed<T, 256, Emb::kPhase, false, false>(a, stream);
    case kDemb:
      return launch_typed<T, 256, Emb::kRead, true, true>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// mode: kFull (the sampler's kernel) .. kDemb, see Mode. dtype: 0 = float32,
// 1 = bfloat16 (the ablations take bfloat16 and H = 256 only).
// term_i/term_j/out [B, A, H], frac [B, A, 3] f32, fmat [3, lanes] f32,
// de [B, A, A, lanes] (kDemb only; fr and fmat are not read then), ui/uj
// [B, A] f32, wd [lanes, H], w1 [H, H] (in, out), b1 [H]; all contiguous
// and 16-byte aligned. Lanes below n_sin take sin, the others cos; jsel is
// the row j kept by the j-slice modes. Returns a cudaError_t.
extern "C" int fused_edge_launch(int mode, const void* ti, const void* tj,
                                 const void* fr, const void* fmat,
                                 const void* de, const void* ui,
                                 const void* uj, const void* wd,
                                 const void* w1, const void* b1, void* out,
                                 int B, int A, int H, int lanes, int n_sin,
                                 int jsel, int dtype, void* stream) {
  if (B <= 0 || A <= 0 || A > kRows || lanes <= 0 || lanes > kMaxLanes ||
      n_sin < 0 || n_sin > lanes || jsel < 0 || jsel >= A) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const EdgeArgs a{ti,
                   tj,
                   static_cast<const float*>(fr),
                   static_cast<const float*>(fmat),
                   de,
                   static_cast<const float*>(ui),
                   static_cast<const float*>(uj),
                   wd,
                   w1,
                   b1,
                   out,
                   B,
                   A,
                   lanes,
                   n_sin,
                   jsel};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mode == kFull && dtype == 0) {
    err = launch_full<float>(a, H, s);
  } else if (mode == kFull && dtype == 1) {
    err = launch_full<__nv_bfloat16>(a, H, s);
  } else if (dtype == 1 && H == 256) {
    err = launch_ablation(mode, a, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of one block of the instance at width H and
// dtype (0 = float32, 1 = bfloat16); -1 for a width without an instance.
extern "C" int fused_edge_smem_bytes(int H, int dtype) {
  size_t bytes;
  switch (H) {
    case 32:
      bytes = dtype ? Bf16Tiles<32>::kBytes : Tf32x3Tiles<32>::kBytes;
      break;
    case 64:
      bytes = dtype ? Bf16Tiles<64>::kBytes : Tf32x3Tiles<64>::kBytes;
      break;
    case 128:
      bytes = dtype ? Bf16Tiles<128>::kBytes : Tf32x3Tiles<128>::kBytes;
      break;
    case 256:
      bytes = dtype ? Bf16Tiles<256>::kBytes : Tf32x3Tiles<256>::kBytes;
      break;
    default:
      return -1;
  }
  return static_cast<int>(bytes);
}

#ifdef FUSED_EDGE_CYCLES
// Copies the 8 phase counters to host memory and zeroes them.
extern "C" int fused_edge_read_cycles(unsigned long long* host) {
  cudaError_t err =
      cudaMemcpyFromSymbol(host, edge_cycles, sizeof(edge_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(edge_cycles, zero, sizeof(zero)));
}
#endif
