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
// The tiled instances above take H in {32, 64, 128, 256}, A <= 64 and at
// most 64 lanes. Every other shape (h384, a bucket capped above 64 atoms,
// more than 10 frequencies, an odd width) runs fused_edge_wide_kernel, the
// same function on the same 64-row tiles, in the way the Pallas kernel
// pads its blocks:
//  * the width is padded to Hp, a multiple of kHc = 128 columns (the padded
//    weight columns and rows read as 0, so the padded e columns are 0 and
//    add nothing), and both products run pass by pass over 128 output
//    columns; e stays whole in shared memory (f32, [64][Hp]) because every
//    pass of the second product reads all of its Hp columns;
//  * the weights stream from L2 through a two-stage ring of 16-row tiles,
//    staged in registers so a tile's loads overlap the previous tile's
//    products, as f32; both dtypes run mma.m16n8k8 in TF32: f32 as 3xTF32,
//    bf16 as one product per fragment (a bf16 value is exact in TF32);
//  * a crystal row i of A > 64 atoms has its A edge rows in consecutive
//    64-row chunks of one block, and its j-sum runs on across the chunks
//    (runs[], one f32 per column in shared memory), in the same order on
//    every run;
//  * the embedding is any number of lanes, rounded up to 16.
// Its dynamic shared memory, 4 * (max(64 (Kd + 4), 32 * 136) + 64 (Hp + 4)
// + 2 * 16 * 136 + Hp + 3 lanes) bytes (wide_smem_bytes; ops/fused_edge.py's
// rule computes the same), bounds the width: 640 at 60 lanes. Up to
// width 256 two blocks fit on an SM.
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

// ---------------------------------------------------------------- wide route

constexpr int kHc = 128;             // output columns of one pass
constexpr int kLdB = kHc + 8;        // row stride of a staged weight tile
constexpr int kLdS = kHc + 8;        // row stride of the j-sum staging rows
constexpr int kStageW = kKt * kLdB;  // floats of one weight tile

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Float offsets of the wide kernel's dynamic shared memory. The j-sum's
// staging rows lie over the embedding tile, which no pass of the second
// product reads.
struct WideSmem {
  int Kd, Hp, ldEmb, ldE, emb, sums, e, ring, runs, fms, floats;
  __host__ __device__ WideSmem(int H, int lanes)
      : Kd(round_up(lanes, kKt)),
        Hp(round_up(H, kHc)),
        ldEmb(Kd + 4),
        ldE(Hp + 4),
        emb(0),
        sums(0),
        e(kRows * ldEmb > kSumRows * kLdS ? kRows * ldEmb : kSumRows * kLdS),
        ring(e + kRows * ldE),
        runs(ring + 2 * kStageW),
        fms(runs + Hp),
        floats(fms + 3 * lanes) {}
};

size_t wide_smem_bytes(int H, int lanes) {
  return size_t(WideSmem(H, lanes).floats) * 4;
}

// acc = sA[:, :K] @ W[:K, n0 : n0 + kHc] for the 64-row tile sA (f32 in
// shared memory, row stride lda), W row-major [kvalid, ncols] of T in
// device memory (row stride ncols; rows past kvalid and columns past ncols
// read as 0), K a multiple of kKt. The weight tiles pass through the
// two-stage ring, each loaded into registers while the previous one is
// multiplied. f32 runs 3xTF32; bf16 operands are exact in TF32, so one
// product per fragment. Ends on a barrier.
template <typename T>
__device__ __forceinline__ void gemm_wide(const float* sA, int lda,
                                          const T* __restrict__ W, int n0,
                                          int K, int kvalid, int ncols,
                                          float* ring, Acc<kHc>& acc,
                                          int warp, int lane, int tid) {
  using G = Geo<kHc>;
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int kPer = kKt * kHc / kThreads;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int arow = (warp / G::WARPS_N) * G::MI * 16 + g;
  const int bcol = (warp % G::WARPS_N) * G::NI * 8 + g;
  float v[kPer];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int idx = tid + p * kThreads;
      const int k = k0 + idx / kHc;
      const int col = n0 + idx % kHc;
      v[p] = k < kvalid && col < ncols
                 ? to_float(__ldg(W + static_cast<size_t>(k) * ncols + col))
                 : 0.0f;
    }
  };
  auto put = [&](float* dst) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int idx = tid + p * kThreads;
      dst[(idx / kHc) * kLdB + idx % kHc] = v[p];
    }
  };
  zero_acc<kHc>(acc);
  const int ntiles = K / kKt;
  fetch(0);
  put(ring);
  __syncthreads();
  for (int kt = 0; kt < ntiles; ++kt) {
    if (kt + 1 < ntiles) fetch((kt + 1) * kKt);
    const float* sB = ring + (kt & 1) * kStageW;
#pragma unroll
    for (int kk = 0; kk < kKt; kk += 8) {
      const int ka = kt * kKt + kk;
      unsigned ahi[G::MI][4], alo[G::MI][4];
#pragma unroll
      for (int mi = 0; mi < G::MI; ++mi) {
        const float* p = sA + (arow + mi * 16) * lda + ka + t;
        const float x[4] = {p[0], p[8 * lda], p[4], p[8 * lda + 4]};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if constexpr (kSplit) {
            split_tf32(x[c], ahi[mi][c], alo[mi][c]);
          } else {
            ahi[mi][c] = to_tf32(x[c]);
          }
        }
      }
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
        const float* q = sB + (kk + t) * kLdB + bcol + ni * 8;
        unsigned bhi0, blo0, bhi1, blo1;
        if constexpr (kSplit) {
          split_tf32(q[0], bhi0, blo0);
          split_tf32(q[4 * kLdB], bhi1, blo1);
        } else {
          bhi0 = to_tf32(q[0]);
          bhi1 = to_tf32(q[4 * kLdB]);
        }
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
          if constexpr (kSplit) {
            mma_tf32(acc[mi][ni], alo[mi], bhi0, bhi1);
            mma_tf32(acc[mi][ni], ahi[mi], blo0, blo1);
          }
          mma_tf32(acc[mi][ni], ahi[mi], bhi0, bhi1);
        }
      }
    }
    if (kt + 1 < ntiles) put(ring + ((kt + 1) & 1) * kStageW);
    __syncthreads();
  }
}

// The sampler's function (mode kFull) at any shape; see the header. Work
// item k is rows_i whole rows (b, i) from row k * rows_i (rows_i =
// floor(64 / A), or 1 when A > 64); its n_i * A edge rows g = il * A + j
// run in 64-row chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_edge_wide_kernel(const T* __restrict__ ti, const T* __restrict__ tj,
                           const float* __restrict__ fr,
                           const float* __restrict__ fmat,
                           const float* __restrict__ ui,
                           const float* __restrict__ uj,
                           const T* __restrict__ wd, const T* __restrict__ w1,
                           const T* __restrict__ b1, T* __restrict__ out,
                           int B, int A, int H, int lanes, int n_sin,
                           int rows_i, int n_items) {
  using G = Geo<kHc>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ float fd_s[kRows][3];
  __shared__ int ti_row[kRows];  // row (b, i) of term_i, -1 if dead
  __shared__ int tj_row[kRows];  // row (b, j) of term_j
  __shared__ float w_row[kRows];  // u_j of the row
  const WideSmem L(H, lanes);
  float* sm = reinterpret_cast<float*>(smem_raw);
  float* emb = sm + L.emb;
  float* e = sm + L.e;
  float* ring = sm + L.ring;
  float* sums = sm + L.sums;
  float* runs = sm + L.runs;  // row i's j-sum so far, per column
  float* fms = sm + L.fms;    // fmat [3][lanes]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int n_q = B * A;
  const int rbase = (warp / G::WARPS_N) * G::MI * 16 + lane / 4;
  const int cbase = (warp % G::WARPS_N) * G::NI * 8 + 2 * (lane % 4);
  for (int c = tid; c < L.Hp; c += kThreads) runs[c] = 0.0f;
  for (int idx = tid; idx < 3 * lanes; idx += kThreads) fms[idx] = fmat[idx];

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int q0 = item * rows_i;
    const int n_g = min(rows_i, n_q - q0) * A;
    for (int g0 = 0; g0 < n_g; g0 += kRows) {
      const int rows = min(kRows, n_g - g0);
      // the previous chunk's readers of the tables, e and sums are done
      __syncthreads();
      if (tid < kRows) {
        const int r = tid;
        int qi = -1, qj = 0;
        float w = 0.0f;
        if (r < rows) {
          const int il = (g0 + r) / A;
          qi = q0 + il;
          qj = (qi / A) * A + (g0 + r - il * A);
          w = uj[qj];
#pragma unroll
          for (int s = 0; s < 3; ++s) {
            const float d = fr[qj * 3 + s] - fr[qi * 3 + s];
            fd_s[r][s] = d - floorf(d);
          }
        }
        ti_row[r] = qi;
        tj_row[r] = qj;
        w_row[r] = w;
      }
      __syncthreads();
      for (int idx = tid; idx < kRows * L.Kd; idx += kThreads) {
        const int r = idx / L.Kd;
        const int l = idx - r * L.Kd;
        float x = 0.0f;
        if (ti_row[r] >= 0 && l < lanes) {
          const float ph = __fadd_rn(
              __fadd_rn(__fmul_rn(fd_s[r][0], fms[l]),
                        __fmul_rn(fd_s[r][1], fms[lanes + l])),
              __fmul_rn(fd_s[r][2], fms[2 * lanes + l]));
          x = round_to<T>(sin_or_cos(ph, l < n_sin));
        }
        emb[r * L.ldEmb + l] = x;
      }
      __syncthreads();

      // e = silu(emb @ w_d + term_i + term_j), rounded to T, pass by pass;
      // 0 on dead rows and padded columns
      for (int n0 = 0; n0 < L.Hp; n0 += kHc) {
        Acc<kHc> acc;
        gemm_wide<T>(emb, L.ldEmb, wd, n0, L.Kd, lanes, H, ring, acc, warp,
                     lane, tid);
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rbase + mi * 16 + h * 8;
            const int qi = ti_row[r];
            const size_t oi = static_cast<size_t>(max(qi, 0)) * H;
            const size_t oj = static_cast<size_t>(tj_row[r]) * H;
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) {
              const int col = n0 + cbase + ni * 8;
              const float* v = acc[mi][ni] + 2 * h;
              float x[2] = {0.0f, 0.0f};
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                if (qi >= 0 && col + k < H) {
                  x[k] = round_to<T>(silu(v[k] + to_float(__ldg(ti + oi + col + k)) +
                                          to_float(__ldg(tj + oj + col + k))));
                }
              }
              store2(e + r * L.ldE + col, x[0], x[1]);
            }
          }
        }
      }
      __syncthreads();

      // s = silu(e @ w_1 + b_1) * u_j, pass by pass, then the pass's j-sum:
      // kSumRows rows at a time staged in f32 (over emb, which the first
      // product's last barrier freed), thread c sums column n0 + c
      // down the rows and writes out_i = u_i * sum_j when row i's run of A
      // rows ends (runs[] carries it across chunks)
      for (int n0 = 0; n0 < L.Hp; n0 += kHc) {
        Acc<kHc> acc;
        gemm_wide<T>(e, L.ldE, w1, n0, L.Hp, H, H, ring, acc, warp, lane,
                     tid);
#pragma unroll
        for (int mi = 0; mi < G::MI; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float w = w_row[rbase + mi * 16 + h * 8];
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) {
              const int col = n0 + cbase + ni * 8;
              float* v = acc[mi][ni] + 2 * h;
#pragma unroll
              for (int k = 0; k < 2; ++k) {
                const float b = col + k < H ? to_float(__ldg(b1 + col + k)) : 0.0f;
                v[k] = silu(v[k] + b) * w;
              }
            }
          }
        }
        for (int r0 = 0; r0 < rows; r0 += kSumRows) {
          __syncthreads();
          for_each_acc<kHc>(acc, warp, lane,
                            [&](int r, int c, float v0, float v1) {
                              if (r >= r0 && r < r0 + kSumRows) {
                                store2(sums + (r - r0) * kLdS + c, v0, v1);
                              }
                            });
          __syncthreads();
          if (tid < kHc) {
            const int col = n0 + tid;
            const int r1 = min(r0 + kSumRows, rows);
            float run = runs[col];
            int r = r0;
            while (r < r1) {
              // the rows of row i's run that lie in this stage, two sums
              // apart
              const int il = (g0 + r) / A;
              const int end = (il + 1) * A - g0;
              const int stop = min(r1, end);
              float s0 = 0.0f, s1 = 0.0f;
              for (; r + 1 < stop; r += 2) {
                s0 += sums[(r - r0) * kLdS + tid];
                s1 += sums[(r + 1 - r0) * kLdS + tid];
              }
              if (r < stop) s0 += sums[(r++ - r0) * kLdS + tid];
              run += s0 + s1;
              if (r == end) {
                const size_t q = static_cast<size_t>(q0 + il);
                if (col < H) out[q * H + col] = from_float<T>(run * ui[q]);
                run = 0.0f;
              }
            }
            runs[col] = run;
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_wide(const EdgeArgs& a, int H, cudaStream_t stream) {
  auto* kernel = fused_edge_wide_kernel<T>;
  const size_t smem = wide_smem_bytes(H, a.lanes);
  // the shared-memory opt-in (raised to the largest asked so far) and the
  // resident slots at the last size
  static size_t opted = 0, last = 0;
  static int slots = 0;
  if (smem > opted) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted = smem;
  }
  if (smem != last) {
    slots = resident_blocks(kernel, smem);
    last = smem;
  }
  if (slots == 0) return cudaErrorInvalidConfiguration;
  const int rows_i = a.A <= kRows ? kRows / a.A : 1;
  const int n_items = (a.B * a.A + rows_i - 1) / rows_i;
  const int grid = n_items < slots ? n_items : slots;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.ti), static_cast<const T*>(a.tj), a.fr, a.fmat,
      a.ui, a.uj, static_cast<const T*>(a.wd), static_cast<const T*>(a.w1),
      static_cast<const T*>(a.b1), static_cast<T*>(a.out), a.B, a.A, H,
      a.lanes, a.n_sin, rows_i, n_items);
  return cudaGetLastError();
}

// Whether the tiled instances take the shape (else the wide kernel runs).
bool tiled(int A, int H, int lanes) {
  return A <= kRows && lanes <= kMaxLanes &&
         (H == 32 || H == 64 || H == 128 || H == 256);
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
// 1 = bfloat16 (the ablations take bfloat16, H = 256, A <= 64 and at most
// 64 lanes only). kFull runs a tiled instance where one takes the shape,
// else the wide kernel.
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
  if (B <= 0 || A <= 0 || H <= 0 || lanes <= 0 || n_sin < 0 ||
      n_sin > lanes || jsel < 0 || jsel >= A ||
      (mode != kFull && !tiled(A, H, lanes))) {
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
    err = tiled(A, H, lanes) ? launch_full<float>(a, H, s)
                             : launch_wide<float>(a, H, s);
  } else if (mode == kFull && dtype == 1) {
    err = tiled(A, H, lanes) ? launch_full<__nv_bfloat16>(a, H, s)
                             : launch_wide<__nv_bfloat16>(a, H, s);
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

// Dynamic shared memory (bytes) of one block of the wide kernel at width H
// and `lanes` embedding lanes (either dtype).
extern "C" int fused_edge_wide_smem_bytes(int H, int lanes) {
  return static_cast<int>(wide_smem_bytes(H, lanes));
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
