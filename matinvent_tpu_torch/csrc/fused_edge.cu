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
// more than 10 frequencies, an odd width) runs fused_edge_wide_kernel. Its
// weights do not fit a block's shared memory (w_1 alone is 288 KB at h384
// in bf16), so they stream from L2 for every chunk of edge rows, and the
// design is about what one streamed byte serves and how little waits:
//  * chunks of R = 128 edge rows where the layout fits (64 otherwise: f32
//    above width 256, or a wide embedding), so each weight byte fetched
//    from L2 feeds 128 rows; all 8 warps share each weight tile, in bands
//    of 32 rows;
//  * the edge stream is packed: each crystal contributes only its live
//    atoms' n_b^2 edges (n_b is one past its last atom with u_i or u_j
//    nonzero; a block computes n_b and the offsets from u_i and u_j, so
//    the padding of a bucket costs no products), its rows i >= n_b are
//    written as 0, and each block takes one item of consecutive live rows,
//    cut into R-row chunks across the rows i (a 72-atom crystal row fills
//    its tiles). A row's j-sum runs on across chunks (runs[], one f32 per
//    column). Above kTab crystals every row runs, as the Pallas kernel pads;
//  * the width is padded to Hp, a multiple of kHc = 128 columns (weight
//    columns and rows past H read as 0, so the padded e columns are 0), and
//    both products run pass by pass over 128 output columns; e stays whole
//    in shared memory because every pass of the second product reads it;
//  * bf16: emb, e and the weight tiles are bf16 in shared memory, swizzled,
//    and both products run as mma.m16n8k16 through ldmatrix; f32 keeps its
//    operands in f32 and runs 3xTF32 mma.m16n8k8;
//  * the weight tiles come by cp.async, in the compute dtype, through a
//    ring that runs on across passes, products and chunks (every chunk
//    reads the same tiles in the same order), so the next pass's first
//    tiles land while the epilogues run; a barrier per tile is the ring's
//    cost, so the tiles are as many rows as the layout holds;
//  * the j-sum is the whole block's: rounds of 32 rows are staged in f32,
//    and each thread sums 16 rows of one column; the two halves of a
//    round meet in a fixed order, so two launches agree bit for bit.
// Its layout is WideLayout (wide_layout picks the first entry of
// WIDE_LAYOUTS_* that fits 227 KB; ops/fused_edge.py's rule computes the
// same): widths up to 640 at 10 frequencies in f32 and 1280 in bf16.
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

constexpr int kHc = 128;       // output columns of one pass
constexpr int kBand = 32;      // rows of one warp band and of one j-sum round
constexpr int kLdS = kHc + 8;  // row stride of the j-sum staging rows (f32)
constexpr int kTab = 256;      // crystals a block packs by their live atoms
// dynamic shared memory one block may opt into on sm_90
constexpr int kSmemOptin = 232448;

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Element offset of (row, 8-element chunk) in a bf16 matrix of `ch` chunks
// per row (a multiple of 8), swizzled as swz<CH> does.
__device__ __forceinline__ int swz_rt(int row, int chunk, int ch) {
  return row * ch * 8 + ((chunk ^ (row & 7)) << 3);
}

// Warp tiling of an [R, kHc] pass: R / 32 bands of 32 rows (two 16-row
// fragments each) times the column groups the other warps take.
template <int R>
struct WGeo {
  static constexpr int WARPS_M = R / kBand;
  static constexpr int WARPS_N = kWarps / WARPS_M;
  static constexpr int MI = 2;
  static constexpr int NI = kHc / (8 * WARPS_N);
  static_assert(WARPS_M * WARPS_N == kWarps && NI % 2 == 0, "wide geometry");
};
template <int R>
using WAcc = float[2][WGeo<R>::NI][4];

// The wide route's dynamic shared memory at width H with `lanes` embedding
// lanes, for R-row chunks and a ring of NS weight tiles of KT rows, as byte
// offsets: the weight ring (NS tiles [KT, kHc] in the compute dtype), e [R, Hp],
// the embedding tile [R, Kd] (which the j-sum's f32 staging rows [32, kLdS]
// overlay once the first product is done), then per column the running
// j-sum and one round's carry, the phase constants, the row tables and the
// per-crystal live atoms and row and edge offsets (kTab crystals).
// bf16 tiles are swizzled, f32 rows padded by 4 (e, emb) or 8 (the ring).
struct WideLayout {
  int R = 0, KT = 0, NS = 0, Kd = 0, Hp = 0, K2 = 0, ldEmb = 0, ldE = 0,
      stage = 0;
  int e = 0, emb = 0, runs = 0, carry = 0, fms = 0, fd = 0, ti_row = 0,
      tj_row = 0, w_row = 0, u_row = 0, end_row = 0, nat = 0, off = 0,
      roff = 0, bytes = 0;
  __host__ __device__ WideLayout() {}
  __host__ __device__ WideLayout(int H, int lanes, bool bf16, int rows,
                                 int kt, int ns)
      : R(rows), KT(kt), NS(ns) {
    const int es = bf16 ? 2 : 4;
    Hp = round_up(H, kHc);
    Kd = bf16 ? round_up(lanes, 64) : round_up(lanes, KT);
    K2 = round_up(H, KT);
    ldEmb = bf16 ? Kd : Kd + 4;
    ldE = bf16 ? Hp : Hp + 4;
    stage = bf16 ? KT * kHc : KT * (kHc + 8);  // elements
    e = NS * stage * es;
    emb = e + R * ldE * es;
    const int emb_bytes = R * ldEmb * es;
    const int sum_bytes = kBand * kLdS * 4;
    runs = emb + (emb_bytes > sum_bytes ? emb_bytes : sum_bytes);
    carry = runs + Hp * 4;
    fms = carry + kHc * 4;
    fd = fms + 3 * lanes * 4;
    ti_row = fd + 3 * R * 4;
    tj_row = ti_row + R * 4;
    w_row = tj_row + R * 4;
    u_row = w_row + R * 4;
    end_row = u_row + R * 4;
    nat = end_row + R * 4;
    off = nat + kTab * 4;
    roff = off + (kTab + 1) * 4;
    bytes = roff + (kTab + 1) * 4;
  }
};

// The wide route's layouts, (R, KT, NS) per compute dtype, in the order of
// preference: the first whose shared memory fits a block runs (wide_layout;
// ops/fused_edge.py's rule walks the same table). Deeper rings and larger
// weight tiles keep more bytes in flight, larger chunks serve more rows per
// weight byte; the later entries take the widths and embeddings the
// earlier ones cannot hold.
#define WIDE_LAYOUTS_BF16(X) X(128, 64, 4) X(128, 32, 4) X(64, 32, 4)
#define WIDE_LAYOUTS_F32(X) \
  X(128, 16, 4) X(64, 32, 4) X(64, 16, 4) X(64, 8, 3)

inline WideLayout wide_layout(int H, int lanes, bool bf16) {
#define WIDE_TRY(r, kt, ns)                               \
  {                                                       \
    const WideLayout L(H, lanes, bf16, r, kt, ns);        \
    if (L.bytes <= kSmemOptin) return L;                  \
  }
  if (bf16) {
    WIDE_LAYOUTS_BF16(WIDE_TRY)
  } else {
    WIDE_LAYOUTS_F32(WIDE_TRY)
  }
#undef WIDE_TRY
  return WideLayout();
}

// Weight tile [k0, k0 + KT) x [n0, n0 + kHc) of the row-major [kvalid, H]
// matrix W into a ring stage; rows past kvalid and columns past H read as
// 0. By cp.async where H keeps every 16-byte chunk aligned, else by plain
// loads and stores (odd widths only). The caller commits.
template <typename T, int KT>
__device__ __forceinline__ void load_wtile(T* stage, const T* __restrict__ W,
                                           int k0, int n0, int kvalid, int H,
                                           int tid) {
  constexpr int E = 16 / sizeof(T);  // elements of a chunk
  constexpr int CH = kHc / E;        // chunks of a tile row
  const bool vec = H % E == 0;
  for (int idx = tid; idx < KT * CH; idx += kThreads) {
    const int k = idx / CH;
    const int c = idx % CH;
    const int gk = k0 + k;
    const int col = n0 + c * E;
    T* dst;
    if constexpr (sizeof(T) == 2) {
      dst = stage + swz<CH>(k, c);
    } else {
      dst = stage + k * (kHc + 8) + c * E;
    }
    if (vec) {
      const bool ok = gk < kvalid && col < H;
      cp_async16(dst, ok ? W + static_cast<size_t>(gk) * H + col : W,
                 ok ? 16 : 0);
    } else {
#pragma unroll
      for (int x = 0; x < E; ++x) {
        dst[x] = gk < kvalid && col + x < H
                     ? W[static_cast<size_t>(gk) * H + col + x]
                     : from_float<T>(0.0f);
      }
    }
  }
}

// acc += sA[:, kbase : kbase + KT] @ sB for one ring stage sB, bf16: both
// swizzled, sA with chA chunks per row; mma.m16n8k16 through ldmatrix.
template <int R, int KT>
__device__ __forceinline__ void mma_stage(const __nv_bfloat16* sA, int chA,
                                          int kbase,
                                          const __nv_bfloat16* sB,
                                          WAcc<R>& acc, int warp, int lane) {
  using G = WGeo<R>;
  constexpr int CHB = kHc / 8;
  const int arow = (warp / G::WARPS_N) * kBand + (lane & 15);
  const int bchunk = (warp % G::WARPS_N) * G::NI + (lane >> 4);
  const int brow = (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < KT / 16; ++ks) {
    unsigned a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      ldmatrix_x4(a[mi], sA + swz_rt(arow + mi * 16,
                                     (kbase + ks * 16) / 8 + (lane >> 4), chA));
    }
#pragma unroll
    for (int nj = 0; nj < G::NI / 2; ++nj) {
      unsigned b[4];
      ldmatrix_x4_trans(b, sB + swz<CHB>(ks * 16 + brow, bchunk + nj * 2));
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_bf16(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_bf16(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// The same in f32 as 3xTF32 (mma.m16n8k8 on split operands), sA with row
// stride lda, sB with row stride kHc + 8.
template <int R, int KT>
__device__ __forceinline__ void mma_stage(const float* sA, int lda, int kbase,
                                          const float* sB, WAcc<R>& acc,
                                          int warp, int lane) {
  using G = WGeo<R>;
  constexpr int kLdb = kHc + 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int arow = (warp / G::WARPS_N) * kBand + g;
  const int bcol = (warp % G::WARPS_N) * G::NI * 8 + g;
#pragma unroll
  for (int kk = 0; kk < KT; kk += 8) {
    unsigned ahi[2][4], alo[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const float* p = sA + (arow + mi * 16) * lda + kbase + kk + t;
      split_tf32(p[0], ahi[mi][0], alo[mi][0]);
      split_tf32(p[8 * lda], ahi[mi][1], alo[mi][1]);
      split_tf32(p[4], ahi[mi][2], alo[mi][2]);
      split_tf32(p[8 * lda + 4], ahi[mi][3], alo[mi][3]);
    }
    // two fragment columns at a time, each of the three terms over their
    // four accumulators before the next term, so that no product waits on
    // the one before it (the terms keep their order per accumulator)
#pragma unroll
    for (int ni = 0; ni < G::NI; ni += 2) {
      unsigned bhi[2][2], blo[2][2];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const float* q = sB + (kk + t) * kLdb + bcol + (ni + d) * 8;
        split_tf32(q[0], bhi[d][0], blo[d][0]);
        split_tf32(q[4 * kLdb], bhi[d][1], blo[d][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          mma_tf32(acc[mi][ni + d], alo[mi], bhi[d][0], bhi[d][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          mma_tf32(acc[mi][ni + d], ahi[mi], blo[d][0], blo[d][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
          mma_tf32(acc[mi][ni + d], ahi[mi], bhi[d][0], bhi[d][1]);
        }
      }
    }
  }
}

// The crystal b holding packed row or edge x (off[b] <= x < off[b + 1];
// empty crystals have off[b] == off[b + 1]): a binary search over
// off[0..B].
__device__ __forceinline__ int crystal_of(const int* off, int B, int x) {
  int lo = 0, hi = B;  // off[lo] <= x < off[hi]
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (off[mid] <= x) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The sampler's function (mode kFull) at any shape the tiled instances do
// not take; see the header. The edge stream is packed: with at most kTab
// crystals, crystal b contributes its n_b live rows i < n_b (n_b is one
// past its last atom with u_i or u_j nonzero), each of n_b edges j < n_b,
// from row offset roff[b] and edge offset off[b], and its rows i >= n_b are
// written as 0 (u_i is 0 there); with more crystals every row runs (n_b =
// A). One item per block takes rpi consecutive live rows, rpi the largest
// count whose items need no more R-row chunks (rpi A edges at most) than
// the fewest items the grid allows; an item's edges run in R-row chunks
// that cross the rows i, and a row's j-sum runs on across its chunks.
template <typename T, int R, int KT, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    fused_edge_wide_kernel(const T* __restrict__ ti, const T* __restrict__ tj,
                           const float* __restrict__ fr,
                           const float* __restrict__ fmat,
                           const float* __restrict__ ui,
                           const float* __restrict__ uj,
                           const T* __restrict__ wd, const T* __restrict__ w1,
                           const T* __restrict__ b1, T* __restrict__ out,
                           int B, int A, int H, int lanes, int n_sin) {
  using G = WGeo<R>;
  constexpr bool kBf16 = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const WideLayout L(H, lanes, kBf16, R, KT, NS);
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* e = reinterpret_cast<T*>(smem_raw + L.e);
  T* emb = reinterpret_cast<T*>(smem_raw + L.emb);
  float* sums = reinterpret_cast<float*>(smem_raw + L.emb);  // over emb
  float* runs = reinterpret_cast<float*>(smem_raw + L.runs);  // per column
  float* carry = reinterpret_cast<float*>(smem_raw + L.carry);
  float* fms = reinterpret_cast<float*>(smem_raw + L.fms);  // fmat [3][lanes]
  float* fd = reinterpret_cast<float*>(smem_raw + L.fd);    // [R][3]
  int* ti_row = reinterpret_cast<int*>(smem_raw + L.ti_row);  // -1 if dead
  int* tj_row = reinterpret_cast<int*>(smem_raw + L.tj_row);
  float* w_row = reinterpret_cast<float*>(smem_raw + L.w_row);  // u_j
  float* u_row = reinterpret_cast<float*>(smem_raw + L.u_row);  // u_i
  int* end_row = reinterpret_cast<int*>(smem_raw + L.end_row);  // j = n_b - 1
  int* nat = reinterpret_cast<int*>(smem_raw + L.nat);  // n_b
  int* off = reinterpret_cast<int*>(smem_raw + L.off);    // edge offsets
  int* roff = reinterpret_cast<int*>(smem_raw + L.roff);  // row offsets

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int band = warp / G::WARPS_N;
  const int rbase = band * kBand + lane / 4;
  const int cbase = (warp % G::WARPS_N) * G::NI * 8 + 2 * (lane % 4);
  const int passes = L.Hp / kHc;
  const int t1 = L.Kd / KT;  // weight tiles of a pass of each product
  const int t2 = L.K2 / KT;
  const int chE = L.Hp / 8;  // bf16 chunks of a row of e
  const int chEmb = L.Kd / 8;

#ifdef FUSED_EDGE_CYCLES
  long long clk = clock64();
#endif
  for (int c = tid; c < L.Hp; c += kThreads) runs[c] = 0.0f;
  for (int idx = tid; idx < 3 * lanes; idx += kThreads) fms[idx] = fmat[idx];

  // The weight stream: every chunk reads the same tiles in the same order
  // (w_d pass by pass, then w_1 pass by pass), so the ring runs on across
  // passes, products and chunks, NS - 1 tiles ahead of the products. The
  // next tile to ask for is (matrix wn, pass pn, k-tile kn).
  int slot_in = 0, slot_out = 0, wn = 0, pn = 0, kn = 0;
  auto issue = [&]() {
    load_wtile<T, KT>(ring + slot_in * L.stage, wn ? w1 : wd, kn * KT,
                      pn * kHc, wn ? H : lanes, H, tid);
    cp_async_commit();
    if (++slot_in == NS) slot_in = 0;
    if (++kn == (wn ? t2 : t1)) {
      kn = 0;
      if (++pn == passes) {
        pn = 0;
        wn ^= 1;
      }
    }
  };
  // acc = sA[:, :nt KT] @ the stream's next nt tiles (one pass)
  auto gemm = [&](const T* sA, int nt, WAcc<R>& acc) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < G::NI; ++ni) {
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.0f;
      }
    }
    for (int s = 0; s < nt; ++s) {
      cp_async_wait<NS - 2>();
      // the next tile has landed for every thread, and every thread is
      // done with the stage the next issue overwrites
      __syncthreads();
      issue();
      const T* sB = ring + slot_out * L.stage;
      if (++slot_out == NS) slot_out = 0;
      if constexpr (kBf16) {
        mma_stage<R, KT>(sA, sA == e ? chE : chEmb, s * KT, sB, acc, warp,
                         lane);
      } else {
        mma_stage<R, KT>(sA, sA == e ? L.ldE : L.ldEmb, s * KT, sB, acc,
                         warp, lane);
      }
    }
  };
  for (int s = 0; s < NS - 1; ++s) issue();

  // the packed stream's table: n_b by a shared-memory max over the live
  // atoms, then off[] and roff[] by scans of n_b^2 and n_b in warp 0
  const bool packed =
      B <= kTab && static_cast<long long>(B) * A * A <= 0x7fffffffLL;
  if (packed) {
    for (int b = tid; b < B; b += kThreads) nat[b] = 0;
    __syncthreads();
    for (int idx = tid; idx < B * A; idx += kThreads) {
      if (ui[idx] != 0.0f || uj[idx] != 0.0f) {
        atomicMax(nat + idx / A, idx % A + 1);
      }
    }
    __syncthreads();
    if (warp == 0) {
      int edge_base = 0, row_base = 0;
      for (int b0 = 0; b0 < B; b0 += 32) {
        const int n = b0 + lane < B ? nat[b0 + lane] : 0;
        int v = n * n, rv = n;
#pragma unroll
        for (int d = 1; d < 32; d *= 2) {
          const int u = __shfl_up_sync(0xffffffffu, v, d);
          const int ru = __shfl_up_sync(0xffffffffu, rv, d);
          if (lane >= d) {
            v += u;
            rv += ru;
          }
        }
        if (b0 + lane < B) {
          off[b0 + lane + 1] = edge_base + v;
          roff[b0 + lane + 1] = row_base + rv;
        }
        edge_base += __shfl_sync(0xffffffffu, v, 31);
        row_base += __shfl_sync(0xffffffffu, rv, 31);
      }
      if (lane == 0) {
        off[0] = 0;
        roff[0] = 0;
      }
    }
    __syncthreads();
    // rows i >= n_b: 0, a warp per row over all blocks
    for (int q = blockIdx.x * kWarps + warp; q < B * A;
         q += gridDim.x * kWarps) {
      if (q % A >= nat[q / A]) {
        for (int c = lane; c < H; c += 32) {
          out[static_cast<size_t>(q) * H + c] = from_float<T>(0.0f);
        }
      }
    }
  }
  // the crystal, its live atoms and its first packed edge, of edge x
  auto locate = [&](long long x, int& b, int& n, long long& ob) {
    if (packed) {
      b = crystal_of(off, B, static_cast<int>(x));
      n = nat[b];
      ob = off[b];
    } else {
      b = static_cast<int>(x / (static_cast<long long>(A) * A));
      n = A;
      ob = static_cast<long long>(b) * A * A;
    }
  };
  // this block's item: rows [k rpi, (k + 1) rpi) of the n_rows live rows
  const int n_rows = packed ? roff[B] : B * A;
  const int rpi_min = (n_rows + gridDim.x - 1) / gridDim.x;
  const int chunks = (rpi_min * A + R - 1) / R;  // per item, at most
  const int rpi_max = chunks * R / A;
  int rpi = rpi_max > rpi_min ? rpi_max : rpi_min;
  if (rpi > n_rows) rpi = n_rows;
  const int n_items = rpi > 0 ? (n_rows + rpi - 1) / rpi : 0;
  // the first edge of live row l (the stream's end for l = n_rows)
  auto edge_of_row = [&](int l) -> long long {
    if (!packed) return static_cast<long long>(l) * A;
    if (l >= n_rows) return off[B];
    const int b = crystal_of(roff, B, l);
    return off[b] + static_cast<long long>(l - roff[b]) * nat[b];
  };
  const int k = blockIdx.x;
  const long long e0 = k < n_items ? edge_of_row(k * rpi) : 0;
  const long long e1 = k < n_items ? edge_of_row(min((k + 1) * rpi, n_rows)) : 0;
  EDGE_PHASE(0);  // constants, the packed stream's table, the ring's start

  const int c_sum = tid % kHc;  // the j-sum: this thread's column of a pass
  const int sub = tid / kHc;    // and half of a round's 32 rows
  for (long long g0 = e0; g0 < e1; g0 += R) {
    const int rows = static_cast<int>(e1 - g0 < R ? e1 - g0 : R);
    // the previous chunk's readers of the tables, e and the sums are done
    __syncthreads();
    if (tid < R) {
      const int r = tid;
      int qi = -1, qj = 0, end = 0;
      float w = 0.0f, u = 0.0f;
      if (r < rows) {
        int b, n;
        long long ob;
        locate(g0 + r, b, n, ob);
        const int local = static_cast<int>(g0 + r - ob);
        const int i = local / n;
        const int j = local - i * n;
        qi = b * A + i;
        qj = b * A + j;
        end = j == n - 1;
        w = uj[qj];
        u = ui[qi];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const float d = fr[qj * 3 + s] - fr[qi * 3 + s];
          fd[r * 3 + s] = d - floorf(d);
        }
      }
      ti_row[r] = qi;
      tj_row[r] = qj;
      w_row[r] = w;
      u_row[r] = u;
      end_row[r] = end;
    }
    __syncthreads();
    EDGE_PHASE(1);  // row tables and fd

    // the embedding tile, 8 lanes per item, rounded to T by its store;
    // lanes past `lanes` and dead rows are 0
    for (int idx = tid; idx < R * chEmb; idx += kThreads) {
      const int r = idx / chEmb;
      const int l0 = (idx % chEmb) * 8;
      const bool live = ti_row[r] >= 0;
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int l = l0 + k;
        float x = 0.0f;
        if (live && l < lanes) {
          // rounded as written (no contraction), as the plain version sums
          const float ph = __fadd_rn(
              __fadd_rn(__fmul_rn(fd[r * 3], fms[l]),
                        __fmul_rn(fd[r * 3 + 1], fms[lanes + l])),
              __fmul_rn(fd[r * 3 + 2], fms[2 * lanes + l]));
          x = sin_or_cos(ph, l < n_sin);
        }
        v[k] = x;
      }
      if constexpr (kBf16) {
        uint4 u;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        }
        *reinterpret_cast<uint4*>(emb + swz_rt(r, l0 / 8, chEmb)) = u;
      } else {
        float* p = reinterpret_cast<float*>(emb) + r * L.ldEmb + l0;
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(p + 4) =
            make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    __syncthreads();
    EDGE_PHASE(2);  // embedding tile

    // e = silu(emb @ w_d + term_i + term_j), rounded to T by its store,
    // pass by pass; 0 on dead rows and on the columns past H
    for (int p = 0; p < passes; ++p) {
      WAcc<R> acc;
      gemm(emb, t1, acc);
      EDGE_PHASE(3);  // first product
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rbase + mi * 16 + h * 8;
          const int qi = ti_row[r];
          const T* tip = ti + static_cast<size_t>(max(qi, 0)) * H;
          const T* tjp = tj + static_cast<size_t>(tj_row[r]) * H;
          // the node terms of the fragment half, loaded all together so
          // that their latencies overlap (pairs where H is even)
          float2 pi[G::NI], pj[G::NI];
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) {
            const int col = p * kHc + cbase + ni * 8;
            pi[ni] = pj[ni] = make_float2(0.0f, 0.0f);
            if (qi >= 0) {
              if (H % 2 == 0) {
                if (col < H) {
                  pi[ni] = load2(tip + col);
                  pj[ni] = load2(tjp + col);
                }
              } else {
                if (col < H) {
                  pi[ni].x = to_float(tip[col]);
                  pj[ni].x = to_float(tjp[col]);
                }
                if (col + 1 < H) {
                  pi[ni].y = to_float(tip[col + 1]);
                  pj[ni].y = to_float(tjp[col + 1]);
                }
              }
            }
          }
#pragma unroll
          for (int ni = 0; ni < G::NI; ++ni) {
            const int col = p * kHc + cbase + ni * 8;
            const float* v = acc[mi][ni] + 2 * h;
            float x[2] = {0.0f, 0.0f};
            if (qi >= 0) {
              if (col < H) x[0] = silu(v[0] + pi[ni].x + pj[ni].x);
              if (col + 1 < H) x[1] = silu(v[1] + pi[ni].y + pj[ni].y);
            }
            if constexpr (kBf16) {
              store2(e + swz_rt(r, col / 8, chE) + (col & 7), x[0], x[1]);
            } else {
              store2(e + r * L.ldE + col, x[0], x[1]);
            }
          }
        }
      }
      EDGE_PHASE(4);  // first epilogue: node terms, silu, e
    }

    // s = silu(e @ w_1 + b_1) * u_j pass by pass, then the pass's j-sum
    // in rounds of 32 rows (one warp band) staged in f32 over the
    // embedding tile: the block's threads take a column and 16 rows
    // each; the first half starts from runs[] and writes the rows i that
    // end in it, the second writes those that end in it after the first,
    // and carries its head to the first half's tail once both are done
    // (resolved after the next round's first barrier, or after the
    // pass's last round). Every run takes the same order.
    const int rounds = (rows + kBand - 1) / kBand;
    for (int p = 0; p < passes; ++p) {
      WAcc<R> acc;
      gemm(e, t2, acc);
      EDGE_PHASE(5);  // second product
      {
        float bias[G::NI][2];
#pragma unroll
        for (int ni = 0; ni < G::NI; ++ni) {
          const int col = p * kHc + cbase + ni * 8;
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            bias[ni][k] = col + k < H ? to_float(b1[col + k]) : 0.0f;
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float w = w_row[rbase + mi * 16 + h * 8];
#pragma unroll
            for (int ni = 0; ni < G::NI; ++ni) {
              float* v = acc[mi][ni] + 2 * h;
              v[0] = silu(v[0] + bias[ni][0]) * w;
              v[1] = silu(v[1] + bias[ni][1]) * w;
            }
          }
        }
      }
      EDGE_PHASE(6);  // second silu and u_j
      const int col = p * kHc + c_sum;
      float head = 0.0f, tail = 0.0f;  // the second half's, see above
      int first_q = -1;                // its first row i that ends
      float first_u = 0.0f;            // and that row's u_i
      auto resolve = [&]() {
        if (sub == 1) {
          const float c0 = carry[c_sum];
          if (first_q >= 0) {
            if (col < H) {
              out[static_cast<size_t>(first_q) * H + col] =
                  from_float<T>((c0 + head) * first_u);
            }
            runs[col] = tail;
          } else {
            runs[col] = c0 + head;
          }
        }
      };
      for (int rd = 0; rd < rounds; ++rd) {
        __syncthreads();  // the last round's sums and carries are read
        if (rd > 0) resolve();
        if (band == rd) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = lane / 4 + mi * 16 + h * 8;
#pragma unroll
              for (int ni = 0; ni < G::NI; ++ni) {
                const float* v = acc[mi][ni] + 2 * h;
                store2(sums + r * kLdS + cbase + ni * 8, v[0], v[1]);
              }
            }
          }
        }
        __syncthreads();
        const int r0 = rd * kBand + sub * (kBand / 2);
        const int r1 = min(r0 + kBand / 2, rows);
        float cur = sub == 0 ? runs[col] : 0.0f;
        head = 0.0f;
        first_q = -1;
        // this thread's 16 staged values, loaded before the walk
        float sv[kBand / 2];
#pragma unroll
        for (int k = 0; k < kBand / 2; ++k) {
          sv[k] = r0 + k < r1 ? sums[(sub * (kBand / 2) + k) * kLdS + c_sum] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < kBand / 2; ++k) {
          if (r0 + k >= r1) break;
          cur += sv[k];
          if (end_row[r0 + k]) {
            const int q = ti_row[r0 + k];
            const float u = u_row[r0 + k];
            if (sub == 1 && first_q < 0) {
              first_q = q;
              first_u = u;
              head = cur;
            } else if (col < H) {
              out[static_cast<size_t>(q) * H + col] = from_float<T>(cur * u);
            }
            cur = 0.0f;
          }
        }
        if (sub == 0) {
          carry[c_sum] = cur;
        } else if (first_q < 0) {
          head = cur;
        }
        tail = cur;
      }
      __syncthreads();
      resolve();
      EDGE_PHASE(7);  // j-sum and output
    }
  }
  cp_async_wait<0>();
}

template <typename T, int R, int KT, int NS>
cudaError_t launch_wide_as(const EdgeArgs& a, int H, size_t smem,
                           cudaStream_t stream) {
  auto* kernel = fused_edge_wide_kernel<T, R, KT, NS>;
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
  // one item per block; no more blocks than R-row chunks of the unpacked
  // stream
  const long long chunks =
      (static_cast<long long>(a.B) * a.A * a.A + R - 1) / R;
  const int grid = chunks < slots ? static_cast<int>(chunks) : slots;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.ti), static_cast<const T*>(a.tj), a.fr, a.fmat,
      a.ui, a.uj, static_cast<const T*>(a.wd), static_cast<const T*>(a.w1),
      static_cast<const T*>(a.b1), static_cast<T*>(a.out), a.B, a.A, H,
      a.lanes, a.n_sin);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const EdgeArgs& a, int H, cudaStream_t stream) {
  const WideLayout L = wide_layout(H, a.lanes, sizeof(T) == 2);
  const size_t smem = static_cast<size_t>(L.bytes);
#define WIDE_RUN(r, kt, ns)                                          \
  if (L.R == r && L.KT == kt && L.NS == ns) {                        \
    return launch_wide_as<T, r, kt, ns>(a, H, smem, stream);         \
  }
  if constexpr (sizeof(T) == 2) {
    WIDE_LAYOUTS_BF16(WIDE_RUN)
  } else {
    WIDE_LAYOUTS_F32(WIDE_RUN)
  }
#undef WIDE_RUN
  return cudaErrorInvalidValue;  // no layout fits
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

// Dynamic shared memory (bytes) of one block of the wide kernel at width H,
// `lanes` embedding lanes and dtype (0 = float32, 1 = bfloat16), and the
// rows of its chunks (fused_edge_wide_rows); -1 where no layout fits.
extern "C" int fused_edge_wide_smem_bytes(int H, int lanes, int dtype) {
  const WideLayout L = wide_layout(H, lanes, dtype != 0);
  return L.R ? L.bytes : -1;
}
extern "C" int fused_edge_wide_rows(int H, int lanes, int dtype) {
  const WideLayout L = wide_layout(H, lanes, dtype != 0);
  return L.R ? L.R : -1;
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
