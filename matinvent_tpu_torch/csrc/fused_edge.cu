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
// What bounds it: at the sampler's shapes (H = 256, caps A <= 20) each
// crystal's A*A edge rows cost 2*(64*H + H*H) flops against 3*A*H elements of
// node terms and output, so the work is far above the card's ridge point and
// the kernel is bound by arithmetic: the FP32 FMA rate here, since no tensor
// cores are used yet. The design keeps every [A*A, H] intermediate out of
// device memory:
//  * one block of 256 threads owns one crystal and a run of whole rows i
//    (floor(64 / A) of them, i.e. at most 64 edge rows), so the j-reduction
//    never crosses blocks and needs no atomics;
//  * the embedding and e live in shared memory, k-major, and w_d and w_1
//    stream from L2 (edge_tiles.cuh);
//  * 2 blocks fit on one SM (about 102 KB of shared memory each).
// The padded rows of a crystal (u_i = 0) come out as exactly 0.
//
// The launch function has a plain C interface (raw pointers, the stream),
// returns cudaGetLastError(), and is bound from Python with ctypes
// (matinvent_tpu_torch/ops/fused_edge.py).

#include "edge_tiles.cuh"

namespace {

using namespace edge_tiles;

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

template <int H>
__host__ __device__ constexpr size_t operand_bytes() {
  // max of the embedding [kMaxLanes][kLda], e [H][kLda] and the
  // reduction buffer [kRows][H + 4], all f32
  constexpr size_t emb = size_t(kMaxLanes) * kLda * 4;
  constexpr size_t e = size_t(H) * kLda * 4;
  constexpr size_t red = size_t(kRows) * (H + 4) * 4;
  constexpr size_t m = emb > e ? emb : e;
  return m > red ? m : red;
}

template <typename T, int H, Emb E, bool kBcast, bool kAgg>
__global__ void __launch_bounds__(kThreads, 2)
    fused_edge_kernel(const T* __restrict__ ti, const T* __restrict__ tj,
                      const float* __restrict__ fr,
                      const float* __restrict__ fmat,
                      const T* __restrict__ de, const float* __restrict__ ui,
                      const float* __restrict__ uj, const T* __restrict__ wd,
                      const T* __restrict__ w1, const T* __restrict__ b1,
                      T* __restrict__ out, int A, int lanes, int n_sin,
                      int jsel, int rows_i, int n_chunks) {
  constexpr int RM = H / 32;
  constexpr int TX = H / 8;
  constexpr int kLdr = H + 4;  // row stride of the reduction buffer
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // one f32 region, used in turn as the embedding, as e and as s * u_j
  float* opnd = reinterpret_cast<float*>(smem_raw);
  T* btile = reinterpret_cast<T*>(smem_raw + operand_bytes<H>());
  __shared__ float frs[kRows][3];       // coords of the crystal's atoms
  __shared__ float fms[3][kMaxLanes];   // fmat

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.x / n_chunks;
  const int i0 = (blockIdx.x % n_chunks) * rows_i;
  const int n_i = min(rows_i, A - i0);
  const int rows = n_i * A;  // live edge rows of this block
  const int Kd = ((lanes + kKt - 1) / kKt) * kKt;

  // the embedding, k-major: opnd[l * kLda + r]; lanes past `lanes` are 0
  // (their weight rows are zero-filled)
  if constexpr (E == Emb::kRead) {
    for (int idx = tid; idx < kRows * Kd; idx += kThreads) {
      const int r = idx / Kd;
      const int l = idx % Kd;
      float v = 0.0f;
      if (r < rows && l < lanes) {
        const int i = i0 + r / A;
        const int j = r % A;
        v = to_float(de[((static_cast<size_t>(b) * A + i) * A + j) * lanes + l]);
      }
      opnd[l * kLda + r] = v;
    }
  } else {
    for (int idx = tid; idx < A * 3; idx += kThreads) {
      frs[idx / 3][idx % 3] = fr[static_cast<size_t>(b) * A * 3 + idx];
    }
    for (int idx = tid; idx < 3 * lanes; idx += kThreads) {
      fms[idx / lanes][idx % lanes] = fmat[idx];
    }
    __syncthreads();
    for (int idx = tid; idx < Kd * kRows; idx += kThreads) {
      const int l = idx / kRows;
      const int r = idx % kRows;
      float v = 0.0f;
      if (r < rows && l < lanes) {
        const int i = i0 + r / A;
        const int j = r % A;
        float fd[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          fd[s] = frs[j][s] - frs[i][s];
          fd[s] = fd[s] - floorf(fd[s]);
        }
        // rounded as written (no contraction), as the plain version sums
        const float ph = __fadd_rn(
            __fadd_rn(__fmul_rn(fd[0], fms[0][l]), __fmul_rn(fd[1], fms[1][l])),
            __fmul_rn(fd[2], fms[2][l]));
        if constexpr (E == Emb::kSinCos) {
          v = l < n_sin ? sinf(ph) : cosf(ph);
        } else {
          v = ph;
        }
      }
      opnd[l * kLda + r] = round_to<T>(v);
    }
  }
  __syncthreads();

  float acc[RM][8];
  gemm_block<T, H>(opnd, wd, Kd, lanes, btile, acc, tid);

  // e = silu(emb @ w_d + term_i + term_j)
  const int c0 = tx * 4;
  const int c1 = H / 2 + tx * 4;
  float e[RM][8];
#pragma unroll
  for (int m = 0; m < RM; ++m) {
    const int r = ty * RM + m;
    if (r < rows) {
      if constexpr (kBcast) {
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
        for (int n = 0; n < 8; ++n) e[m][n] = round_to<T>(silu(acc[m][n]));
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n) e[m][n] = 0.0f;
    }
  }
  // gemm_block ended on a barrier, so the embedding is no longer read
  store_tile_kmajor<H>(opnd, e, tid);
  __syncthreads();

  gemm_block<T, H>(opnd, w1, H, H, btile, acc, tid);

  // s * u_j (or s on the rows j = jsel), row-major [r][c] for the reduction
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
    const int j = r % A;
    if (r < rows && (kAgg || j == jsel)) {
      const float w = kAgg ? uj[static_cast<size_t>(b) * A + j] : 1.0f;
      float s[8];
#pragma unroll
      for (int n = 0; n < 8; ++n) s[n] = silu(acc[m][n] + bias[n]) * w;
      store4(opnd + r * kLdr + c0, s[0], s[1], s[2], s[3]);
      store4(opnd + r * kLdr + c1, s[4], s[5], s[6], s[7]);
    }
  }
  __syncthreads();

  for (int idx = tid; idx < n_i * H; idx += kThreads) {
    const int il = idx / H;
    const int c = idx % H;
    const float* p = opnd + (il * A) * kLdr + c;
    float sum = 0.0f;
    if constexpr (kAgg) {
      for (int j = 0; j < A; ++j) sum += p[j * kLdr];
    } else {
      sum = p[jsel * kLdr];
    }
    const size_t row = static_cast<size_t>(b) * A + i0 + il;
    out[row * H + c] = from_float<T>(sum * ui[row]);
  }
}

template <typename T, int H, Emb E, bool kBcast, bool kAgg>
cudaError_t launch_typed(const EdgeArgs& a, cudaStream_t stream) {
  const int rows_i = kRows / a.A;
  const int n_chunks = (a.A + rows_i - 1) / rows_i;
  constexpr size_t smem = operand_bytes<H>() + tile_bytes<T, H>();
  auto* kernel = fused_edge_kernel<T, H, E, kBcast, kAgg>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<a.B * n_chunks, kThreads, smem, stream>>>(
      static_cast<const T*>(a.ti), static_cast<const T*>(a.tj), a.fr, a.fmat,
      static_cast<const T*>(a.de), a.ui, a.uj, static_cast<const T*>(a.wd),
      static_cast<const T*>(a.w1), static_cast<const T*>(a.b1),
      static_cast<T*>(a.out), a.A, a.lanes, a.n_sin, a.jsel, rows_i,
      n_chunks);
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
