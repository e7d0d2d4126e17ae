// Banded CTC lattice recursions: the alpha trajectory and the posterior
// gradient with respect to the per-state emissions.
//
// Replaces gtn_applications_tpu/ops/lattice_pallas.py: _ctc_fwd_kernel (:57)
// and _ctc_bwd_kernel (:79), wrapped there by ctc_score_pallas (:152).
//
// States s = 0..S-1 (S = 2L + 1) of sample b; alpha, grad are [B, T, S], and
// em[t, s] = lp[b, t, labels[b, s]] (0 where the label is outside [0, C)):
// both kernels read the log-probabilities lp [B, T, C] by label, the gather
// (gather.cu's forward, gtn_applications_tpu/ops/gathers.py:30) moved into
// their emission copies, so em never goes through device memory.
//   alpha:  alpha[0]   = start + em[0]
//           alpha[t]   = em[t] + lse3(alpha, shift1(alpha), skip ? shift2(alpha))
//           frozen (alpha[t] = alpha[t-1]) where t >= len[b]
//   grad:   beta starts at accept; for t = T-1 .. 0:
//             grad[t] = t < len ? exp(min(alpha[t] + beta - score, 0)) * g : 0
//             eb      = em[t] + beta
//             beta    = t < len ? lse3(eb, eb[s+1], skip[s+2] ? eb[s+2]) : beta
// Chunk calls (the rest of ctc_alpha's and ctc_grad's arguments): a call
// runs frames [t0, t0 + T) of an lp of Tl frames (lp[b] + t0 C, its own T
// stride: no slice is copied), lens read relative to t0 (a sample's live
// frames in the call: len - t0, clamped into [0, T]); the score's
// recursion over a long T is then a chain of such calls, each carrying one
// [B, S] row:
//   alpha:  alpha_in [B, S] (the alpha of frame t0 - 1) stands for
//           alpha[-1]: frame 0 of the call is em[t0] + lse3(alpha_in, ...)
//           where t0 < len, else alpha_in frozen; no alpha_in: frame 0 is
//           start + em[t0], whatever len is.  alpha_out [B, S] takes the
//           call's last alpha (the next call's alpha_in).
//   grad:   beta starts at beta_in [B, S] (accept for the call holding
//           the last frame, else the beta_out of the call after it) and
//           beta_out [B, S] takes the beta after the transition of the
//           call's frame 0 (the accept of the call before it); a sample
//           with len <= t0 emits zeros and passes beta_in through.  grad
//           rows go to a tensor of Tg >= T frames a sample (grad[b] + t0 S
//           from the caller), so that the calls fill one [B, Tg, S]
//           posterior.
// The chunk mode keeps alpha and beta growing over one call's frames, not
// over T (ops/lattice_pallas.py says the same of the plain versions): a
// carried alpha_in less its carry_shift (its largest entry, 0 where all
// are dead; to shift_out where given, which the caller adds up in float64
// into the score), and, called without a score, ctc_grad's beta_in less
// its own, the posterior against the call's own score and each frame's
// row over its own sum (see ctc_grad_warp_kernel).  With t0 = 0, T = Tl =
// Tg, no alpha_in, a score and no beta_out a call is the whole-T recursion
// above, unchanged.
// lse3 is the TPU kernel's exactly: max clamped to NEG, log(max(sum, 1e-30)),
// all three exponentials taken even for NEG inputs.  Out-of-range shifts
// read NEG.  Built without --use_fast_math: expf/logf must be the accurate
// ones near the floor.
//
// What bounds it on the H100: neither bytes (about 5 MB move at B=32,
// T=250, S=89, under 2 us at 3.35 TB/s) nor arithmetic, but the chain of T
// dependent steps, each an exp/log round.  The TPU kernel ran the time axis
// as its sequential grid with a VMEM carry; Hopper blocks run in parallel
// and in no order, so the time loop moves inside the kernel.  Steps at
// t >= len are a plain copy (forward) or zeros (backward), so the dependent
// chain is max(len) long.
//
// ctc_alpha: route "block" of ctc_grad below, mirrored (block_plan gives its
// layout; ops/lattice_pallas.py alpha_plan mirrors it): W = min(32, ceil(S / 32)) warps a sample,
// thread i holding states i + 32 W k, K = ceil(S / 32 W) (16 past 8), alpha
// and the skip flags (a bit mask) in registers.  alpha[s - 1] and
// alpha[s - 2] come from the lanes 1 and 2 below by __shfl_up_sync; a
// warp's lanes 0 and 1 take the warp below's lanes 30 and 31 through
// shared memory double-buffered by frame parity (warp 0 the last warp's of
// the slot below, NEG for slot 0): one __syncthreads() a frame.  With one
// warp (S <= 32, route "warp") the rotation by shuffle does it all and the
// frames have no barrier.  The skip mask sits on the destination, so the
// exchange passes raw alpha.  The em rows pass through a ring of
// kBlockRing frames filled by cp.async (each state's 4-byte copy reads the
// lp row at its label, kept in a register) and are read into registers two
// frames ahead, frames in pairs as one block of code: frames past the last
// are computed and dropped (their copies read a clamped frame), each live
// frame's row stored fire-and-forget, the frozen tail written from
// registers after the frames.  lse3's operands and the add of em keep the
// order of the one-block-a-sample kernel this replaced, so alpha is the
// same bit for bit.
//
// ctc_grad: each frame is one block of code (no branch: frames past the
// last are computed and dropped, stores predicated), so that the
// scheduler can interleave the frame's independent work with its chain.
// Route "block" (S > kWarpMaxS): a warp for each 32 states (W = min(32,
// ceil(S / 32)); thread i holds states i + 32 W k, K = ceil(S / 32 W): one
// state a thread up to 1,024 states, 16 past 8), beta and the skip flags
// (a bit mask) in registers.  eb[s + 1] and eb[s + 2] come from the lanes
// 1 and 2 above by __shfl_down_sync; a warp's top lanes take the warp
// above's edge lanes through shared memory double-buffered by frame
// parity: one __syncthreads() a frame.  The em[t] and alpha[t] rows pass
// through a ring of kBlockRing frames in shared memory, filled by cp.async
// (each thread its own states, coalesced) and read into registers two
// frames ahead: no frame waits on a global load.  The posterior
// exp(min(alpha + beta - score, 0)) g feeds nothing in the recursion: its
// store is fire-and-forget; frames t >= len are zeroed before the frames.
// Route "warp" (S <= kWarpMaxS): a block of two warps a sample, no block
// barrier in the frames.  The chain warp runs the recursion, lane l holding
// states l K + k (K = ceil(S / 32)), neighbours from its own states or the
// lane above's by __shfl_down_sync (neighbours_above: the chain bound
// probe's exchange reversed), its em rows in its own cp.async ring; the
// helper warp takes the posterior off the chain: the chain writes each
// frame's beta into a ring and arrives on the slot's "full" mbarrier, the
// helper waits on it, reads beta and its own alpha rows, arrives on the
// slot's "empty" mbarrier and stores the grad row coalesced.  A warp issues
// its frame's work from one scheduler: with K >= 2 states a lane it loses
// to route "block", whose K = 1 warps issue from several with one barrier
// (PERF.md section 6), so the warp route takes S <= 32 only.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kFloor = 1e-30f;

__device__ __forceinline__ float lse3(float a, float b, float c) {
  float m = fmaxf(fmaxf(a, b), c);
  m = fmaxf(m, kNeg);
  const float r = expf(a - m) + expf(b - m) + expf(c - m);
  return m + logf(fmaxf(r, kFloor));
}

__device__ __forceinline__ int live_steps(int len, int T) {
  return len < 1 ? 1 : (len < T ? len : T);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The shift a chunk call takes off its carried row (lattice_pallas.py
// carry_shift): the row's largest entry over the block's W warps (each
// thread's own max in v; red holds W floats), 0 where every entry is
// dead.  One barrier where W > 1; every thread must call it.
__device__ __forceinline__ float carry_shift(float v, float* red, int lane, int warp, int W) {
  v = warp_max(v);
  if (W > 1) {
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = red[0];
    for (int w = 1; w < W; ++w) v = fmaxf(v, red[w]);
  }
  return v > 0.5f * kNeg ? v : 0.0f;
}

// The exchange of the chain warp, whose lane l holds states l K + k: the
// values of states s + 1 (y1) and s + 2 (y2) of its states, the lane's own
// or, for its top states, the lane above's (by __shfl_down_sync); NEG past
// the warp's last state.  y2 takes the skip-masked values (jm).  The alpha
// recursion would take its mirror (s - 1 and s - 2, from the lane below).
template <int K>
__device__ __forceinline__ void neighbours_above(const float (&eb)[K], const float (&jm)[K],
                                                 float (&y1)[K], float (&y2)[K], int lane) {
  const float up1 = __shfl_down_sync(0xffffffffu, eb[0], 1);
  const float upj = __shfl_down_sync(0xffffffffu, jm[0], K >= 2 ? 1 : 2);
  const float upj1 = K >= 2 ? __shfl_down_sync(0xffffffffu, jm[K >= 2 ? 1 : 0], 1) : 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    y1[k] = k + 1 < K ? eb[k + 1] : (lane < 31 ? up1 : kNeg);
    if (k + 2 < K)
      y2[k] = jm[k + 2];
    else if (K == 1)
      y2[k] = lane < 30 ? upj : kNeg;
    else
      y2[k] = lane < 31 ? (k + 2 == K ? upj : upj1) : kNeg;
  }
}

// Store v at p where `pred` holds: a predicated store, so that the value
// is computed outside any branch (the frames' code stays one block).
__device__ __forceinline__ void store_if(float* p, float v, unsigned pred) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.global.f32 [%0], %1;\n}"
               ::"l"(p), "f"(v), "r"(pred) : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
               ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n .reg .pred q;\n mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, q;\n}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// Store v at shared p where `pred` holds (predicated, as store_if).
__device__ __forceinline__ void store_shared_if(float* p, float v, unsigned pred) {
  asm volatile("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n @q st.shared.f32 [%0], %1;\n}"
               ::"r"(smem_addr(p)), "f"(v), "r"(pred) : "memory");
}

// Rings of rows in shared memory, filled by cp.async a ring's length of
// frames ahead; a frame's row is read into registers kAhead frames before
// its frame, so each cp.async group has ring - kAhead frames to land.  The
// frames run in pairs (kAhead), each pair one block of code: frames past
// the last (t < 0) are computed and dropped, their copies read frame 0.
constexpr int kRing = 8;       // route "warp": the chain's em, the helper's alpha
constexpr int kBlockRing = 4;  // route "block": em and alpha
constexpr int kAhead = 2;

// Copy states j = tid + n i, i < K, of a row of S (alpha's) into the same
// positions of dst (those past S read the row's last): one 4-byte cp.async
// each, each thread its own states.
template <int K>
__device__ __forceinline__ void fetch_row(float* dst, const float* row, int S, int tid, int n) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = tid + i * n;
    __pipeline_memcpy_async(dst + j, row + min(j, S - 1), sizeof(float));
  }
}

// The labels of states j = tid + n i (route "block") or tid K + i (the
// chain warp), i < K: lab[i] the channel state j emits, clamped into
// [0, C) (0 past S) so that its copy reads a real address; bit i of the
// result set where the label lies in [0, C), elsewhere em is 0 (the
// gather's rule), selected where the ring's value is read.
template <int K, bool kConsecutive>
__device__ __forceinline__ unsigned state_labels(int (&lab)[K], const int* lab_b, int S, int C,
                                                 int tid, int n) {
  unsigned inr = 0;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = kConsecutive ? tid * K + i : tid + i * n;
    const int c = j < S ? lab_b[j] : -1;
    const bool ok = c >= 0 && c < C;
    lab[i] = ok ? c : 0;
    inr |= static_cast<unsigned>(ok) << i;
  }
  return inr;
}

// Copy the emissions of those states from an lp row of C into the same
// positions of dst: one 4-byte cp.async each at the state's label.
template <int K, bool kConsecutive>
__device__ __forceinline__ void fetch_labels(float* dst, const float* row, const int (&lab)[K],
                                             int tid, int n) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int j = kConsecutive ? tid * K + i : tid + i * n;
    __pipeline_memcpy_async(dst + j, row + lab[i], sizeof(float));
  }
}

// ctc_alpha (see the header): W warps a sample, thread i holding states
// i + 32 W k; em through a ring of kBlockRing frames (kRinged) or read from
// global memory (rows past the ring's shared memory), both from lp by
// label; kOneWarp: W = 1, the exchange all by shuffle.  A carried
// alpha_in gives up its carry_shift first (to shift_out where given).
template <int K, bool kRinged, bool kOneWarp>
__global__ void __launch_bounds__(1024)
ctc_alpha_kernel(const float* __restrict__ lp, const int* __restrict__ labels,
                 const float* __restrict__ start, const float* __restrict__ alpha_in,
                 const float* __restrict__ skip, const int* __restrict__ lens,
                 float* __restrict__ alpha, float* __restrict__ alpha_out,
                 float* __restrict__ shift_out, int T, int S, int C, int Tl, int t0) {
  extern __shared__ __align__(16) float ring_a[];
  // each warp's lanes 30 and 31 by frame parity, for lanes 0 and 1 of the
  // warp above (and, from the last warp, of warp 0's next slot)
  __shared__ float top[kOneWarp ? 1 : 2 * 32 * K * 2];
  __shared__ float red[kOneWarp ? 1 : 32];  // carry_shift's warp maxima
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockDim.x, W = n >> 5;
  const int row = K * n;  // a ring slot: em's row
  const int b = blockIdx.x;
  const long base = static_cast<long>(b) * T * S;
  const float* lp_b = lp + (static_cast<long>(b) * Tl + t0) * C;
  float* al_b = alpha + base;
  // chunk mode: frame 0 is a transition from alpha_in; whole mode: the init
  const bool carried = alpha_in != nullptr;
  const int first = carried ? 0 : 1;
  const int len = lens[b] - t0;
  const int t_live = carried ? (len < 0 ? 0 : (len < T ? len : T)) : live_steps(len, T);
  int lab[K];
  const unsigned inr = state_labels<K, false>(lab, labels + static_cast<long>(b) * S, S, C,
                                              tid, n);

  // frame t's row (t clamped to the last) into ring slot t mod kBlockRing,
  // each thread its own states; a commit group
  auto fetch = [&](int t) {
    if constexpr (kRinged) {
      fetch_labels<K, false>(ring_a + (t & (kBlockRing - 1)) * row,
                             lp_b + static_cast<long>(min(t, T - 1)) * C, lab, tid, n);
      __pipeline_commit();
    }
  };
  // frame t's row into registers, from the ring or global memory
  auto load = [&](float (&e)[K], int t) {
    const float* se = ring_a + (t & (kBlockRing - 1)) * row;
    const long off = static_cast<long>(min(t, T - 1)) * C;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = kRinged ? se[tid + k * n] : lp_b[off + lab[k]];
      e[k] = (inr >> k) & 1u ? v : 0.0f;
    }
  };
  auto wait = [&]() {
    if constexpr (kRinged) asm volatile("cp.async.wait_group %0;" ::"n"(kBlockRing - kAhead) : "memory");
  };

  for (int q = 0; q < kBlockRing; ++q) fetch(first + q);
  float a[K];
  unsigned skp = 0, live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * n;
    a[k] = kNeg;
    if (s < S) {
      if (carried) {
        a[k] = alpha_in[static_cast<long>(b) * S + s];
      } else {
        a[k] = start[static_cast<long>(b) * S + s] + ((inr >> k) & 1u ? lp_b[lab[k]] : 0.0f);
        al_b[s] = a[k];
      }
      live |= 1u << k;
      if (skip[static_cast<long>(b) * S + s] > 0.5f) skp |= 1u << k;
    }
  }
  if (carried) {
    // alpha_in less its largest entry: alpha grows over one call, not over T
    float m = -3.0e38f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((live >> k) & 1u) m = fmaxf(m, a[k]);
    m = carry_shift(m, red, lane, warp, W);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((live >> k) & 1u) a[k] -= m;
    if (shift_out != nullptr && tid == 0) shift_out[b] = m;
  }
  float e_r[kAhead][K];
  wait();
#pragma unroll
  for (int q = 0; q < kAhead; ++q) load(e_r[q], first + q);
  const int below = warp > 0 ? warp - 1 : W - 1;  // the warp below; for warp 0 the last
  const int dk = warp > 0 ? 0 : 1;                // warp's, of the slot below

  // frame t: alpha[t - 1] -> alpha[t], stored where the frame is live; its
  // ring slot refilled with frame t + kBlockRing and frame t + kAhead read
  // into the registers it leaves; frames t >= t_live computed and dropped
  for (int i0 = first; i0 < t_live; i0 += kAhead) {
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int t = i0 + q;
      const unsigned on = static_cast<unsigned>(t < t_live);
      float p1[K], p2[K];
      if constexpr (kOneWarp) {
        // a rotation by 1 and 2: lanes 31 and 30 send the slot below
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float lo = k > 0 ? a[k - 1] : kNeg;
          p1[k] = __shfl_sync(0xffffffffu, lane == 31 ? lo : a[k], (lane + 31) & 31);
          p2[k] = __shfl_sync(0xffffffffu, lane >= 30 ? lo : a[k], (lane + 30) & 31);
        }
      } else {
        float* out = top + (t & 1) * (32 * K * 2);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          p1[k] = __shfl_up_sync(0xffffffffu, a[k], 1);
          p2[k] = __shfl_up_sync(0xffffffffu, a[k], 2);
          store_shared_if(out + (warp * K + k) * 2 + (lane & 1), a[k], lane >= 30);
        }
        __syncthreads();  // the top lanes of every warp
        // lanes 0 and 1: s - 1 and s - 2 from the warp below's lanes 30, 31
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int kk = k - dk;
          const float x30 = kk >= 0 ? out[(below * K + kk) * 2] : kNeg;
          const float x31 = kk >= 0 ? out[(below * K + kk) * 2 + 1] : kNeg;
          p1[k] = lane == 0 ? x31 : p1[k];
          p2[k] = lane == 0 ? x30 : (lane == 1 ? x31 : p2[k]);
        }
      }
      float* al_t = al_b + static_cast<long>(t) * S + tid;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float v = e_r[q][k] + lse3(a[k], p1[k], (skp >> k) & 1u ? p2[k] : kNeg);
        const unsigned keep = (live >> k) & on;
        store_if(al_t + k * n, v, keep);
        a[k] = keep ? v : a[k];
      }
      fetch(t + kBlockRing);
      wait();
      load(e_r[q], t + kAhead);
    }
  }
  if constexpr (kRinged) __pipeline_wait_prior(0);
  // the frozen tail: alpha keeps its value at t = t_live - 1
  for (int t = t_live; t < T; ++t) {
    float* al_t = al_b + static_cast<long>(t) * S + tid;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((live >> k) & 1u) al_t[k * n] = a[k];
  }
  if (alpha_out != nullptr) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((live >> k) & 1u) alpha_out[static_cast<long>(b) * S + tid + k * n] = a[k];
  }
}

// The chunk mode of both routes (kLocal: no score): beta starts at beta_in
// less its carry_shift; the posterior is measured against the call's own
// score, p = exp(min(alpha + beta - Z, 0)) with Z = lse(alpha + beta) at
// its last frame (the frozen frame where a sample ends earlier), and after
// the frames each row is rescaled to p g / sum(p), the frame's own
// normaliser (0 g where Z is dead): the rounding that alpha and beta
// gather over the call cancels in each frame, and no reduction runs in
// the chain.

// Z of a chunk call from this thread's alpha (the call's last row) and
// beta entries in v (live where bit k of `live`), over the block's W
// warps (red: 2 W floats; two barriers where W > 1): lse as _final_score
// takes it.
template <int K>
__device__ __forceinline__ float chunk_score(const float (&v)[K], unsigned live, float* red,
                                             int lane, int warp, int W) {
  float m = -3.0e38f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((live >> k) & 1u) m = fmaxf(m, v[k]);
  m = warp_max(m);
  if (W > 1) {
    if (lane == 0) red[warp] = m;
    __syncthreads();
    m = red[0];
    for (int w = 1; w < W; ++w) m = fmaxf(m, red[w]);
  }
  m = fmaxf(m, kNeg);
  float r = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((live >> k) & 1u) r += expf(v[k] - m);
  r = warp_sum(r);
  if (W > 1) {
    if (lane == 0) red[32 + warp] = r;
    __syncthreads();
    r = red[32];
    for (int w = 1; w < W; ++w) r += red[32 + w];
  }
  return m + logf(fmaxf(r, kFloor));
}

// The rows [0, t_live) of a chunk call's posterior p (a row of S floats a
// frame at gr), each taken to p g / sum(p): warp w of W takes kNormRows
// rows at a time, rows w kNormRows + i of each group of W kNormRows, its
// lanes states lane + 32 j, the rows' loads and sums interleaved.
constexpr int kNormRows = 8;

__device__ __forceinline__ void normalise_rows(float* gr, int t_live, int S, float g, int lane,
                                               int warp, int W) {
  for (int t0 = warp * kNormRows; t0 < t_live; t0 += W * kNormRows) {
    float r[kNormRows];
#pragma unroll
    for (int i = 0; i < kNormRows; ++i) r[i] = 0.0f;
    for (int s = lane; s < S; s += 32) {
#pragma unroll
      for (int i = 0; i < kNormRows; ++i)
        if (t0 + i < t_live) r[i] += gr[static_cast<long>(t0 + i) * S + s];
    }
#pragma unroll
    for (int i = 0; i < kNormRows; ++i) {
      r[i] = warp_sum(r[i]);
      r[i] = r[i] > 0.0f ? g / r[i] : 0.0f;
    }
    for (int s = lane; s < S; s += 32) {
#pragma unroll
      for (int i = 0; i < kNormRows; ++i) {
        if (t0 + i < t_live) {
          float* p = gr + static_cast<long>(t0 + i) * S + s;
          *p = *p * r[i];
        }
      }
    }
  }
}

// Route "warp": warp 0 the chain, warp 1 the helper (see the header).
template <int K, bool kLocal>
__global__ void __launch_bounds__(64)
ctc_grad_warp_kernel(const float* __restrict__ lp, const int* __restrict__ labels,
                     const float* __restrict__ alpha, const float* __restrict__ accept,
                     const float* __restrict__ skip, const int* __restrict__ lens,
                     const float* __restrict__ score, const float* __restrict__ g,
                     float* __restrict__ grad, float* __restrict__ beta_out, int T, int S,
                     int C, int Tl, int t0, int Tg) {
  constexpr int kRow = 32 * K;  // a ring row: the warp's 32 K states
  __shared__ __align__(16) float em_ring[kRing][kRow];
  __shared__ __align__(16) float beta_ring[kRing][kRow];
  __shared__ __align__(16) float al_ring[kRing][kRow];
  __shared__ unsigned long long full[kRing], empty[kRing];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x;
  const long base = static_cast<long>(b) * T * S;
  const int len = lens[b] - t0;
  const int t_live = len < 0 ? 0 : (len < T ? len : T);
  // beta after frame 0's transition, where the caller asks for it
  const unsigned has_out = beta_out != nullptr;
  float* bo_b = beta_out + (has_out ? static_cast<long>(b) * S : 0);
  if (threadIdx.x < kRing) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;" ::"r"(smem_addr(&full[threadIdx.x])));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;" ::"r"(smem_addr(&empty[threadIdx.x])));
  }
  __syncthreads();  // the barriers' initialisation; none in the frames

  if (threadIdx.x < 32) {
    // the chain warp: states lane K + k; the em ring's copies (from lp by
    // label) and reads are each lane's own states (no warp sync)
    const float* lp_b = lp + (static_cast<long>(b) * Tl + t0) * C;
    int lab[K];
    const unsigned inr = state_labels<K, true>(lab, labels + static_cast<long>(b) * S, S, C,
                                               lane, 32);
    float be[K];
    unsigned skp = 0, live = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = lane * K + k;
      be[k] = s < S ? accept[static_cast<long>(b) * S + s] : kNeg;
      if (s < S) live |= 1u << k;
      if (s < S && skip[static_cast<long>(b) * S + s] > 0.5f) skp |= 1u << k;
    }
    if constexpr (kLocal) {
      // beta_in less its largest entry
      float m = -3.0e38f;
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((live >> k) & 1u) m = fmaxf(m, be[k]);
      m = carry_shift(m, nullptr, lane, 0, 1);
#pragma unroll
      for (int k = 0; k < K; ++k)
        if ((live >> k) & 1u) be[k] -= m;
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (t_live == 0 && has_out && ((live >> k) & 1u)) bo_b[lane * K + k] = be[k];
    auto fetch = [&](int t) {
      fetch_labels<K, true>(em_ring[t & (kRing - 1)], lp_b + static_cast<long>(max(t, 0)) * C,
                            lab, lane, 32);
      __pipeline_commit();
    };
    auto load = [&](float (&e)[K], int t) {
      const float* r = em_ring[t & (kRing - 1)] + lane * K;
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = (inr >> k) & 1u ? r[k] : 0.0f;
    };
    for (int q = 0; q < kRing; ++q) fetch(t_live - 1 - q);
    asm volatile("cp.async.wait_group %0;" ::"n"(kRing - kAhead) : "memory");
    float e_r[kAhead][K];
#pragma unroll
    for (int q = 0; q < kAhead; ++q) load(e_r[q], t_live - 1 - q);
    // frames i = i0, i0 + 1 (t = t_live - 1 - i): beta to the helper, then
    // beta of frame t - 1; the em slot refilled with frame t - kRing, frame
    // t - kAhead read into the registers it leaves.  Both frames' beta
    // slots are free once the helper is done with frame i0 + 1 - kRing (it
    // pre-arrives on every "empty" slot once, for the first pass)
    for (int i0 = 0; i0 < t_live; i0 += kAhead) {
      mbar_wait(&empty[(i0 + 1) & (kRing - 1)], ((i0 + 1) / kRing) & 1);
#pragma unroll
      for (int q = 0; q < kAhead; ++q) {
        const int i = i0 + q, t = t_live - 1 - i;
        float* out = beta_ring[i & (kRing - 1)] + lane * K;
#pragma unroll
        for (int k = 0; k < K; ++k) out[k] = be[k];
        mbar_arrive(&full[i & (kRing - 1)]);
        float eb[K], jm[K], n1[K], n2[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          eb[k] = (live >> k) & 1u ? e_r[q][k] + be[k] : kNeg;
          jm[k] = (skp >> k) & 1u ? eb[k] : kNeg;
        }
        neighbours_above<K>(eb, jm, n1, n2, lane);
#pragma unroll
        for (int k = 0; k < K; ++k) {
          be[k] = lse3(eb[k], n1[k], n2[k]);
          store_if(bo_b + lane * K + k, be[k],
                   (live >> k) & has_out & static_cast<unsigned>(t == 0));
        }
        fetch(t - kRing);
        asm volatile("cp.async.wait_group %0;" ::"n"(kRing - kAhead) : "memory");
        load(e_r[q], t - kAhead);
      }
    }
  } else {
    // the helper warp: states lane + 32 j, the posterior and the zeros
    const float* al_b = alpha + base;
    float* gr_b = grad + static_cast<long>(b) * Tg * S;
    float sc = kLocal ? 0.0f : score[b];
    float gb = g[b];
    if constexpr (kLocal) {
      // Z from alpha's last row and beta_in less its shift (the chain
      // warp's, taken again: a maximum is exact)
      float v[K], m = -3.0e38f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int s = lane + 32 * j;
        v[j] = s < S ? accept[static_cast<long>(b) * S + s] : kNeg;
        if (s < S) m = fmaxf(m, v[j]);
      }
      m = carry_shift(m, nullptr, lane, 0, 1);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int s = min(lane + 32 * j, S - 1);
        v[j] = al_b[static_cast<long>(T - 1) * S + s] + (v[j] - m);
      }
      unsigned on = 0;
#pragma unroll
      for (int j = 0; j < K; ++j) on |= static_cast<unsigned>(lane + 32 * j < S) << j;
      sc = chunk_score<K>(v, on, nullptr, lane, 0, 1);
    }
    // the posterior's scale in the frames: g, or 1 where the rows are
    // rescaled after them
    const float gs = kLocal ? 1.0f : gb;
    for (int q = 0; q < kRing; ++q) mbar_arrive(&empty[q]);
    for (long i = lane; i < static_cast<long>(T - t_live) * S; i += 32)
      gr_b[static_cast<long>(t_live) * S + i] = 0.0f;
    auto fetch = [&](int t) {
      fetch_row<K>(al_ring[t & (kRing - 1)], al_b + static_cast<long>(max(t, 0)) * S, S, lane,
                   32);
      __pipeline_commit();
    };
    for (int q = 0; q < kRing; ++q) fetch(t_live - 1 - q);
    for (int i = 0; i < t_live; ++i) {
      const int t = t_live - 1 - i, slot = i & (kRing - 1);
      asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 1) : "memory");  // this lane's row t
      mbar_wait(&full[slot], (i / kRing) & 1);
      const float* al_t = al_ring[t & (kRing - 1)];
      float post[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int s = lane + 32 * j;
        post[j] = expf(fminf(al_t[s] + beta_ring[slot][s] - sc, 0.0f)) * gs;
      }
      mbar_arrive(&empty[slot]);
      fetch(t - kRing);
      float* gr_t = gr_b + static_cast<long>(t) * S;
#pragma unroll
      for (int j = 0; j < K; ++j) store_if(gr_t + lane + 32 * j, post[j], lane + 32 * j < S);
    }
    if constexpr (kLocal) normalise_rows(gr_b, t_live, S, sc > 0.5f * kNeg ? gb : 0.0f, lane,
                                         0, 1);
  }
}

// Route "block": W warps a sample, thread i holding states i + 32 W k; em
// (from lp by label) and alpha through a ring of kBlockRing frames
// (kRinged) or read from global memory (rows past the ring's shared memory).
template <int K, bool kRinged, bool kLocal>
__global__ void __launch_bounds__(1024)
ctc_grad_block_kernel(const float* __restrict__ lp, const int* __restrict__ labels,
                      const float* __restrict__ alpha, const float* __restrict__ accept,
                      const float* __restrict__ skip, const int* __restrict__ lens,
                      const float* __restrict__ score, const float* __restrict__ g,
                      float* __restrict__ grad, float* __restrict__ beta_out, int T, int S,
                      int C, int Tl, int t0, int Tg) {
  extern __shared__ __align__(16) float ring_s[];
  // each warp's lanes 0 and 1 (eb, then the skip-masked eb) by frame
  // parity, for the top lanes of the warp below
  __shared__ float bnd[2 * 2 * 32 * K * 2];
  __shared__ float red[kLocal ? 2 * 32 : 1];  // kLocal: the entry's reductions
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockDim.x, W = n >> 5;
  const int row = K * n;  // a ring slot: em's row, then alpha's
  const int b = blockIdx.x;
  const long base = static_cast<long>(b) * T * S;
  const float* lp_b = lp + (static_cast<long>(b) * Tl + t0) * C;
  const float* al_b = alpha + base;
  float* gr_b = grad + static_cast<long>(b) * Tg * S;
  const int len = lens[b] - t0;
  const int t_live = len < 0 ? 0 : (len < T ? len : T);
  // beta after frame 0's transition, where the caller asks for it
  const unsigned has_out = beta_out != nullptr;
  float* bo_b = beta_out + (has_out ? static_cast<long>(b) * S : 0);
  float sc = kLocal ? 0.0f : score[b];
  const float gb = g[b];
  int lab[K];
  const unsigned inr = state_labels<K, false>(lab, labels + static_cast<long>(b) * S, S, C,
                                              tid, n);

  // frame t's rows into ring slot t mod kBlockRing, each thread its own
  // states (coalesced across the warp); a commit group
  auto fetch = [&](int t) {
    if constexpr (kRinged) {
      float* dst = ring_s + (t & (kBlockRing - 1)) * 2 * row;
      const long t_c = max(t, 0);
      fetch_labels<K, false>(dst, lp_b + t_c * C, lab, tid, n);
      fetch_row<K>(dst + row, al_b + t_c * S, S, tid, n);
      __pipeline_commit();
    }
  };
  // frame t's rows into registers, from the ring or global memory
  auto load = [&](float (&e)[K], float (&a)[K], int t) {
    const float* se = ring_s + (t & (kBlockRing - 1)) * 2 * row;
    const long t_c = max(t, 0);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int j = tid + k * n;
      const float v = kRinged ? se[j] : lp_b[t_c * C + lab[k]];
      e[k] = (inr >> k) & 1u ? v : 0.0f;
      a[k] = kRinged ? se[row + j] : al_b[t_c * S + min(j, S - 1)];
    }
  };
  auto wait = [&]() {
    if constexpr (kRinged) asm volatile("cp.async.wait_group %0;" ::"n"(kBlockRing - kAhead) : "memory");
  };

  for (int q = 0; q < kBlockRing; ++q) fetch(t_live - 1 - q);
  float be[K];
  unsigned skp = 0, live = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = tid + k * n;
    be[k] = s < S ? accept[static_cast<long>(b) * S + s] : kNeg;
    if (s < S) live |= 1u << k;
    if (s < S && skip[static_cast<long>(b) * S + s] > 0.5f) skp |= 1u << k;
  }
  if constexpr (kLocal) {
    // beta_in less its largest entry; Z from alpha's last row and that beta
    float m = -3.0e38f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if ((live >> k) & 1u) m = fmaxf(m, be[k]);
    m = carry_shift(m, red, lane, warp, W);
    float v[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if ((live >> k) & 1u) be[k] -= m;
      v[k] = al_b[static_cast<long>(T - 1) * S + min(tid + k * n, S - 1)] + be[k];
    }
    __syncthreads();  // red's first use done
    sc = chunk_score<K>(v, live, red, lane, warp, W);
  }
  // the posterior's scale in the frames: g, or 1 where the rows are
  // rescaled after them
  const float gs = kLocal ? 1.0f : gb;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (t_live == 0 && has_out && ((live >> k) & 1u)) bo_b[tid + k * n] = be[k];
  for (long i = tid; i < static_cast<long>(T - t_live) * S; i += n)
    gr_b[static_cast<long>(t_live) * S + i] = 0.0f;
  float e_r[kAhead][K], a_r[kAhead][K];
  wait();
#pragma unroll
  for (int q = 0; q < kAhead; ++q) load(e_r[q], a_r[q], t_live - 1 - q);
  const int up = warp + 1 < W ? warp + 1 : 0;  // the warp above; for the last warp,
  const int dk = warp + 1 < W ? 0 : 1;          // warp 0's next slot
  const int edge = lane < 30 ? 0 : lane - 30;   // the edge lane a top lane reads

  // frame t (the posterior's store, then beta of frame t - 1), its ring
  // slot refilled with frame t - kBlockRing and frame t - kAhead read into
  // the registers it leaves; frames t < 0 are computed and dropped
  for (int i0 = 0; i0 < t_live; i0 += kAhead) {
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const int t = t_live - 1 - i0 - q;
      float* gr_t = gr_b + static_cast<long>(t) * S + tid;
      float eb[K], jm[K], n1[K], n2[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        store_if(gr_t + k * n, expf(fminf(a_r[q][k] + be[k] - sc, 0.0f)) * gs,
                 (live >> k) & static_cast<unsigned>(t >= 0));
        eb[k] = (live >> k) & 1u ? e_r[q][k] + be[k] : kNeg;
        jm[k] = (skp >> k) & 1u ? eb[k] : kNeg;
        n1[k] = __shfl_down_sync(0xffffffffu, eb[k], 1);
        n2[k] = __shfl_down_sync(0xffffffffu, jm[k], 2);
      }
      // the top lanes' s + 1 and s + 2 from the warp above's edge lanes
      float* out = bnd + (t & 1) * (2 * 32 * K * 2);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        store_shared_if(out + ((0 * 32 + warp) * K + k) * 2 + (lane & 1), eb[k], lane < 2);
        store_shared_if(out + ((1 * 32 + warp) * K + k) * 2 + (lane & 1), jm[k], lane < 2);
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int kk = k + dk < K ? k + dk : k;
        const float x1 = k + dk < K ? out[((0 * 32 + up) * K + kk) * 2] : kNeg;
        const float x2 = k + dk < K ? out[((1 * 32 + up) * K + kk) * 2 + edge] : kNeg;
        n1[k] = lane == 31 ? x1 : n1[k];
        n2[k] = lane >= 30 ? x2 : n2[k];
        be[k] = lse3(eb[k], n1[k], n2[k]);
        store_if(bo_b + tid + k * n, be[k],
                 (live >> k) & has_out & static_cast<unsigned>(t == 0));
      }
      fetch(t - kBlockRing);
      wait();
      load(e_r[q], a_r[q], t - kAhead);
    }
  }
  if constexpr (kLocal) {
    __syncthreads();  // every row of the call stored
    normalise_rows(gr_b, t_live, S, sc > 0.5f * kNeg ? gb : 0.0f, lane, warp, W);
  }
}

// Latency probe, a port of no kernel: one warp runs `iters` frames of the
// recursion's dependent chain with no memory traffic.  Each lane holds
// kProbeStates consecutive states and takes its two left neighbours from
// the lane below with shuffles, the fastest exchange a design could use
// (a warp per sample), then applies lse3 and the emission.  One frame's
// time is the least a frame of ctc_alpha or of ctc_grad's beta recursion
// can take with this arithmetic; chip_smoke.py multiplies it by the
// dependent frames of a run to get their chain bound.  32 lanes of 3
// states cover S <= 96, the bench headline's S = 89.
constexpr int kProbeStates = 3;

__global__ void ctc_chain_probe_kernel(const float* __restrict__ em,
                                       float* __restrict__ out, int iters) {
  const int lane = threadIdx.x;
  float e[kProbeStates], a[kProbeStates];
  for (int k = 0; k < kProbeStates; ++k) {
    e[k] = em[lane * kProbeStates + k];
    a[k] = e[k];
  }
  for (int i = 0; i < iters; ++i) {
    float p1 = __shfl_up_sync(0xffffffffu, a[kProbeStates - 1], 1);
    float p2 = __shfl_up_sync(0xffffffffu, a[kProbeStates - 2], 1);
    if (lane == 0) p1 = p2 = kNeg;
    float n[kProbeStates];
    n[0] = e[0] + lse3(a[0], p1, p2);
    n[1] = e[1] + lse3(a[1], a[0], p1);
#pragma unroll
    for (int k = 2; k < kProbeStates; ++k)
      n[k] = e[k] + lse3(a[k], a[k - 1], a[k - 2]);
#pragma unroll
    for (int k = 0; k < kProbeStates; ++k) a[k] = n[k];
  }
  for (int k = 0; k < kProbeStates; ++k) out[lane * kProbeStates + k] = a[k];
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// The layout of a warp for each 32 states (ops/lattice_pallas.py
// _block_plan mirrors it): W = min(32, ceil(S / 32)) warps and K =
// ceil(S / 32 W), taken as 16 past 8, with a ring where kBlockRing frames
// of `rows` rows (em, and alpha for ctc_grad) fit in kRingSmem (else the
// rows are read from global memory).  ctc_alpha takes it at every S
// (route "warp" where W = 1: no barrier); ctc_grad beyond kWarpMaxS
// states (route "block"), below them its own route "warp", K = ceil(S /
// 32) (ops/lattice_pallas.py grad_plan mirrors it).
constexpr int kWarpMaxS = 32;
constexpr long kRingSmem = 200 * 1024;

struct StatePlan {
  bool block;
  int K, warps, ring;
};

StatePlan block_plan(int S, int rows) {
  const int W = (S + 31) / 32 > 32 ? 32 : (S + 31) / 32;
  int K = (S + 32 * W - 1) / (32 * W);
  K = K > 8 ? (K > 16 ? 0 : 16) : K;
  const long ring_bytes = static_cast<long>(rows) * kBlockRing * K * 32 * W * sizeof(float);
  return {W > 1, K, W, ring_bytes <= kRingSmem ? kBlockRing : 0};
}

StatePlan grad_plan(int S) {
  if (S <= kWarpMaxS) return {false, S <= 32 ? 1 : (S + 31) / 32, 2, kRing};
  return block_plan(S, 2);
}

// Where both kernels read their emissions: lp [B, Tl, C] at each state's
// label, from frame t0 on.
struct Emissions {
  const float* lp;
  const int* labels;
  int C, Tl, t0;
};

template <int K, bool kOneWarp>
int launch_alpha(const StatePlan& plan, const Emissions& x, const float* start,
                 const float* alpha_in, const float* skip, const int* lens, float* alpha,
                 float* alpha_out, float* shift_out, int B, int T, int S, cudaStream_t st) {
  const int threads = 32 * plan.warps;
  const size_t smem = static_cast<size_t>(plan.ring) * K * threads * sizeof(float);
  auto kernel = ctc_alpha_kernel<K, true, kOneWarp>;
  if constexpr (!kOneWarp) {
    if (!plan.ring) kernel = ctc_alpha_kernel<K, false, false>;
  }
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, st>>>(x.lp, x.labels, start, alpha_in, skip, lens, alpha, alpha_out,
                                   shift_out, T, S, x.C, x.Tl, x.t0);
  return static_cast<int>(cudaGetLastError());
}

// score null: the chunk mode (kLocal)
template <int K>
int launch_grad_warp(const Emissions& x, const float* alpha, const float* accept,
                     const float* skip, const int* lens, const float* score, const float* g,
                     float* grad, float* beta_out, int B, int T, int Tg, int S, cudaStream_t st) {
  auto kernel = score ? ctc_grad_warp_kernel<K, false> : ctc_grad_warp_kernel<K, true>;
  kernel<<<B, 64, 0, st>>>(x.lp, x.labels, alpha, accept, skip, lens, score, g, grad, beta_out,
                           T, S, x.C, x.Tl, x.t0, Tg);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int launch_grad_block(const StatePlan& plan, const Emissions& x, const float* alpha,
                      const float* accept, const float* skip, const int* lens,
                      const float* score, const float* g, float* grad, float* beta_out, int B,
                      int T, int Tg, int S, cudaStream_t st) {
  const int threads = 32 * plan.warps;
  const size_t smem = static_cast<size_t>(plan.ring) * 2 * K * threads * sizeof(float);
  auto kernel = plan.ring ? (score ? ctc_grad_block_kernel<K, true, false>
                                   : ctc_grad_block_kernel<K, true, true>)
                          : (score ? ctc_grad_block_kernel<K, false, false>
                                   : ctc_grad_block_kernel<K, false, true>);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, st>>>(x.lp, x.labels, alpha, accept, skip, lens, score, g, grad,
                                   beta_out, T, S, x.C, x.Tl, x.t0, Tg);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// lp [B, Tl, C] f32, labels [B, S] i32 (state s emits lp[b, t, labels[b, s]],
// 0 where the label is outside [0, C)), alpha_in or start, skip [B, S] f32,
// lens [B] i32 -> alpha [B, T, S] f32 of frames [t0, t0 + T) and, where
// alpha_out is given, their last alpha [B, S] (chunk mode, see the header;
// start is read only without alpha_in).  One launch: W warps a sample
// (block_plan), a ring of em rows in shared memory where it fits in
// kRingSmem.
int ctc_alpha(const float* lp, const int* labels, const float* start, const float* alpha_in,
              const float* skip, const int* lens, float* alpha, float* alpha_out,
              float* shift_out, int B, int Tl, int t0, int T, int S, int C, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  if (C <= 0 || t0 < 0 || t0 + T > Tl) return static_cast<int>(cudaErrorInvalidValue);
  const StatePlan plan = block_plan(S, 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Emissions x{lp, labels, C, Tl, t0};
  if (!plan.block)
    return launch_alpha<1, true>(plan, x, start, alpha_in, skip, lens, alpha, alpha_out,
                                 shift_out, B, T, S, st);
  switch (plan.K) {
#define ALPHA_BLOCK(k)                                                                        \
  case k:                                                                                     \
    return launch_alpha<k, false>(plan, x, start, alpha_in, skip, lens, alpha, alpha_out,      \
                                  shift_out, B, T, S, st);
    ALPHA_BLOCK(1) ALPHA_BLOCK(2) ALPHA_BLOCK(3) ALPHA_BLOCK(4) ALPHA_BLOCK(5) ALPHA_BLOCK(6)
    ALPHA_BLOCK(7) ALPHA_BLOCK(8) ALPHA_BLOCK(16)
#undef ALPHA_BLOCK
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// lp [B, Tl, C] f32 and labels [B, S] i32 (as ctc_alpha), alpha [B, T, S]
// of frames [t0, t0 + T), beta_in/skip [B, S] f32, lens [B] i32, score/g
// [B] f32 -> grad rows [B, T, S] f32 (d score / d em) in a tensor of Tg
// frames a sample (grad points at its frame t0) and, where beta_out is
// given, beta after frame 0's transition [B, S] (chunk mode, see the
// header).  Route "warp" (a chain and a helper warp a sample, K = ceil(S /
// 32) states a lane) for S <= kWarpMaxS, else "block" (grad_plan).
int ctc_grad(const float* lp, const int* labels, const float* alpha, const float* beta_in,
             const float* skip, const int* lens, const float* score, const float* g, float* grad,
             float* beta_out, int B, int Tl, int t0, int T, int Tg, int S, int C, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  if (C <= 0 || t0 < 0 || t0 + T > Tl || Tg < T) return static_cast<int>(cudaErrorInvalidValue);
  const StatePlan plan = grad_plan(S);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Emissions x{lp, labels, C, Tl, t0};
  if (!plan.block) {
    switch (plan.K) {
#define GRAD_WARP(k)                                                                           \
  case k:                                                                                      \
    return launch_grad_warp<k>(x, alpha, beta_in, skip, lens, score, g, grad, beta_out,        \
                               B, T, Tg, S, st);
      GRAD_WARP(1) GRAD_WARP(2) GRAD_WARP(3) GRAD_WARP(4)
#undef GRAD_WARP
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (plan.K) {
#define GRAD_BLOCK(k)                                                                         \
  case k:                                                                                     \
    return launch_grad_block<k>(plan, x, alpha, beta_in, skip, lens, score, g, grad, beta_out, \
                                B, T, Tg, S, st);
    GRAD_BLOCK(1) GRAD_BLOCK(2) GRAD_BLOCK(3) GRAD_BLOCK(4) GRAD_BLOCK(5) GRAD_BLOCK(6)
    GRAD_BLOCK(7) GRAD_BLOCK(8) GRAD_BLOCK(16)
#undef GRAD_BLOCK
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// em [96] f32 -> out [96] f32 after `iters` frames of the probe's chain.
int ctc_chain_probe(const float* em, float* out, int iters, void* stream) {
  ctc_chain_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      em, out, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
