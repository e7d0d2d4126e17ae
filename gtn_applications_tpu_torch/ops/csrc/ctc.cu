// Banded CTC lattice recursions: the alpha trajectory and the posterior
// gradient with respect to the per-state emissions.
//
// Replaces gtn_applications_tpu/ops/lattice_pallas.py: _ctc_fwd_kernel (:57)
// and _ctc_bwd_kernel (:79), wrapped there by ctc_score_pallas (:152).
//
// States s = 0..S-1 (S = 2L + 1) of sample b; em, alpha, grad are [B, T, S].
//   alpha:  alpha[0]   = start + em[0]
//           alpha[t]   = em[t] + lse3(alpha, shift1(alpha), skip ? shift2(alpha))
//           frozen (alpha[t] = alpha[t-1]) where t >= len[b]
//   grad:   beta starts at accept; for t = T-1 .. 0:
//             grad[t] = t < len ? exp(min(alpha[t] + beta - score, 0)) * g : 0
//             eb      = em[t] + beta
//             beta    = t < len ? lse3(eb, eb[s+1], skip[s+2] ? eb[s+2]) : beta
// lse3 is the TPU kernel's exactly: max clamped to NEG, log(max(sum, 1e-30)),
// all three exponentials taken even for NEG inputs.  Out-of-range shifts
// read NEG.  Built without --use_fast_math: expf/logf must be the accurate
// ones near the floor.
//
// What bounds it on the H100: neither bytes (about 5.7 MB move at B=32,
// T=250, S=89, under 2 us at 3.35 TB/s) nor arithmetic, but the chain of T
// dependent steps, each an exp/log round plus a block barrier.  The TPU
// kernel ran the time axis as its sequential grid with a VMEM carry; Hopper
// blocks run in parallel and in no order, so the time loop moves inside one
// block per sample, with the state double-buffered in shared memory and one
// __syncthreads() per step (two in the backward).  Threads stride over the
// S states; S is not padded.  With B=32 only 32 of the 132 SMs are busy.
// Steps at t >= len are a plain copy (forward) or zeros (backward), so the
// dependent chain is max(len) long.  Tiling several samples per block, or a
// warp per sample, are later designs.

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

__global__ void ctc_alpha_kernel(const float* __restrict__ em,
                                 const float* __restrict__ start,
                                 const float* __restrict__ skip,
                                 const int* __restrict__ lens,
                                 float* __restrict__ alpha, int T, int S) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + S;
  float* skp = smem + 2 * S;
  const int b = blockIdx.x;
  const long base = static_cast<long>(b) * T * S;
  const float* em_b = em + base;
  float* al_b = alpha + base;
  const int t_live = live_steps(lens[b], T);

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float v = start[static_cast<long>(b) * S + s] + em_b[s];
    cur[s] = v;
    al_b[s] = v;
    skp[s] = skip[static_cast<long>(b) * S + s];
  }
  __syncthreads();

  for (int t = 1; t < t_live; ++t) {
    const float* em_t = em_b + static_cast<long>(t) * S;
    float* al_t = al_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float stay = cur[s];
      const float prev = s >= 1 ? cur[s - 1] : kNeg;
      const float jump = (s >= 2 && skp[s] > 0.5f) ? cur[s - 2] : kNeg;
      const float v = em_t[s] + lse3(stay, prev, jump);
      nxt[s] = v;
      al_t[s] = v;
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  // frozen tail: alpha keeps its value at t = len - 1
  for (int t = t_live; t < T; ++t) {
    float* al_t = al_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) al_t[s] = cur[s];
  }
}

__global__ void ctc_grad_kernel(const float* __restrict__ em,
                                const float* __restrict__ alpha,
                                const float* __restrict__ accept,
                                const float* __restrict__ skip,
                                const int* __restrict__ lens,
                                const float* __restrict__ score,
                                const float* __restrict__ g,
                                float* __restrict__ grad, int T, int S) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + S;
  float* eb = smem + 2 * S;
  float* skp = smem + 3 * S;
  const int b = blockIdx.x;
  const long base = static_cast<long>(b) * T * S;
  const float* em_b = em + base;
  const float* al_b = alpha + base;
  float* gr_b = grad + base;
  const int len = lens[b];
  const int t_live = len < 0 ? 0 : (len < T ? len : T);
  const float sc = score[b];
  const float gb = g[b];

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    cur[s] = accept[static_cast<long>(b) * S + s];
    skp[s] = skip[static_cast<long>(b) * S + s];
  }
  for (int t = t_live; t < T; ++t) {
    float* gr_t = gr_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) gr_t[s] = 0.0f;
  }
  __syncthreads();

  for (int t = t_live - 1; t >= 0; --t) {
    const long off = static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float be = cur[s];
      gr_b[off + s] = expf(fminf(al_b[off + s] + be - sc, 0.0f)) * gb;
      eb[s] = em_b[off + s] + be;
    }
    __syncthreads();
    if (t == 0) break;  // beta before frame 0 is never read
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float next = s + 1 < S ? eb[s + 1] : kNeg;
      const float jump = (s + 2 < S && skp[s + 2] > 0.5f) ? eb[s + 2] : kNeg;
      nxt[s] = lse3(eb[s], next, jump);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
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

int threads_for(int S) {
  const int t = ((S + 31) / 32) * 32;
  return t < 32 ? 32 : (t > 1024 ? 1024 : t);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" {

// em [B, T, S], start/skip [B, S] f32, lens [B] i32 -> alpha [B, T, S] f32.
// Needs 3 * S * 4 bytes of shared memory per block.
int ctc_alpha(const float* em, const float* start, const float* skip,
              const int* lens, float* alpha, int B, int T, int S,
              void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(S) * sizeof(float);
  cudaError_t err = allow_smem(ctc_alpha_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_alpha_kernel<<<B, threads_for(S), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      em, start, skip, lens, alpha, T, S);
  return static_cast<int>(cudaGetLastError());
}

// em, alpha [B, T, S], accept/skip [B, S] f32, lens [B] i32, score/g [B] f32
// -> grad [B, T, S] f32.  Needs 4 * S * 4 bytes of shared memory per block.
int ctc_grad(const float* em, const float* alpha, const float* accept,
             const float* skip, const int* lens, const float* score,
             const float* g, float* grad, int B, int T, int S, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const size_t smem = 4 * static_cast<size_t>(S) * sizeof(float);
  cudaError_t err = allow_smem(ctc_grad_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_grad_kernel<<<B, threads_for(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      em, alpha, accept, skip, lens, score, g, grad, T, S);
  return static_cast<int>(cudaGetLastError());
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
