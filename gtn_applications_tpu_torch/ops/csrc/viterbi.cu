// Viterbi kernels: the dense backtrace (ASG) and the whole-scan tropical
// decode over a bucketed arc table (the Transducer with transitions).
//
// Replaces gtn_applications_tpu/ops/viterbi_scan_pallas.py: _dense_bt_kernel
// (:239, wrapped there by dense_backtrace :268), _vit_kernel (:153) and
// _backtrace_kernel (:191), wrapped there by viterbi_scan (:388).
//
// Dense backtrace.  bp [B, T-1, C] int32 (sample-major: one sample's table
// is contiguous), last [B] int32 -> path [B, T] int32:
//   path[b, T-1] = last[b];  path[b, t] = bp[b, t, path[b, t+1]]
//
// What bounds it on the H100: neither bytes (80 KB a sample at T=250,
// C=80, 2.6 MB for B=32, under 1 us at 3.35 TB/s) nor arithmetic, but the
// walk itself, T-1 loads each of which needs the one before.  The TPU
// kernel ran the time axis as its sequential grid and carried a one-hot
// row; here one block per sample first stages its whole [T-1, C] table in
// shared memory with coalesced loads from all threads, so each dependent
// step of the walk is a shared-memory load (tens of cycles), not an L2 or
// HBM round trip (hundreds).  The path is written to shared memory too and
// stored coalesced at the end.  A table too large for shared memory is
// walked straight from global memory (one thread, one load per step).
//
// Whole-scan Viterbi.  The plan lays the table's arcs out as a dense
// in-degree bucket grid [D, S]: slot d of destination state s is the arc
// k = d * S + s (src, label, weight; empty slots weigh NEG), filled in
// increasing arc id.  For each live frame t < len:
//   c[d, s]  = (alpha[src[k]] + w[k]) + em[b, t, label[k]]
//   best[s]  = max(max_d c[d, s], NEG), slot = the lowest d that attains it
//   alpha[s] = best[s];  slots[b, t, s] = best > NEG ? slot : DEAD
// and for t >= len alpha is kept and slots[b, t, :] = DEAD (2^30).  The
// backpointers are int32 [B, T, S], sample-major (JAX: [T, B, S_pad]).
// The backtrace starts at the first argmax of alpha_T + accept, walks
// slot -> (src, label) back to frame 0 (label -1 and the state kept on a
// DEAD slot), and writes all -1 for a sample whose best score is <= NEG/2.
//
// What bounds them on the H100: at the decode headline (B=32, T=250,
// C=80, 82 states, D=81) the scan moves ~3 MB (em in, slots out; ~1 us at
// 3.35 TB/s) and does B T D S = 53 M relaxations of two adds and a compare,
// ~2.4 us of fp32 issue; but each frame needs the last.  The TPU kernel
// gathered em along the arcs first and ran each frame as a one-hot MXU
// gather plus D slice maxima; here one block per sample runs the time loop
// inside, with alpha (double-buffered), the frame's em row and the bucket
// tables in shared memory, and P lanes per destination state (P a power of
// two up to 32, P <= D) that each take every P-th slot and merge their
// (value, slot) pairs with warp shuffles, the lower slot winning ties.
// em is read by label straight from its row: no gather launch.  The
// backtrace stages the sample's slots and bucket tables in shared memory
// (from global memory when they do not fit) and walks with one thread.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -1e30f;
constexpr int kDead = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__global__ void dense_backtrace_kernel(const int* __restrict__ bp,
                                       const int* __restrict__ last,
                                       int* __restrict__ path, int T, int C,
                                       int staged) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  const long n = static_cast<long>(T - 1) * C;
  const int* bp_b = bp + static_cast<long>(b) * n;
  int* path_b = path + static_cast<long>(b) * T;

  if (staged) {
    int* table = smem;
    int* out = smem + n;
    for (long i = threadIdx.x; i < n; i += blockDim.x) table[i] = bp_b[i];
    __syncthreads();
    if (threadIdx.x == 0) {
      int state = last[b];
      out[T - 1] = state;
      for (int t = T - 2; t >= 0; --t) {
        state = table[static_cast<long>(t) * C + state];
        out[t] = state;
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) path_b[t] = out[t];
  } else if (threadIdx.x == 0) {
    int state = last[b];
    path_b[T - 1] = state;
    for (int t = T - 2; t >= 0; --t) {
      state = bp_b[static_cast<long>(t) * C + state];
      path_b[t] = state;
    }
  }
}

__global__ void __launch_bounds__(1024)
viterbi_scan_fwd_kernel(const float* __restrict__ em,
                        const int* __restrict__ src_b,
                        const int* __restrict__ lab_b,
                        const float* __restrict__ w_b,
                        const float* __restrict__ start,
                        const int* __restrict__ lens,
                        int* __restrict__ slots,
                        float* __restrict__ final_alpha, int T, int C, int S,
                        int D, int P, int staged) {
  extern __shared__ float fsmem[];
  float* alpha = fsmem;
  float* nxt = fsmem + S;
  float* em_s = fsmem + 2 * S;
  const long DS = static_cast<long>(D) * S;
  const int* SRC = src_b;
  const int* LAB = lab_b;
  const float* W = w_b;
  if (staged) {
    int* src_s = reinterpret_cast<int*>(em_s + C);
    int* lab_s = src_s + DS;
    float* w_s = reinterpret_cast<float*>(lab_s + DS);
    for (long i = threadIdx.x; i < DS; i += blockDim.x) {
      src_s[i] = src_b[i];
      lab_s[i] = lab_b[i];
      w_s[i] = w_b[i];
    }
    SRC = src_s;
    LAB = lab_s;
    W = w_s;
  }
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) alpha[s] = start[s];
  const int len = lens[b];
  const int t_live = len < 0 ? 0 : (len < T ? len : T);
  const int groups = blockDim.x / P;
  const int lane_in_group = threadIdx.x & (P - 1);

  for (int t = 0; t < t_live; ++t) {
    const float* em_t = em + (static_cast<long>(b) * T + t) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) em_s[c] = em_t[c];
    __syncthreads();
    int* slot_t = slots + (static_cast<long>(b) * T + t) * S;
    for (int base = 0; base < S; base += groups) {
      const int s = base + threadIdx.x / P;
      float best = -INFINITY;
      int best_d = 0x7fffffff;
      if (s < S) {
        for (int d = lane_in_group; d < D; d += P) {
          const long k = static_cast<long>(d) * S + s;
          const float c = (alpha[SRC[k]] + W[k]) + em_s[LAB[k]];
          if (c > best) {
            best = c;
            best_d = d;
          }
        }
      }
      // merge the P lanes of a state: the larger value, then the lower slot
      for (int off = P >> 1; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(kFull, best, off);
        const int od = __shfl_xor_sync(kFull, best_d, off);
        if (ob > best || (ob == best && od < best_d)) {
          best = ob;
          best_d = od;
        }
      }
      if (s < S && lane_in_group == 0) {
        best = fmaxf(best, kNeg);
        nxt[s] = best;
        slot_t[s] = best > kNeg ? best_d : kDead;
      }
    }
    __syncthreads();
    float* tmp = alpha;
    alpha = nxt;
    nxt = tmp;
  }
  for (int t = t_live; t < T; ++t) {
    int* slot_t = slots + (static_cast<long>(b) * T + t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) slot_t[s] = kDead;
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    final_alpha[static_cast<long>(b) * S + s] = alpha[s];
}

__global__ void viterbi_backtrace_kernel(const int* __restrict__ slots,
                                         const float* __restrict__ final_alpha,
                                         const float* __restrict__ accept,
                                         const int* __restrict__ src_b,
                                         const int* __restrict__ lab_b,
                                         int* __restrict__ labels,
                                         float* __restrict__ score, int T,
                                         int S, int D, int staged) {
  extern __shared__ int ismem[];
  const int b = blockIdx.x;
  const long TS = static_cast<long>(T) * S;
  const long DS = static_cast<long>(D) * S;
  const int* SL = slots + static_cast<long>(b) * TS;
  const int* SRC = src_b;
  const int* LAB = lab_b;
  int* out = labels + static_cast<long>(b) * T;
  if (staged) {
    int* sl_s = ismem;
    int* src_s = sl_s + TS;
    int* lab_s = src_s + DS;
    for (long i = threadIdx.x; i < TS; i += blockDim.x) sl_s[i] = SL[i];
    for (long i = threadIdx.x; i < DS; i += blockDim.x) {
      src_s[i] = src_b[i];
      lab_s[i] = lab_b[i];
    }
    SL = sl_s;
    SRC = src_s;
    LAB = lab_s;
    out = lab_s + DS;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float* fa = final_alpha + static_cast<long>(b) * S;
    float best = fa[0] + accept[0];
    int state = 0;
    for (int s = 1; s < S; ++s) {
      const float v = fa[s] + accept[s];
      if (v > best) {
        best = v;
        state = s;
      }
    }
    score[b] = best;
    const bool feasible = best > kNeg / 2;
    for (int t = T - 1; t >= 0; --t) {
      const int d = SL[static_cast<long>(t) * S + state];
      int lab = -1;
      if (d < kDead) {
        const long k = static_cast<long>(d) * S + state;
        lab = LAB[k];
        state = SRC[k];
      }
      out[t] = feasible ? lab : -1;
    }
  }
  if (staged) {
    __syncthreads();
    int* dst = labels + static_cast<long>(b) * T;
    for (int t = threadIdx.x; t < T; t += blockDim.x) dst[t] = out[t];
  }
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

// bp [B, T-1, C], last [B] int32 -> path [B, T] int32, T >= 2.  Stages a
// sample's table and path in shared memory when ((T-1) * C + T) * 4 bytes
// fit in max_smem.
int dense_backtrace(const int* bp, const int* last, int* path, int B, int T,
                    int C, int max_smem, void* stream) {
  if (B == 0) return 0;
  const size_t smem =
      (static_cast<size_t>(T - 1) * C + static_cast<size_t>(T)) * sizeof(int);
  const int staged = smem <= static_cast<size_t>(max_smem) ? 1 : 0;
  const size_t launch_smem = staged ? smem : 0;
  if (launch_smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(launch_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dense_backtrace_kernel<<<B, kThreads, launch_smem,
                           static_cast<cudaStream_t>(stream)>>>(
      bp, last, path, T, C, staged);
  return static_cast<int>(cudaGetLastError());
}

// em [B, T, C] f32, the plan's src/label [D, S] i32 and weight [D, S] f32,
// start [S] f32, lens [B] i32 -> slots [B, T, S] i32 and final alpha
// [B, S] f32.  Labels must lie in [0, C).  Shared memory: (2 S + C) floats,
// plus 12 D S bytes for the tables when that fits in max_smem.
int viterbi_scan_fwd(const float* em, const int* src_b, const int* lab_b,
                     const float* w_b, const float* start, const int* lens,
                     int* slots, float* final_alpha, int B, int T, int C,
                     int S, int D, int max_smem, void* stream) {
  if (B == 0 || S == 0) return 0;
  int P = 1;
  while (P < 32 && 2 * P <= D && 2 * P * S <= 1024) P *= 2;
  int threads = ((S * P + 31) / 32) * 32;
  if (threads > 1024) threads = 1024;
  const size_t vec = (2 * static_cast<size_t>(S) + C) * sizeof(float);
  const size_t tab = 12 * static_cast<size_t>(D) * S;
  const int staged = vec + tab <= static_cast<size_t>(max_smem);
  const size_t smem = vec + (staged ? tab : 0);
  cudaError_t err = allow_smem(viterbi_scan_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  viterbi_scan_fwd_kernel<<<B, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      em, src_b, lab_b, w_b, start, lens, slots, final_alpha, T, C, S, D, P,
      staged);
  return static_cast<int>(cudaGetLastError());
}

// slots [B, T, S] i32, final alpha [B, S] f32, accept [S] f32, the plan's
// src/label [D, S] i32 -> labels [B, T] i32 and score [B] f32.  Stages the
// sample's slots, the tables and the labels in shared memory when
// (T S + 2 D S + T) * 4 bytes fit in max_smem.
int viterbi_backtrace(const int* slots, const float* final_alpha,
                      const float* accept, const int* src_b, const int* lab_b,
                      int* labels, float* score, int B, int T, int S, int D,
                      int max_smem, void* stream) {
  if (B == 0 || S == 0) return 0;
  const size_t smem = (static_cast<size_t>(T) * S +
                       2 * static_cast<size_t>(D) * S + T) * sizeof(int);
  const int staged = smem <= static_cast<size_t>(max_smem) ? 1 : 0;
  const size_t launch_smem = staged ? smem : 0;
  cudaError_t err = allow_smem(viterbi_backtrace_kernel, launch_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  viterbi_backtrace_kernel<<<B, kThreads, launch_smem,
                             static_cast<cudaStream_t>(stream)>>>(
      slots, final_alpha, accept, src_b, lab_b, labels, score, T, S, D,
      staged);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
