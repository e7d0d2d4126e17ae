// Dense-adjacency lattice recursions: the plain one (the STC /
// alignment-lattice scorer) and the transition-factored one (the bigram
// Transducer), each as an alpha trajectory and its reverse replay for the
// cotangents.
//
// Replaces gtn_applications_tpu/ops/dense_scan_pallas.py: _fwd_kernel (:90)
// and _bwd_kernel (:119), wrapped there by dense_scan (:159); and
// _fact_fwd_kernel (:276) and _fact_bwd_kernel (:308), wrapped there by
// factored_scan (:360).  The factored pair is described above its kernels.
//
// States s, u = 0..S-1 of sample b; em/traj/dem are [B, T, S], adj/dadj
// [B, S, S] with adj[u, s] = sum over arcs s -> u of e^w.
//   forward:  t = 0: e = exp(min(start, 0)) * (start > NEG/2)
//             t > 0: sh = max(max(alpha), NEG), e = exp(alpha - sh)
//             z[u]  = sum_s adj[u, s] e[s]
//             alpha[u] = (z > 0 && lab[u]) ? em[t, u] + sh + log(max(z, 1e-37))
//                                          : NEG        (sh = 0 at t = 0)
//             frozen (alpha kept) where t >= len; frame 0 always applied.
//   backward: g = dL/dalpha[T-1]; for t = T-1 .. 0 on applied frames:
//             ga = (z > 0 && lab) ? g : 0;  dem[t] = ga;  dz = ga / max(z, floor)
//             dadj[u, s] += dz[u] e[s];  g[s] = (sum_u adj[u, s] dz[u]) e[s]
//             (frozen frames: dem = 0, g passes through).
// The floor is 1e-37 (the JAX kernels' and ops/factored.py's), not the CTC
// kernels' 1e-30.  Built without --use_fast_math.
//
// What bounds it on the H100: at the STC bench headline (B=32, T=250,
// S=96) the forward moves ~7 MB (under 2.2 us at 3.35 TB/s) and does
// ~150 MFLOP of fp32 matvec (~2.2 us at 67 TFLOP/s), but each frame needs
// the last: the chain of T frames, each a block-wide max, S expf, an S x S
// matvec, S logf and two block barriers, bounds it.  The TPU kernel ran
// time as a sequential grid with a VMEM carry; here one block per sample
// runs the time loop inside, alpha and e in shared memory.  The matvec is
// one warp per destination row u (lanes over s, coalesced and free of bank
// conflicts, then a shuffle reduction), and each warp's running max of the
// new alpha feeds the next frame's shift, which saves a reduction pass.
// The adjacency is staged in shared memory when S * S * 4 bytes fit (S up
// to ~235), else read from global memory, where one sample's rows stay
// L2-resident (32 x 370 KB at S = 304).  The backward keeps the same row
// mapping; each warp adds dz[u] e[s] to the rows it owns, so dadj has one
// writer per element and no atomics: in shared memory when it fits beside
// the adjacency, else in the dadj output itself.  The transposed product
// adj^T dz is one thread per column s (coalesced reads of row-major adj).
// Frames past a sample's length are a copy (forward) or zeros (backward).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kFloor = 1e-37f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ float start_e(float s) {
  return s > kNeg / 2 ? expf(fminf(s, 0.0f)) : 0.0f;
}

__device__ __forceinline__ float shift_of(const float* red, int nwarps) {
  float m = -INFINITY;
  for (int w = 0; w < nwarps; ++w) m = fmaxf(m, red[w]);
  return fmaxf(m, kNeg);
}

__device__ __forceinline__ float row_dot(const float* row, const float* e,
                                         int S, int lane) {
  float acc = 0.0f;
  for (int s = lane; s < S; s += 32) acc += row[s] * e[s];
  return warp_sum(acc);
}

__device__ __forceinline__ int live_steps(int len, int T) {
  return len < 1 ? 1 : (len < T ? len : T);
}

__global__ void __launch_bounds__(1024)
dense_scan_fwd_kernel(const float* __restrict__ em,
                      const float* __restrict__ adj,
                      const float* __restrict__ start,
                      const float* __restrict__ has_lab,
                      const int* __restrict__ lens,
                      float* __restrict__ traj, int T, int S,
                      int adj_in_smem) {
  extern __shared__ float smem[];
  float* alpha = smem;
  float* e = smem + S;
  float* lab = smem + 2 * S;
  float* red = smem + 3 * S;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long SS = static_cast<long>(S) * S;
  const float* A = adj + b * SS;
  if (adj_in_smem) {
    float* adj_s = red + kMaxWarps;
    for (long i = threadIdx.x; i < SS; i += blockDim.x) adj_s[i] = A[i];
    A = adj_s;
  }
  const long base = static_cast<long>(b) * T * S;
  const float* em_b = em + base;
  float* tr_b = traj + base;
  const int t_live = live_steps(lens[b], T);

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    e[s] = start_e(start[static_cast<long>(b) * S + s]);
    lab[s] = has_lab[static_cast<long>(b) * S + s];
  }
  __syncthreads();

  // frame 0, entered from the start potentials
  float wmax = -INFINITY;
  for (int u = warp; u < S; u += nwarps) {
    const float z = row_dot(A + static_cast<long>(u) * S, e, S, lane);
    const float v = (z > 0.0f && lab[u] > 0.0f)
                        ? em_b[u] + logf(fmaxf(z, kFloor)) : kNeg;
    if (lane == 0) {
      alpha[u] = v;
      tr_b[u] = v;
    }
    wmax = fmaxf(wmax, v);
  }
  if (lane == 0) red[warp] = wmax;
  __syncthreads();

  for (int t = 1; t < t_live; ++t) {
    const float sh = shift_of(red, nwarps);
    for (int s = threadIdx.x; s < S; s += blockDim.x) e[s] = expf(alpha[s] - sh);
    __syncthreads();
    const float* em_t = em_b + static_cast<long>(t) * S;
    float* tr_t = tr_b + static_cast<long>(t) * S;
    wmax = -INFINITY;
    for (int u = warp; u < S; u += nwarps) {
      const float z = row_dot(A + static_cast<long>(u) * S, e, S, lane);
      const float v = (z > 0.0f && lab[u] > 0.0f)
                          ? em_t[u] + sh + logf(fmaxf(z, kFloor)) : kNeg;
      if (lane == 0) {
        alpha[u] = v;
        tr_t[u] = v;
      }
      wmax = fmaxf(wmax, v);
    }
    if (lane == 0) red[warp] = wmax;
    __syncthreads();
  }
  // frozen tail: alpha keeps its value at t = len - 1
  for (int t = t_live; t < T; ++t) {
    float* tr_t = tr_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) tr_t[s] = alpha[s];
  }
}

__global__ void __launch_bounds__(1024)
dense_scan_bwd_kernel(const float* __restrict__ traj,
                      const float* __restrict__ adj,
                      const float* __restrict__ start,
                      const float* __restrict__ has_lab,
                      const int* __restrict__ lens,
                      const float* __restrict__ g_final,
                      float* __restrict__ dem, float* __restrict__ dadj,
                      int T, int S, int adj_in_smem, int acc_in_smem) {
  extern __shared__ float smem[];
  float* prev = smem;
  float* e = smem + S;
  float* g = smem + 2 * S;
  float* dz = smem + 3 * S;
  float* lab = smem + 4 * S;
  float* red = smem + 5 * S;
  float* extra = red + kMaxWarps;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long SS = static_cast<long>(S) * S;
  const float* A = adj + b * SS;
  if (adj_in_smem) {
    for (long i = threadIdx.x; i < SS; i += blockDim.x) extra[i] = A[i];
    A = extra;
    extra += SS;
  }
  float* D = nullptr;
  if (dadj != nullptr) {
    D = acc_in_smem ? extra : dadj + b * SS;
    for (long i = threadIdx.x; i < SS; i += blockDim.x) D[i] = 0.0f;
  }
  const long base = static_cast<long>(b) * T * S;
  const float* tr_b = traj + base;
  float* dem_b = dem + base;
  const int t_live = live_steps(lens[b], T);

  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    g[s] = g_final[static_cast<long>(b) * S + s];
    lab[s] = has_lab[static_cast<long>(b) * S + s];
  }
  for (int t = t_live; t < T; ++t) {
    float* dem_t = dem_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) dem_t[s] = 0.0f;
  }

  for (int t = t_live - 1; t >= 0; --t) {
    // the exp-domain input of frame t: the previous alpha, or the start row
    if (t > 0) {
      const float* tr_p = tr_b + static_cast<long>(t - 1) * S;
      float m = -INFINITY;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        const float v = tr_p[s];
        prev[s] = v;
        m = fmaxf(m, v);
      }
      m = warp_max(m);
      if (lane == 0) red[warp] = m;
    }
    __syncthreads();
    if (t > 0) {
      const float sh = shift_of(red, nwarps);
      for (int s = threadIdx.x; s < S; s += blockDim.x) e[s] = expf(prev[s] - sh);
    } else {
      for (int s = threadIdx.x; s < S; s += blockDim.x)
        e[s] = start_e(start[static_cast<long>(b) * S + s]);
    }
    __syncthreads();
    float* dem_t = dem_b + static_cast<long>(t) * S;
    for (int u = warp; u < S; u += nwarps) {
      const float z = row_dot(A + static_cast<long>(u) * S, e, S, lane);
      const float ga = (z > 0.0f && lab[u] > 0.0f) ? g[u] : 0.0f;
      const float dzu = ga / fmaxf(z, kFloor);
      if (lane == 0) {
        dem_t[u] = ga;
        dz[u] = dzu;
      }
      if (D != nullptr) {
        float* drow = D + static_cast<long>(u) * S;
        for (int s = lane; s < S; s += 32) drow[s] += dzu * e[s];
      }
    }
    __syncthreads();
    if (t > 0) {
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        float c = 0.0f;
        for (int u = 0; u < S; ++u) c += A[static_cast<long>(u) * S + s] * dz[u];
        g[s] = c * e[s];
      }
    }
  }
  if (D != nullptr && acc_in_smem) {
    __syncthreads();
    float* out = dadj + b * SS;
    for (long i = threadIdx.x; i < SS; i += blockDim.x) out[i] = D[i];
  }
}

// ---------------------------------------------------------------------------
// Transition-factored recursion.  Each state u has one in-label l_u (or
// none); wsel[s, l] = W[l_s, l] carries the bigram weight of entering label
// l from state s.  The TPU kernel computes, every frame, the full
//   v[s, l] = alpha[s] + wsel[s, l],  sh[l] = max(max_s v[s, l], NEG)
//   z[u, l] = sum_s adj[u, s] exp(v[s, l] - sh[l])     ([S, S] x [S, N])
//   alpha[u] = has[u] ? em[t, u] + (z[u, l_u] > 0 ? sh + log(max(z, 1e-37))
//                                                 : NEG) : NEG
// and keeps only column l_u of row u.  Here only the labels that some state
// enters with are computed: the block compacts them to slots j = 0..Lu-1
// (label_of[j]; jslot[u] is u's slot, -1 for none), stages adj and the
// columns WT[j][s] = wsel[s, label_of[j]], and per frame computes sh[j] and
// E[j][s] = exp(v - sh) (a warp per slot), then z[u] = adj[u, :] . E[j_u, :]
// (a warp per row): O(S^2 + Lu S) a frame instead of O(S^2 N), 80x less at
// N = 80.  Frame 0 enters from exp(min(start, 0)) (start > NEG/2) and adds
// ws[u]: alpha = (z > 0 && has) ? (em + ws) + log(max(z, 1e-37)) : NEG.
// Frames t >= len keep alpha; frame 0 is always applied.
//
// The backward replays the trajectory.  dm = ga lab is nonzero only at
// l = l_u, so dz has one entry a row: with ga = has ? g : 0 (dem[t] = ga)
// and dz[u] = z > 0 ? ga / max(z, floor) : 0,
//   dadj[u, s] += dz[u] E[j_u][s]
//   dv[j][s]    = E[j][s] sum_{u : j_u = j} adj[u, s] dz[u]  (dwsel column)
//   g[s]        = sum_j dv[j][s]
// (a thread per (j, s) pair over the members of slot j, then a thread per
// s), and frame 0 gives dws = dem[0] = (z1 > 0 && has) ? g : 0 and
// dadj += dz1 e^T.  dwsel is written whole, zero in the unused columns.
//
// What bounds them on the H100: at the IAM width (B=32, T=250, S=136, ~45
// labels) the forward reads ~9 MB (under 3 us at 3.35 TB/s) and does
// ~2 (S^2 + Lu S) flops a live frame (~0.5 GFLOP in all, ~7 us at
// 67 TFLOP/s); but each frame needs the last, so the chain of T frames,
// each two block barriers, a warp max and S exps, an S x S product split
// across warps and S logs, bounds it.  As for the plain pair, one block per
// sample runs the time loop inside; adj, WT and E (and the backward's dwsel
// accumulator) sit in shared memory when they fit with Lu bounded by
// min(S, N) (S up to ~140 at N = 80), else in a global scratch the wrapper
// allocates; dadj accumulates in shared memory when it also fits, else in
// its output.

__device__ int compact_labels(const int* __restrict__ lab_idx, int S, int N,
                              int* slot_of, int* label_of, int* jslot,
                              int* nlab) {
  for (int l = threadIdx.x; l < N; l += blockDim.x) slot_of[l] = -1;
  __syncthreads();
  if (threadIdx.x == 0) {
    int n = 0;
    for (int u = 0; u < S; ++u) {
      const int l = lab_idx[u];
      int j = -1;
      if (l >= 0) {
        j = slot_of[l];
        if (j < 0) {
          j = n++;
          slot_of[l] = j;
          label_of[j] = l;
        }
      }
      jslot[u] = j;
    }
    *nlab = n;
  }
  __syncthreads();
  return *nlab;
}

// per slot j < Lu (a warp each): E[j][s] = exp(v - sh), v = src[s] + WT[j][s],
// sh = max(max_s v, NEG); sh[j] is kept when sh_out is given
__device__ __forceinline__ void slot_exps(const float* src, const float* WT,
                                          float* E, float* sh_out, int Lu,
                                          int S, int warp, int nwarps,
                                          int lane) {
  for (int j = warp; j < Lu; j += nwarps) {
    const float* w = WT + static_cast<long>(j) * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, src[s] + w[s]);
    m = fmaxf(warp_max(m), kNeg);
    float* e = E + static_cast<long>(j) * S;
    for (int s = lane; s < S; s += 32) e[s] = expf((src[s] + w[s]) - m);
    if (sh_out != nullptr && lane == 0) sh_out[j] = m;
  }
}

__global__ void __launch_bounds__(1024)
factored_scan_fwd_kernel(const float* __restrict__ em,
                         const float* __restrict__ adj,
                         const float* __restrict__ wsel,
                         const int* __restrict__ lab_idx,
                         const float* __restrict__ ws,
                         const float* __restrict__ start,
                         const int* __restrict__ lens,
                         float* __restrict__ traj, float* __restrict__ scratch,
                         int T, int S, int N, int Lmax, int mats_in_smem) {
  extern __shared__ float smem[];
  int* slot_of = reinterpret_cast<int*>(smem);
  int* label_of = slot_of + N;
  int* jslot = label_of + Lmax;
  int* nlab = jslot + S;
  float* alpha = reinterpret_cast<float*>(nlab + 1);
  float* vec = alpha + S;
  float* sh = vec + S;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long SS = static_cast<long>(S) * S;
  const long LS = static_cast<long>(Lmax) * S;
  float* A = mats_in_smem ? sh + Lmax : scratch + b * (SS + 2 * LS);
  float* WT = A + SS;
  float* E = WT + LS;

  const float* adj_b = adj + b * SS;
  for (long i = threadIdx.x; i < SS; i += blockDim.x) A[i] = adj_b[i];
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    vec[s] = start_e(start[static_cast<long>(b) * S + s]);
  const int Lu = compact_labels(lab_idx + static_cast<long>(b) * S, S, N,
                                slot_of, label_of, jslot, nlab);
  const float* wsel_b = wsel + static_cast<long>(b) * S * N;
  for (long i = threadIdx.x; i < static_cast<long>(Lu) * S; i += blockDim.x) {
    const long j = i / S;
    WT[i] = wsel_b[(i - j * S) * N + label_of[j]];
  }
  __syncthreads();

  const long base = static_cast<long>(b) * T * S;
  const float* em_b = em + base;
  float* tr_b = traj + base;
  // frame 0, entered from the start potentials, paying ws
  for (int u = warp; u < S; u += nwarps) {
    const float z = row_dot(A + static_cast<long>(u) * S, vec, S, lane);
    if (lane == 0) {
      const float v = (z > 0.0f && jslot[u] >= 0)
          ? (em_b[u] + ws[static_cast<long>(b) * S + u]) + logf(fmaxf(z, kFloor))
          : kNeg;
      alpha[u] = v;
      tr_b[u] = v;
    }
  }
  __syncthreads();

  const int t_live = live_steps(lens[b], T);
  for (int t = 1; t < t_live; ++t) {
    slot_exps(alpha, WT, E, sh, Lu, S, warp, nwarps, lane);
    __syncthreads();
    const float* em_t = em_b + static_cast<long>(t) * S;
    float* tr_t = tr_b + static_cast<long>(t) * S;
    for (int u = warp; u < S; u += nwarps) {
      const int j = jslot[u];
      float v = kNeg;
      if (j >= 0) {
        const float z = row_dot(A + static_cast<long>(u) * S,
                                E + static_cast<long>(j) * S, S, lane);
        v = em_t[u] + (z > 0.0f ? sh[j] + logf(fmaxf(z, kFloor)) : kNeg);
      }
      if (lane == 0) {
        alpha[u] = v;
        tr_t[u] = v;
      }
    }
    __syncthreads();
  }
  for (int t = t_live; t < T; ++t) {
    float* tr_t = tr_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) tr_t[s] = alpha[s];
  }
}

__global__ void __launch_bounds__(1024)
factored_scan_bwd_kernel(const float* __restrict__ traj,
                         const float* __restrict__ adj,
                         const float* __restrict__ wsel,
                         const int* __restrict__ lab_idx,
                         const float* __restrict__ start,
                         const int* __restrict__ lens,
                         const float* __restrict__ g_final,
                         float* __restrict__ dem, float* __restrict__ dadj,
                         float* __restrict__ dwsel, float* __restrict__ dws,
                         float* __restrict__ scratch, int T, int S, int N,
                         int Lmax, int mats_in_smem, int acc_in_smem) {
  extern __shared__ float smem[];
  int* slot_of = reinterpret_cast<int*>(smem);
  int* label_of = slot_of + N;
  int* jslot = label_of + Lmax;
  int* nlab = jslot + S;
  int* mem_ptr = nlab + 1;          // Lmax + 1: CSR of each slot's states
  int* cursor = mem_ptr + Lmax + 1;  // Lmax
  int* mem_idx = cursor + Lmax;      // S
  float* prev = reinterpret_cast<float*>(mem_idx + S);
  float* g = prev + S;
  float* dz = g + S;
  float* vec = dz + S;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const long SS = static_cast<long>(S) * S;
  const long LS = static_cast<long>(Lmax) * S;
  float* A = mats_in_smem ? vec + S : scratch + b * (SS + 3 * LS);
  float* WT = A + SS;
  float* E = WT + LS;
  float* DW = E + LS;
  float* D = nullptr;
  if (dadj != nullptr) D = acc_in_smem ? DW + LS : dadj + b * SS;

  const float* adj_b = adj + b * SS;
  for (long i = threadIdx.x; i < SS; i += blockDim.x) {
    A[i] = adj_b[i];
    if (D != nullptr) D[i] = 0.0f;
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    g[s] = g_final[static_cast<long>(b) * S + s];
  const int Lu = compact_labels(lab_idx + static_cast<long>(b) * S, S, N,
                                slot_of, label_of, jslot, nlab);
  if (threadIdx.x == 0) {
    for (int j = 0; j <= Lu; ++j) mem_ptr[j] = 0;
    for (int u = 0; u < S; ++u)
      if (jslot[u] >= 0) ++mem_ptr[jslot[u] + 1];
    for (int j = 0; j < Lu; ++j) {
      mem_ptr[j + 1] += mem_ptr[j];
      cursor[j] = mem_ptr[j];
    }
    for (int u = 0; u < S; ++u)
      if (jslot[u] >= 0) mem_idx[cursor[jslot[u]]++] = u;
  }
  const float* wsel_b = wsel + static_cast<long>(b) * S * N;
  for (long i = threadIdx.x; i < static_cast<long>(Lu) * S; i += blockDim.x) {
    const long j = i / S;
    WT[i] = wsel_b[(i - j * S) * N + label_of[j]];
    DW[i] = 0.0f;
  }
  const long base = static_cast<long>(b) * T * S;
  const float* tr_b = traj + base;
  float* dem_b = dem + base;
  const int t_live = live_steps(lens[b], T);
  for (int t = t_live; t < T; ++t) {
    float* dem_t = dem_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) dem_t[s] = 0.0f;
  }

  for (int t = t_live - 1; t >= 1; --t) {
    const float* tr_p = tr_b + static_cast<long>(t - 1) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) prev[s] = tr_p[s];
    __syncthreads();
    slot_exps(prev, WT, E, nullptr, Lu, S, warp, nwarps, lane);
    __syncthreads();
    float* dem_t = dem_b + static_cast<long>(t) * S;
    for (int u = warp; u < S; u += nwarps) {
      const int j = jslot[u];
      const float ga = j >= 0 ? g[u] : 0.0f;
      float dzu = 0.0f;
      if (j >= 0) {
        const float* e = E + static_cast<long>(j) * S;
        const float z = row_dot(A + static_cast<long>(u) * S, e, S, lane);
        dzu = z > 0.0f ? ga / fmaxf(z, kFloor) : 0.0f;
        if (D != nullptr) {
          float* drow = D + static_cast<long>(u) * S;
          for (int s = lane; s < S; s += 32) drow[s] += dzu * e[s];
        }
      }
      if (lane == 0) {
        dem_t[u] = ga;
        dz[u] = dzu;
      }
    }
    __syncthreads();
    // dv[j][s] overwrites E[j][s]; it accumulates into dwsel's column
    for (long p = threadIdx.x; p < static_cast<long>(Lu) * S; p += blockDim.x) {
      const int j = static_cast<int>(p / S);
      const long s = p - static_cast<long>(j) * S;
      float c = 0.0f;
      for (int k = mem_ptr[j]; k < mem_ptr[j + 1]; ++k) {
        const int u = mem_idx[k];
        c += A[static_cast<long>(u) * S + s] * dz[u];
      }
      const float dv = E[p] * c;
      E[p] = dv;
      DW[p] += dv;
    }
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float gp = 0.0f;
      for (int j = 0; j < Lu; ++j) gp += E[static_cast<long>(j) * S + s];
      g[s] = gp;
    }
  }
  // frame 0: entered from the start potentials
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    vec[s] = start_e(start[static_cast<long>(b) * S + s]);
  __syncthreads();
  for (int u = warp; u < S; u += nwarps) {
    const float z = row_dot(A + static_cast<long>(u) * S, vec, S, lane);
    const float ga = (z > 0.0f && jslot[u] >= 0) ? g[u] : 0.0f;
    const float dzu = ga / fmaxf(z, kFloor);
    if (lane == 0) {
      dem_b[u] = ga;
      dws[static_cast<long>(b) * S + u] = ga;
    }
    if (D != nullptr) {
      float* drow = D + static_cast<long>(u) * S;
      for (int s = lane; s < S; s += 32) drow[s] += dzu * vec[s];
    }
  }
  __syncthreads();
  float* dw_b = dwsel + static_cast<long>(b) * S * N;
  for (long i = threadIdx.x; i < static_cast<long>(S) * N; i += blockDim.x) {
    const long s = i / N;
    const int j = slot_of[i - s * N];
    dw_b[i] = j >= 0 ? DW[static_cast<long>(j) * S + s] : 0.0f;
  }
  if (D != nullptr && acc_in_smem) {
    float* out = dadj + b * SS;
    for (long i = threadIdx.x; i < SS; i += blockDim.x) out[i] = D[i];
  }
}

int threads_for(int S) {
  const int warps = S < kMaxWarps ? (S < 1 ? 1 : S) : kMaxWarps;
  return 32 * warps;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Shared-memory bytes of the factored kernels: their vectors, plus (when
// mats_in_smem) adj, the label columns and E, plus the backward's dwsel
// accumulator; Lmax = min(S, N) bounds the number of distinct labels.
size_t fact_smem(int S, int N, int Lmax, int backward, int mats_in_smem) {
  const size_t s = S, l = Lmax;
  const size_t ints = backward ? N + 3 * l + 2 * s + 2 : N + l + s + 1;
  const size_t vecs = backward ? 4 * s : 2 * s + l;
  const size_t mats = mats_in_smem ? s * s + (backward ? 3 : 2) * l * s : 0;
  return (ints + vecs + mats) * sizeof(float);
}

}  // namespace

extern "C" {

// em [B, T, S], adj [B, S, S], start/has_lab [B, S] f32, lens [B] i32
// -> traj [B, T, S] f32.  Shared memory: (3 S + 32) floats, plus S * S
// when that fits in max_smem.
int dense_scan_fwd(const float* em, const float* adj, const float* start,
                   const float* has_lab, const int* lens, float* traj, int B,
                   int T, int S, int max_smem, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const size_t vec = (3 * static_cast<size_t>(S) + kMaxWarps) * sizeof(float);
  const size_t mat = static_cast<size_t>(S) * S * sizeof(float);
  const int adj_in_smem = vec + mat <= static_cast<size_t>(max_smem);
  const size_t smem = vec + (adj_in_smem ? mat : 0);
  cudaError_t err =
      allow_smem(dense_scan_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_scan_fwd_kernel<<<B, threads_for(S), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      em, adj, start, has_lab, lens, traj, T, S, adj_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// traj [B, T, S], adj [B, S, S], start/has_lab/g_final [B, S] f32, lens [B]
// i32 -> dem [B, T, S] and, unless dadj is null, dadj [B, S, S] f32.
// Shared memory: (5 S + 32) floats, plus S * S for the adjacency and S * S
// for the dadj accumulator, each while it still fits in max_smem.
int dense_scan_bwd(const float* traj, const float* adj, const float* start,
                   const float* has_lab, const int* lens, const float* g_final,
                   float* dem, float* dadj, int B, int T, int S, int max_smem,
                   void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const size_t vec = (5 * static_cast<size_t>(S) + kMaxWarps) * sizeof(float);
  const size_t mat = static_cast<size_t>(S) * S * sizeof(float);
  size_t smem = vec;
  const int adj_in_smem = smem + mat <= static_cast<size_t>(max_smem);
  if (adj_in_smem) smem += mat;
  const int acc_in_smem =
      dadj != nullptr && smem + mat <= static_cast<size_t>(max_smem);
  if (acc_in_smem) smem += mat;
  cudaError_t err =
      allow_smem(dense_scan_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_scan_bwd_kernel<<<B, threads_for(S), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      traj, adj, start, has_lab, lens, g_final, dem, dadj, T, S, adj_in_smem,
      acc_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// em [B, T, S], adj [B, S, S], wsel [B, S, N], ws/start [B, S] f32,
// lab_idx [B, S] i32 (each state's in-label in [0, N), -1 for none), lens
// [B] i32 -> traj [B, T, S] f32.  Lmax = min(S, N).  scratch holds
// B (S^2 + 2 Lmax S) floats when mats_in_smem is 0, else may be null.
int factored_scan_fwd(const float* em, const float* adj, const float* wsel,
                      const int* lab_idx, const float* ws, const float* start,
                      const int* lens, float* traj, float* scratch, int B,
                      int T, int S, int N, int mats_in_smem, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const int Lmax = S < N ? S : N;
  const size_t smem = fact_smem(S, N, Lmax, 0, mats_in_smem);
  cudaError_t err = allow_smem(factored_scan_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factored_scan_fwd_kernel<<<B, threads_for(S), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      em, adj, wsel, lab_idx, ws, start, lens, traj, scratch, T, S, N, Lmax,
      mats_in_smem);
  return static_cast<int>(cudaGetLastError());
}

// traj [B, T, S], adj [B, S, S], wsel [B, S, N], start/g_final [B, S] f32,
// lab_idx [B, S] i32, lens [B] i32 -> dem [B, T, S], dwsel [B, S, N], dws
// [B, S] and, unless dadj is null, dadj [B, S, S] f32.  scratch holds
// B (S^2 + 3 Lmax S) floats when mats_in_smem is 0.  dadj accumulates in
// shared memory when S^2 more floats fit in max_smem.
int factored_scan_bwd(const float* traj, const float* adj, const float* wsel,
                      const int* lab_idx, const float* start, const int* lens,
                      const float* g_final, float* dem, float* dadj,
                      float* dwsel, float* dws, float* scratch, int B, int T,
                      int S, int N, int mats_in_smem, int max_smem,
                      void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const int Lmax = S < N ? S : N;
  size_t smem = fact_smem(S, N, Lmax, 1, mats_in_smem);
  const size_t mat = static_cast<size_t>(S) * S * sizeof(float);
  const int acc_in_smem = dadj != nullptr && mats_in_smem &&
                          smem + mat <= static_cast<size_t>(max_smem);
  if (acc_in_smem) smem += mat;
  cudaError_t err = allow_smem(factored_scan_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factored_scan_bwd_kernel<<<B, threads_for(S), smem,
                             static_cast<cudaStream_t>(stream)>>>(
      traj, adj, wsel, lab_idx, start, lens, g_final, dem, dadj, dwsel, dws,
      scratch, T, S, N, Lmax, mats_in_smem, acc_in_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
