// Dense-adjacency lattice recursion (the STC / alignment-lattice scorer):
// the alpha trajectory and its reverse replay for the cotangents.
//
// Replaces gtn_applications_tpu/ops/dense_scan_pallas.py: _fwd_kernel (:90)
// and _bwd_kernel (:119), wrapped there by dense_scan (:159).
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

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
