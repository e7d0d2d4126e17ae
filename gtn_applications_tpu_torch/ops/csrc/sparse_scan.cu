// Sparse-arc lattice recursions over compiled WFST arc tables: one step
// (seg_lse) and the whole scan with its epsilon closure, each with the
// reverse replay for the cotangents; and the tropical step with its
// backpointers (seg_max) that the per-frame Viterbi decode runs.
//
// Replaces gtn_applications_tpu/ops/seglse_pallas.py: _fwd_kernel (:69) and
// _bwd_kernel (:97), wrapped there by seg_lse (:139);
// gtn_applications_tpu/ops/sparse_scan_pallas.py: _fwd_kernel (:265) and
// _bwd_kernel (:312), wrapped there by sparse_scan (:450); and
// gtn_applications_tpu/ops/segmax_pallas.py: _kernel (:41), wrapped there by
// seg_max (:80).  seg_max is described above its kernel, below.
//
// One step, for each destination state s of sample b:
//   c[a]   = (alpha[src[a]] + w[a]) + em[a]          (NEG where src < 0)
//   m      = max(max over arcs a into s of c[a], NEG)
//   z      = sum over those arcs with c[a] > DEAD of exp(c[a] - m)
//   new[s] = z > 0 ? m + log(max(z, 1e-30)) : NEG
// and its VJP dc[a] = (c > DEAD && z > 0) ? exp(c - m) / z g[s] : 0 (the
// posterior from the destination's own shift, recomputed), dalpha[u] = sum
// over arcs from u of dc.  The whole scan runs that
// step each frame with em[a] = em[b, t, label[a]], then eps_depth rounds of
// the epsilon closure (cur_d = step(cur_{d-1}) over the epsilon arcs, acc_d
// = logaddexp(acc_{d-1}, cur_d), dead inputs masked), and keeps alpha past
// a sample's length.  After each live frame the kernel subtracts the frame's
// largest alpha (0 if every state is dead) and adds it to the sample's
// running shift: the trajectory holds alpha relative to shift[b, t], so the
// values the posteriors compare stay small (at alpha ~ 700, one fp32 ulp is
// 6e-5, and exp(c - y) between two summation orders would differ by that),
// and the shift, which the gradient does not depend on, carries the rest.
// Its backward recomputes each live frame's chain from
// the saved trajectory and runs it in reverse (the closure's logaddexp,
// then each epsilon step's VJP, then the arc step's), writing dem [B, T, C]
// by label, and accumulating dw [B, A] and deps [B, E] per sample.
//
// The TPU kernels recast the segment reductions as one-hot matmuls for the
// MXU and shift each row by its largest contribution.  Here the arcs are
// sorted by destination on the host (ops/seglse_pallas.py arc_index), and
// one warp reduces one destination: lanes stride over its in-arcs, a
// max pass and a sum pass with warp shuffles, so every destination gets its
// own shift (the plain forward_score's arithmetic) and a destination with a
// thousand in-arcs (the unigram backoff state of a 1k-wordpiece LM) costs
// ~32 steps a lane.  The backward's sums by source and by label walk the
// same kind of index (one warp a row), so there are no atomics and the
// results are deterministic.  One block per sample runs the time loop, its
// states in shared memory (the backward's float64 state, where it does not
// fit, in a global scratch slice per sample: 250 KB at S = 1,058 and closure
// depth 4, L2-resident); the arc tables are staged there too when they fit
// (the 1k-wordpiece normaliser's forward), else read from global memory
// (L2-resident: ~130 KB for a shared table).
//
// What bounds it on the H100: per frame a sample does ~10 fp32 operations
// an arc and ~15 an epsilon arc per closure round, a few MFLOP a frame at
// the 1k-wordpiece normaliser, microseconds at 67 TFLOP/s; the bytes
// (em rows, tables, trajectory) are a few MB.  The kernels instead wait on
// the chain of T frames, each a handful of block barriers (one per arc step
// and closure round) and, per warp, a few dependent shuffle reductions per
// destination.  Built without --use_fast_math: exact expf/logf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kDead = -1e28f;
constexpr float kFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 512;
constexpr int kStepThreads = 256;

// exp, log and max of float (the f-suffixed calls) and of double
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }
__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double vmax(double a, double b) { return fmax(a, b); }

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename V>
__device__ __forceinline__ V warp_max(V v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = vmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// log(exp(a) + exp(b)) with dead inputs weighing 0 (semiring.logaddexp)
template <typename V>
__device__ __forceinline__ V lae(V a, V b) {
  const V m = vmax(vmax(a, b), V(kNeg));
  const V s = (a > V(kDead) ? ex(a - m) : V(0)) + (b > V(kDead) ? ex(b - m) : V(0));
  return s > V(0) ? m + lg(vmax(s, V(kFloor))) : V(kNeg);
}

// One destination's logsumexp: its shift m and sum z; value m + log z.
template <typename V>
struct Seg {
  V m, z;
  __device__ V value() const { return z > V(0) ? m + lg(vmax(z, V(kFloor))) : V(kNeg); }
};

// The Seg of value(k) over k in [beg, end), by one warp (in every lane),
// in the type value returns.
template <typename F>
__device__ __forceinline__ auto warp_seg(int beg, int end, int lane, F value)
    -> Seg<decltype(value(0))> {
  using V = decltype(value(0));
  V m = V(-INFINITY);
  for (int k = beg + lane; k < end; k += 32) m = vmax(m, value(k));
  m = vmax(warp_max(m), V(kNeg));
  V z = V(0);
  for (int k = beg + lane; k < end; k += 32) {
    const V v = value(k);
    if (v > V(kDead)) z += ex(v - m);
  }
  return Seg<V>{m, warp_sum(z)};
}

// The sum, in Acc, of vals[order[j]] over j in [ptr[row], ptr[row + 1]),
// by one warp.
template <typename Acc, typename T>
__device__ __forceinline__ Acc warp_csr_sum(const int* ptr, const int* order,
                                            const T* vals, int row, int lane) {
  Acc s = Acc(0);
  for (int j = ptr[row] + lane; j < ptr[row + 1]; j += 32) s += Acc(vals[order[j]]);
  return warp_sum(s);
}

// The posterior of one contribution c into a destination of shift and sum
// sg, times the destination's cotangent g: exp(c - m) / z, formed from the
// destination's own shift (as autodiff of the plain version forms it), so
// the result is as precise as z, whatever the size of m.
template <typename V>
__device__ __forceinline__ V posterior(V c, Seg<V> sg, V g) {
  return (c > V(kDead) && sg.z > V(0)) ? ex(c - sg.m) / sg.z * g : V(0);
}

// A carve of shared memory (or of a global scratch slice), 4-byte words;
// staged copies of global arrays.
struct Carve {
  float* p;
  // doubles: carved first, from the (8-byte aligned) start
  __device__ double* doubles(long n) {
    double* r = reinterpret_cast<double*>(p);
    p += 2 * n;
    return r;
  }
  __device__ float* floats(long n) { float* r = p; p += n; return r; }
  __device__ int* ints(long n) { int* r = reinterpret_cast<int*>(p); p += n; return r; }
};

template <typename T>
__device__ const T* stage(const T* src, long n, T* dst) {
  for (long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  return dst;
}

// One sample's tables: the arcs sorted by destination (dptr delimits each
// destination's arcs), their sources, labels and weights, and for the
// backward the source and label groups.
struct Arcs {
  const int* dptr;
  const int* src;
  const int* label;
  const float* w;
  const int* sptr;
  const int* sorder;
  const int* lptr;
  const int* lorder;
};

__device__ Arcs sample_arcs(const int* dptr, const int* src, const int* label,
                            const float* w, const int* sptr, const int* sorder,
                            const int* lptr, const int* lorder, int b, int S, int A,
                            int C, int sb, int wb) {
  const long so = sb ? static_cast<long>(b) : 0;
  Arcs r;
  r.dptr = dptr + so * (S + 1);
  r.src = src + so * A;
  r.label = label ? label + so * A : nullptr;
  r.w = w + (wb ? static_cast<long>(b) * A : 0);
  r.sptr = sptr ? sptr + so * (S + 1) : nullptr;
  r.sorder = sorder ? sorder + so * A : nullptr;
  r.lptr = lptr ? lptr + so * (C + 1) : nullptr;
  r.lorder = lorder ? lorder + so * A : nullptr;
  return r;
}

// Stage the tables the kernel reads into shared memory (backward: with the
// source and label groups).
__device__ void stage_arcs(Arcs& r, Carve& cv, int S, int A, int C, bool backward,
                           bool labels) {
  r.dptr = stage(r.dptr, S + 1, cv.ints(S + 1));
  r.src = stage(r.src, A, cv.ints(A));
  if (labels) r.label = stage(r.label, A, cv.ints(A));
  r.w = stage(r.w, A, cv.floats(A));
  if (backward) {
    r.sptr = stage(r.sptr, S + 1, cv.ints(S + 1));
    r.sorder = stage(r.sorder, A, cv.ints(A));
    if (labels) {
      r.lptr = stage(r.lptr, C + 1, cv.ints(C + 1));
      r.lorder = stage(r.lorder, A, cv.ints(A));
    }
  }
}

// An arc's contribution (alpha[src] + w) + em[label], in alpha's type.
template <typename V>
__device__ __forceinline__ V arc_value(const Arcs& r, const V* alpha, const float* em_row,
                                       int C, int k) {
  const int s = r.src[k];
  const int l = r.label[k];
  const V a = s >= 0 ? alpha[s] : V(kNeg);
  return (a + V(r.w[k])) + ((l >= 0 && l < C) ? V(em_row[l]) : V(0));
}

template <typename V>
__device__ __forceinline__ V eps_value(const Arcs& e, const V* cur, int k) {
  const int s = e.src[k];
  return (s >= 0 ? cur[s] : V(kNeg)) + V(e.w[k]);
}

// ---------------------------------------------------------------------------
// seg_lse: one step with per-arc emissions em[a]
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kStepThreads)
seg_lse_fwd_kernel(const float* __restrict__ alpha, const int* __restrict__ dptr,
                   const int* __restrict__ src, const float* __restrict__ w,
                   const float* __restrict__ em, float* __restrict__ out,
                   int S, int A, int sb, int wb, int eb) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* al = stage(alpha + static_cast<long>(b) * S, S, smem);
  const long so = sb ? static_cast<long>(b) : 0;
  const int* D = dptr + so * (S + 1);
  const int* Sr = src + so * A;
  const float* W = w + (wb ? static_cast<long>(b) * A : 0);
  const float* M = em + (eb ? static_cast<long>(b) * A : 0);
  __syncthreads();
  for (int s = warp; s < S; s += nwarps) {
    const float v = warp_seg(D[s], D[s + 1], lane, [&](int k) {
      const int u = Sr[k];
      return ((u >= 0 ? al[u] : kNeg) + W[k]) + M[k];
    }).value();
    if (lane == 0) out[static_cast<long>(b) * S + s] = v;
  }
}

__global__ void __launch_bounds__(kStepThreads)
seg_lse_bwd_kernel(const float* __restrict__ alpha,
                   const float* __restrict__ g, const int* __restrict__ dptr,
                   const int* __restrict__ src, const float* __restrict__ w,
                   const float* __restrict__ em, const int* __restrict__ sptr,
                   const int* __restrict__ sorder, float* __restrict__ dalpha,
                   float* __restrict__ dcontrib, int S, int A, int sb, int wb, int eb) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const float* al = stage(alpha + static_cast<long>(b) * S, S, smem);
  const long so = sb ? static_cast<long>(b) : 0;
  const int* D = dptr + so * (S + 1);
  const int* Sr = src + so * A;
  const int* Sp = sptr + so * (S + 1);
  const int* So = sorder + so * A;
  const float* W = w + (wb ? static_cast<long>(b) * A : 0);
  const float* M = em + (eb ? static_cast<long>(b) * A : 0);
  float* dc = dcontrib + static_cast<long>(b) * A;
  const float* gb = g + static_cast<long>(b) * S;
  for (int k = D[S] + threadIdx.x; k < A; k += blockDim.x) dc[k] = 0.0f;
  __syncthreads();
  for (int s = warp; s < S; s += nwarps) {
    auto c = [&](int k) {
      const int u = Sr[k];
      return ((u >= 0 ? al[u] : kNeg) + W[k]) + M[k];
    };
    const auto sg = warp_seg(D[s], D[s + 1], lane, c);
    const float gy = gb[s];
    for (int k = D[s] + lane; k < D[s + 1]; k += 32) dc[k] = posterior(c(k), sg, gy);
  }
  __syncthreads();  // dc (global, this block's row) is visible block-wide
  for (int s = warp; s < S; s += nwarps) {
    const float v = warp_csr_sum<float>(Sp, So, dc, s, lane);
    if (lane == 0) dalpha[static_cast<long>(b) * S + s] = v;
  }
}

// ---------------------------------------------------------------------------
// seg_max: one tropical step with the lowest winning arc id
// ---------------------------------------------------------------------------
//
// new[b, s] = max(NEG, max over arcs a into s of (alpha[b, src[a]] + w[a]) +
// e[a]) and best_arc[b, s] the lowest arc id attaining it (2^30 unless it is
// strictly above NEG); arcs without a valid source are dropped (those
// without a valid destination lie past dptr[S]).  e[a] = em[b, label[a]]
// (0 for label -1) with a label index, else em[a] per arc.
//
// The TPU kernel builds [tile, S] one-hot masks of each arc tile and merges
// tiles in increasing arc order with a strict >.  Here one warp takes one
// (sample, destination): each lane scans a strided share of the
// destination's arcs, which the stable sort of arc_index keeps in
// increasing arc id, so a strict > keeps each lane's lowest id; the lanes
// merge by shuffles under "greater value, else lower id", an associative
// and exact rule, so the tie-break needs no order between lanes.  The grid
// spreads B x ceil(S / 8) blocks of 8 warps over the SMs (4,256 blocks at
// the 4-gram decode table, S = 1,058, B = 32).  Its hub destination (in
// degree 1,057 against a mean of 33.5) costs one warp 33 strided rounds.
//
// What bounds it on the H100: 3 fp32 operations an arc and sample and ~1 MB
// of tables, alpha and outputs, well under a microsecond; one launch per
// decoded frame, so the launch and the hub warp's chain of dependent
// loads set its time.

constexpr int kBig = 1 << 30;
constexpr int kMaxWarps = 8;

__global__ void __launch_bounds__(kMaxWarps * 32)
seg_max_kernel(const float* __restrict__ alpha, const int* __restrict__ dptr,
               const int* __restrict__ src, const long long* __restrict__ order,
               const float* __restrict__ w, const int* __restrict__ label,
               const float* __restrict__ em, float* __restrict__ out,
               int* __restrict__ arc, int S, int A, int C, int em_ld, int sb, int wb,
               int eb) {
  const int b = blockIdx.y;
  const int s = blockIdx.x * kMaxWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (s >= S) return;  // s is one value across the warp: whole warps leave
  const long so = sb ? static_cast<long>(b) : 0;
  const int* D = dptr + so * (S + 1);
  const int* Sr = src + so * A;
  const long long* Id = order + so * A;
  const int* L = label ? label + so * A : nullptr;
  const float* W = w + (wb ? static_cast<long>(b) * A : 0);
  const float* E = em + ((label || eb) ? static_cast<long>(b) * em_ld : 0);
  const float* al = alpha + static_cast<long>(b) * S;
  float best = -INFINITY;
  int best_id = kBig;
  for (int k = D[s] + lane; k < D[s + 1]; k += 32) {
    const int u = Sr[k];
    if (u < 0) continue;
    float e;
    if (L) {
      const int l = L[k];
      e = (l >= 0 && l < C) ? E[l] : 0.0f;
    } else {
      e = E[k];
    }
    const float c = (al[u] + W[k]) + e;
    if (c > best) {
      best = c;
      best_id = static_cast<int>(Id[k]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, best_id, off);
    if (ov > best || (ov == best && oi < best_id)) {
      best = ov;
      best_id = oi;
    }
  }
  if (lane == 0) {
    const long o = static_cast<long>(b) * S + s;
    const bool live = best > kNeg;
    out[o] = live ? best : kNeg;
    arc[o] = live ? best_id : kBig;
  }
}

// ---------------------------------------------------------------------------
// The whole scan
// ---------------------------------------------------------------------------

// Words (4 bytes) of shared memory: as ops/sparse_scan_pallas.py smem_bytes.
__host__ __device__ long scan_state_words(int S, int A, int E, int C, int D,
                                          bool backward) {
  if (backward) return 2L * S * (5 * D + 7) + A + E + C;  // doubles: two words
  return 32 + 4L * S + C;
}

// The backward's state slice of global scratch per sample, in words: a
// whole number of doubles, so every slice starts 8-byte aligned.
__host__ __device__ long scan_state_stride(int S, int A, int E, int C, int D) {
  const long words = scan_state_words(S, A, E, C, D, true);
  return words + (words & 1);
}


__global__ void __launch_bounds__(kScanThreads)
sparse_scan_fwd_kernel(const float* __restrict__ em, const float* __restrict__ alpha0,
                       const int* __restrict__ lens, const int* dptr, const int* src,
                       const int* label, const float* w, const int* eptr,
                       const int* esrc, const float* ew, float* __restrict__ traj,
                       double* __restrict__ shift, int T, int C, int S, int A, int E,
                       int depth, int sb, int wb, int esb, int ewb, int in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  Carve cv{smem};
  float* red = cv.floats(32);
  float* alpha = cv.floats(S);
  float* acc = cv.floats(S);
  float* cur = cv.floats(S);
  float* nxt = cv.floats(S);
  float* em_row = cv.floats(C);
  Arcs r = sample_arcs(dptr, src, label, w, nullptr, nullptr, nullptr, nullptr, b,
                       S, A, C, sb, wb);
  Arcs e{};
  if (depth > 0)
    e = sample_arcs(eptr, esrc, nullptr, ew, nullptr, nullptr, nullptr, nullptr, b,
                    S, E, C, esb, ewb);
  if (in_smem) {
    stage_arcs(r, cv, S, A, C, false, true);
    if (depth > 0) stage_arcs(e, cv, S, E, C, false, false);
  }
  const long tb = static_cast<long>(b) * (T + 1) * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float a = alpha0[static_cast<long>(b) * S + s];
    alpha[s] = a;
    traj[tb + s] = a;
  }
  const int t_live = min(max(lens[b], 0), T);
  double* shift_b = shift + static_cast<long>(b) * (T + 1);
  double k_run = 0.0;  // a sum of hundreds of shifts, kept exact
  if (threadIdx.x == 0) shift_b[0] = 0.0;
  __syncthreads();

  for (int t = 0; t < t_live; ++t) {
    const float* em_t = em + (static_cast<long>(b) * T + t) * C;
    for (int c = threadIdx.x; c < C; c += blockDim.x) em_row[c] = em_t[c];
    __syncthreads();
    for (int s = warp; s < S; s += nwarps) {
      const float v = warp_seg(r.dptr[s], r.dptr[s + 1], lane, [&](int k) {
        return arc_value(r, alpha, em_row, C, k);
      }).value();
      if (lane == 0) {
        acc[s] = v;
        cur[s] = v;
      }
    }
    __syncthreads();
    float* c0 = cur;
    float* c1 = nxt;
    for (int d = 0; d < depth; ++d) {
      for (int s = warp; s < S; s += nwarps) {
        const float v = warp_seg(e.dptr[s], e.dptr[s + 1], lane, [&](int k) {
          return eps_value(e, c0, k);
        }).value();
        if (lane == 0) {
          c1[s] = v;
          acc[s] = lae(acc[s], v);
        }
      }
      __syncthreads();
      float* tmp = c0;
      c0 = c1;
      c1 = tmp;
    }
    // the frame's shift: its largest alpha, 0 if every state is dead
    float m = -INFINITY;
    for (int s = threadIdx.x; s < S; s += blockDim.x) m = fmaxf(m, acc[s]);
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __syncthreads();
    float sh = -INFINITY;
    for (int w = 0; w < nwarps; ++w) sh = fmaxf(sh, red[w]);
    sh = sh > kDead ? sh : 0.0f;
    k_run += sh;
    float* tr = traj + tb + static_cast<long>(t + 1) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float a = acc[s] - sh;
      alpha[s] = a;
      tr[s] = a;
    }
    if (threadIdx.x == 0) shift_b[t + 1] = k_run;
    __syncthreads();
  }
  // frozen tail: alpha and the shift keep their values past the length
  for (int t = t_live; t < T; ++t) {
    float* tr = traj + tb + static_cast<long>(t + 1) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) tr[s] = alpha[s];
    if (threadIdx.x == 0) shift_b[t + 1] = k_run;
  }
}

// The backward recomputes each frame's chain in double precision (its
// inputs and outputs are float): over a few hundred frames, the posteriors
// of float intermediates (|value| ~ 10-30, an ulp ~ 1e-6) put ~1e-5 of
// noise on the cotangents; the recompute is latency-bound, and the card's
// fp64 rate is half its fp32 rate.
__global__ void __launch_bounds__(kScanThreads)
sparse_scan_bwd_kernel(const float* __restrict__ em, const float* __restrict__ traj,
                       const int* __restrict__ lens, const float* __restrict__ g_final,
                       const int* dptr, const int* src, const int* label, const float* w,
                       const int* sptr, const int* sorder, const int* lptr,
                       const int* lorder, const int* eptr, const int* esrc,
                       const float* ew, const int* esptr, const int* esorder,
                       float* __restrict__ dem, double* __restrict__ dw,
                       double* __restrict__ deps, float* __restrict__ dalpha0,
                       float* scratch, int T, int C, int S, int A, int E, int depth,
                       int sb, int wb, int esb, int ewb, int in_smem) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int D = depth;
  const long DS = static_cast<long>(D) * S;
  // the state in shared memory, or in this sample's slice of global scratch
  // where it does not fit (then the tables stay in global memory too);
  // __syncthreads orders the block's global accesses as it does shared ones
  Carve cv{scratch ? scratch + b * scan_state_stride(S, A, E, C, D) : smem};
  double* a_in = cv.doubles(S);
  double* curs = cv.doubles(DS + S);   // cur_0 = y0 .. cur_D
  double* seg_m = cv.doubles(DS + S);  // their shifts
  double* seg_z = cv.doubles(DS + S);  // and sums
  double* accs = cv.doubles(DS);       // acc_1 .. acc_D
  double* g = cv.doubles(S);
  double* gacc = cv.doubles(S);
  double* gcur = cv.doubles(DS + S);
  float* dc = cv.floats(A);
  float* dce = cv.floats(E);
  float* em_row = cv.floats(C);
  Arcs r = sample_arcs(dptr, src, label, w, sptr, sorder, lptr, lorder, b, S, A, C,
                       sb, wb);
  Arcs e{};
  if (D > 0)
    e = sample_arcs(eptr, esrc, nullptr, ew, esptr, esorder, nullptr, nullptr, b, S,
                    E, C, esb, ewb);
  if (in_smem) {
    stage_arcs(r, cv, S, A, C, true, true);
    if (D > 0) stage_arcs(e, cv, S, E, C, true, false);
  }
  double* dw_b = dw + static_cast<long>(b) * A;
  double* deps_b = D > 0 ? deps + static_cast<long>(b) * E : nullptr;
  float* dem_b = dem + static_cast<long>(b) * T * C;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    g[s] = g_final[static_cast<long>(b) * S + s];
  for (int k = threadIdx.x; k < A; k += blockDim.x) {
    dw_b[k] = 0.0;
    dc[k] = 0.0f;  // arcs past dptr[S] (no valid destination) stay 0
  }
  for (int k = threadIdx.x; k < E; k += blockDim.x) {
    if (D > 0) deps_b[k] = 0.0;
    dce[k] = 0.0f;
  }
  const int t_live = min(max(lens[b], 0), T);
  for (long i = static_cast<long>(t_live) * C + threadIdx.x; i < static_cast<long>(T) * C;
       i += blockDim.x)
    dem_b[i] = 0.0f;
  __syncthreads();

  for (int t = t_live - 1; t >= 0; --t) {
    const float* em_t = em + (static_cast<long>(b) * T + t) * C;
    const float* tr = traj + (static_cast<long>(b) * (T + 1) + t) * S;
    for (int c = threadIdx.x; c < C; c += blockDim.x) em_row[c] = em_t[c];
    for (int s = threadIdx.x; s < S; s += blockDim.x) a_in[s] = tr[s];
    __syncthreads();
    // recompute the frame's chain: y0, then cur_d and acc_d
    for (int s = warp; s < S; s += nwarps) {
      const Seg<double> sg = warp_seg(r.dptr[s], r.dptr[s + 1], lane, [&](int k) {
        return arc_value(r, a_in, em_row, C, k);
      });
      if (lane == 0) {
        curs[s] = sg.value();
        seg_m[s] = sg.m;
        seg_z[s] = sg.z;
      }
    }
    __syncthreads();
    for (int d = 1; d <= D; ++d) {
      const double* prev = curs + static_cast<long>(d - 1) * S;
      const double* accp = d == 1 ? curs : accs + static_cast<long>(d - 2) * S;
      for (int s = warp; s < S; s += nwarps) {
        const Seg<double> sg = warp_seg(e.dptr[s], e.dptr[s + 1], lane,
                                        [&](int k) { return eps_value(e, prev, k); });
        if (lane == 0) {
          const long i = static_cast<long>(d) * S + s;
          curs[i] = sg.value();
          seg_m[i] = sg.m;
          seg_z[i] = sg.z;
          accs[i - S] = lae(accp[s], curs[i]);
        }
      }
      __syncthreads();
    }
    // reverse the closure: acc_d = lae(acc_{d-1}, cur_d), cur_d = eps(cur_{d-1})
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      gacc[s] = g[s];
      for (int d = 0; d <= D; ++d) gcur[static_cast<long>(d) * S + s] = 0.0;
    }
    __syncthreads();
    for (int d = D; d >= 1; --d) {
      const double* cd = curs + static_cast<long>(d) * S;
      const double* prev = curs + static_cast<long>(d - 1) * S;
      const double* accp = d == 1 ? curs : accs + static_cast<long>(d - 2) * S;
      double* gcd = gcur + static_cast<long>(d) * S;
      for (int s = threadIdx.x; s < S; s += blockDim.x) {
        // logaddexp's posteriors, from its own shift (as autodiff forms them)
        const double a = accp[s];
        const double c = cd[s];
        const double m = fmax(fmax(a, c), double(kNeg));
        const double ea = a > kDead ? exp(a - m) : 0.0;
        const double ec = c > kDead ? exp(c - m) : 0.0;
        const double z = ea + ec;
        const double gz = z > 0.0 ? gacc[s] / z : 0.0;
        gcd[s] += gz * ec;
        gacc[s] = gz * ea;
      }
      __syncthreads();
      for (int s = warp; s < S; s += nwarps) {
        const long i = static_cast<long>(d) * S + s;
        const Seg<double> sg{seg_m[i], seg_z[i]};
        const double gy = gcd[s];
        for (int k = e.dptr[s] + lane; k < e.dptr[s + 1]; k += 32) {
          const double v = posterior(eps_value(e, prev, k), sg, gy);
          dce[k] = static_cast<float>(v);
          deps_b[k] += v;
        }
      }
      __syncthreads();
      double* gcp = gcur + static_cast<long>(d - 1) * S;
      for (int s = warp; s < S; s += nwarps) {
        const double v = warp_csr_sum<double>(e.sptr, e.sorder, dce, s, lane);
        if (lane == 0) gcp[s] += v;
      }
      __syncthreads();
    }
    // the arc step's VJP, with the cotangent of y0
    for (int s = threadIdx.x; s < S; s += blockDim.x) gacc[s] += gcur[s];
    __syncthreads();
    for (int s = warp; s < S; s += nwarps) {
      const Seg<double> sg{seg_m[s], seg_z[s]};
      const double gy = gacc[s];
      for (int k = r.dptr[s] + lane; k < r.dptr[s + 1]; k += 32) {
        const double v = posterior(arc_value(r, a_in, em_row, C, k), sg, gy);
        dc[k] = static_cast<float>(v);
        dw_b[k] += v;
      }
    }
    __syncthreads();
    for (int s = warp; s < S; s += nwarps) {
      const double v = warp_csr_sum<double>(r.sptr, r.sorder, dc, s, lane);
      if (lane == 0) g[s] = v;
    }
    float* dem_t = dem_b + static_cast<long>(t) * C;
    for (int l = warp; l < C; l += nwarps) {
      const double v = warp_csr_sum<double>(r.lptr, r.lorder, dc, l, lane);
      if (lane == 0) dem_t[l] = static_cast<float>(v);
    }
    __syncthreads();
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    dalpha0[static_cast<long>(b) * S + s] = static_cast<float>(g[s]);
}

long scan_table_words(int S, int A, int E, int C, int D, bool backward) {
  if (backward)
    return 2L * (S + 1) + 5L * A + (C + 1) + (D ? 2L * (S + 1) + 3L * E : 0);
  return (S + 1) + 3L * A + (D ? (S + 1) + 2L * E : 0);
}

template <typename K>
int launch_config(K kernel, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" {

// alpha [B, S]; the index tables (ops/seglse_pallas.py ArcIndex): dptr
// [1 or B, S + 1], src [1 or B, A] int32; w, em [1 or B, A] f32 in the
// index's arc order; out [B, S].  sb/wb/eb: 1 where that input is per sample.
int seg_lse_fwd(const float* alpha, const int* dptr, const int* src, const float* w,
                const float* em, float* out, int B, int S, int A, int sb, int wb,
                int eb, void* stream) {
  if (B == 0 || S == 0) return 0;
  const size_t smem = static_cast<size_t>(S) * sizeof(float);
  int err = launch_config(seg_lse_fwd_kernel, smem);
  if (err) return err;
  seg_lse_fwd_kernel<<<B, kStepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      alpha, dptr, src, w, em, out, S, A, sb, wb, eb);
  return static_cast<int>(cudaGetLastError());
}

// As seg_lse_fwd, with the cotangent g [B, S] of its output, the source groups
// sptr [1 or B, S + 1] and sorder [1 or B, A]; writes dalpha [B, S] and
// dcontrib [B, A] (in the index's arc order).
int seg_lse_bwd(const float* alpha, const float* g, const int* dptr,
                const int* src, const float* w, const float* em, const int* sptr,
                const int* sorder, float* dalpha, float* dcontrib, int B, int S, int A,
                int sb, int wb, int eb, void* stream) {
  if (B == 0 || S == 0) return 0;
  const size_t smem = static_cast<size_t>(S) * sizeof(float);
  int err = launch_config(seg_lse_bwd_kernel, smem);
  if (err) return err;
  seg_lse_bwd_kernel<<<B, kStepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      alpha, g, dptr, src, w, em, sptr, sorder, dalpha, dcontrib, S, A, sb, wb, eb);
  return static_cast<int>(cudaGetLastError());
}

// alpha [B, S]; the index tables dptr [1 or B, S + 1], src and order (int64)
// [1 or B, A], label [1 or B, A] or null; w [1 or B, A] in the index's arc
// order; em: with labels, row b at em + b * em_ld (C channels), else [1 or
// B, A] in the index's order (em_ld = A); writes out [B, S] and arc [B, S]
// int32.  sb/wb/eb: 1 where that input is per sample.
int seg_max(const float* alpha, const int* dptr, const int* src, const long long* order,
            const float* w, const int* label, const float* em, float* out, int* arc,
            int B, int S, int A, int C, int em_ld, int sb, int wb, int eb, void* stream) {
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kMaxWarps - 1) / kMaxWarps, B);
  seg_max_kernel<<<grid, kMaxWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      alpha, dptr, src, order, w, label, em, out, arc, S, A, C, em_ld, sb, wb, eb);
  return static_cast<int>(cudaGetLastError());
}

// em [B, T, C], alpha0 [B, S], lens [B]; the main arcs' index (dptr, src,
// label) and weights w, the epsilon arcs' (eptr, esrc) and weights ew (null
// when depth is 0); traj [B, T + 1, S], alpha relative to shift [B, T + 1]
// (float64: the running sum of the frames' shifts).  sb, wb, esb, ewb: 1 where per
// sample.  in_smem: stage the tables in shared memory (the caller checked
// that they fit; the state always must).
int sparse_scan_fwd(const float* em, const float* alpha0, const int* lens,
                    const int* dptr, const int* src, const int* label, const float* w,
                    const int* eptr, const int* esrc, const float* ew, float* traj,
                    double* shift, int B, int T, int C, int S, int A, int E, int depth,
                    int sb, int wb, int esb, int ewb, int in_smem, void* stream) {
  if (B == 0 || S == 0) return 0;
  long words = scan_state_words(S, A, E, C, depth, false);
  if (in_smem) words += scan_table_words(S, A, E, C, depth, false);
  const size_t smem = static_cast<size_t>(words) * 4;
  int err = launch_config(sparse_scan_fwd_kernel, smem);
  if (err) return err;
  sparse_scan_fwd_kernel<<<B, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      em, alpha0, lens, dptr, src, label, w, eptr, esrc, ew, traj, shift, T, C, S, A,
      E, depth, sb, wb, esb, ewb, in_smem);
  return static_cast<int>(cudaGetLastError());
}

// As sparse_scan_fwd, with the (shifted) traj [B, T + 1, S] and the final cotangent
// g_final [B, S], the main arcs' source and label groups (sptr, sorder,
// lptr [.., C + 1], lorder) and the epsilon arcs' source groups (esptr,
// esorder); writes dem [B, T, C], dw [B, A] and deps [B, E] (float64; deps
// null when depth is 0; both in the index's arc order) and dalpha0 [B, S].
// scratch: null, or [B, scan_state_stride] words of global memory for a
// state that does not fit in shared memory (in_smem must then be 0).
int sparse_scan_bwd(const float* em, const float* traj, const int* lens,
                    const float* g_final, const int* dptr, const int* src,
                    const int* label, const float* w, const int* sptr,
                    const int* sorder, const int* lptr, const int* lorder,
                    const int* eptr, const int* esrc, const float* ew,
                    const int* esptr, const int* esorder, float* dem, double* dw,
                    double* deps, float* dalpha0, float* scratch, int B, int T, int C,
                    int S, int A, int E, int depth, int sb, int wb, int esb, int ewb,
                    int in_smem, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (scratch && in_smem) return static_cast<int>(cudaErrorInvalidValue);
  long words = scratch ? 0 : scan_state_words(S, A, E, C, depth, true);
  if (in_smem) words += scan_table_words(S, A, E, C, depth, true);
  const size_t smem = static_cast<size_t>(words) * 4;
  int err = launch_config(sparse_scan_bwd_kernel, smem);
  if (err) return err;
  sparse_scan_bwd_kernel<<<B, kScanThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      em, traj, lens, g_final, dptr, src, label, w, sptr, sorder, lptr, lorder, eptr,
      esrc, ew, esptr, esorder, dem, dw, deps, dalpha0, scratch, T, C, S, A, E, depth,
      sb, wb, esb, ewb, in_smem);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
