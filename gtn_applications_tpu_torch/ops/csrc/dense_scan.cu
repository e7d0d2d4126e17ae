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

#include <cuda_pipeline.h>
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
// and keeps only column l_u of row u.  Frame 0 enters from
// e0 = exp(min(start, 0)) (start > NEG/2) and adds ws[u]:
// alpha = (z > 0 && has) ? (em + ws) + log(max(z, 1e-37)) : NEG.  Frames
// t >= len keep alpha; frame 0 is always applied.  The backward replays the
// trajectory: with ga = has ? g : 0 (dem[t] = ga) and dz[u] = z > 0 ?
// ga / max(z, 1e-37) : 0, an arc s -> u adds (adj[u, s] dz[u]) E[s, l_u] to
// g_{t-1}[s] and to dwsel[s, l_u], where E[s, l] = exp(v[s, l] - sh[l]);
// dadj[u, s] = sum_t dz_t[u] E_t[s, l_u] over every s (non-arcs too), and
// frame 0 gives dws = dem[0] = (z0 > 0 && has) ? g : 0 and dadj += dz0 e0.
//
// What bounds them on the H100: the Transducer's adjacency is almost
// empty (175 real arcs of S^2 = 9,216 at the ngram-2 headline, in-degree at
// most 3), so a frame's work is small (a max over S a label in use, an exp
// an arc, a log a labelled state); each frame needs the last, so the chain
// of T frames, one block barrier each, bounds it.  The design:
// - one block of kFactWarps warps a sample; its prologue compacts the
//   dense adjacency itself (a warp a row, a ballot and a popcount prefix
//   over each 32 columns) into the real arcs (adj != 0), grouped by
//   destination in member order (states by label slot, then by index:
//   compact_members, a thread a state), 8 bytes an arc (source, adj);
//   nothing is built on the host;
// - the members are packed into rounds (plan_dest_rounds) of at most
//   kShiftGroups consecutive label slots and 32 lanes: a member of
//   in-degree n gets a group of g lanes (g a power of two, n / g <= kCap,
//   the round's largest; a hub beyond 32 kCap takes several arcs a lane),
//   each lane sums every g-th arc and the group merges by xor shuffles;
//   8 lanes a slot compute the round's shifts, the TPU's per-label max
//   over all S states (which decides which states underflow), and each
//   member takes its slot's by a shuffle.  A destination never spans
//   warps, so a frame keeps one barrier.  Rounds are dealt to warps by a
//   cost prefix; where a warp holds one round, S <= 8 kRegK and no
//   in-degree passes 32 kCap, its task, its shift's wsel entries and its
//   arcs live in registers (route "registers"), else they are read from
//   shared memory ("shared"); where the arcs do not fit in shared memory
//   the members' dense rows are read from global memory ("global");
// - the emission rows are in shared memory before their frame: all a
//   sample's live rows copied by cp.async before the first frame where they
//   fit beside the arcs, else a ring of kRing rows filled kRing - 1 frames
//   ahead; alpha is double-buffered, so a frame ends in its one barrier;
//   traj stores are fire-and-forget.
// The backward splits what depends on g from what does not:
// - a pass over all frames spread across the card (grid B x chunks, a warp
//   a frame, no barrier in its loop) recomputes each live frame's shifts
//   sh_t[j] from traj with the forward's arcs and rounds, and its sums as
//   rz_t[u] = z > 0 ? 1 / max(z, 1e-37) : 0, into scratch of B T (Lmax + S)
//   floats, so the chain multiplies (dz = ga rz: one rounding more than
//   ga / max(z, 1e-37), within the tests' 1e-5) instead of dividing;
// - the chain (one block a sample) keeps the arcs by source (u | slot << 16,
//   adj) with a group of lanes per source matched to the largest
//   out-degree; a frame is one sparse product over them, each arc's factor
//   exp((prev[s] + wsel) - sh) rz computed from the frame's ring row
//   (traj[t-1], rz_t, sh_t, copied kRing - 1 frames ahead), g
//   double-buffered, one barrier a frame; each arc's dwsel sum accumulates
//   in frame order in the registers of the lane that owns it (in shared or
//   global memory where the lane's arcs do not fit) and is scattered once
//   at the end, a thread a source, with no atomics;
// - dadj, only when asked for, is a third pass parallel over (sample, row
//   block): a thread an entry sums dz_t[u] E_t[s, l_u] over the frames in
//   order from the dz the chain saved.

constexpr int kFactWarps = 16;
constexpr int kFactThreads = 32 * kFactWarps;
constexpr int kCap = 4;        // arcs a lane serves before its group widens
constexpr int kRegRounds = 1;  // rounds a warp may hold in registers
constexpr int kShiftGroups = 4;  // slots a round: 8 lanes a slot's shift
constexpr int kRegK = 20;      // wsel entries a lane holds for its shift: S <= 160
constexpr int kRegKSmall = 12;  // the same where S <= 96
constexpr int kRing = 8;       // rows of a streamed ring
constexpr int kMaxSlots = 1 << 13;  // label slots the plan packs (13 bits)
enum FactRoute { kRouteRegisters = 0, kRouteShared = 1, kRouteGlobal = 2 };
// misc words of the block's plan
enum Misc { kNlab, kNnz, kRounds, kRoute, kStaged, kGroup, kMiscWords = 8 };

// Word offsets of the factored kernels' shared memory: label compaction,
// members by slot, arc offsets (and counts), the rounds, the
// warps' round ranges, the label columns WT[j][s] = wsel[s, label_of[j]],
// `vec` words of vectors, then an arena (16-byte aligned) for the arcs and
// the rows.
struct FactSmem {
  int slot_of, label_of, jslot, misc, mem_ptr, mem_idx, arc_ptr, rnd,
      wbeg, wt, vec, arena;
};

__host__ __device__ inline FactSmem fact_layout(int S, int N, int L, int vec) {
  FactSmem m;
  int w = 0;
  m.slot_of = w;  w += N;
  m.label_of = w; w += L;
  m.jslot = w;    w += S;
  m.misc = w;     w += kMiscWords;
  m.mem_ptr = w;  w += L + 1;
  m.mem_idx = w;  w += S;
  m.arc_ptr = w;  w += S + 1;
  m.rnd = w;      w += 2 * S;
  m.wbeg = w;     w += kFactWarps + 1;
  m.wt = w;       w += L * S;
  m.vec = w;      w += vec;
  m.arena = (w + 3) & ~3;
  return m;
}

__host__ __device__ inline int group_width(int deg) {
  int g = 1;
  while (g < 32 && g * kCap < deg) g <<= 1;
  return g;
}

struct FactPtrs {
  int *slot_of, *label_of, *jslot, *misc, *mem_ptr, *mem_idx, *arc_ptr,
      *rnd, *wbeg;
  float *wt, *vec;
  int* arena;
};

__device__ __forceinline__ FactPtrs fact_ptrs(int* base, const FactSmem& m) {
  return FactPtrs{base + m.slot_of, base + m.label_of, base + m.jslot,
                  base + m.misc,    base + m.mem_ptr,  base + m.mem_idx,
                  base + m.arc_ptr, base + m.rnd,
                  base + m.wbeg,    reinterpret_cast<float*>(base + m.wt),
                  reinterpret_cast<float*>(base + m.vec), base + m.arena};
}

// Label slots j = 0..Lu-1 in order of first use (label_of[j], jslot[u], -1
// for none) and the members of each slot in increasing u (mem_idx, CSR
// mem_ptr), each by a thread a state comparing it with the states before
// it (O(S) shared loads a thread, no serial pass): a state is its label's
// first use when no earlier state has the label, a first use's slot is
// the number of first uses before it, and a member's place is the members
// of earlier slots and of its slot before it.  arc_ptr holds the labels
// and mem_idx the first-use flags until they are written.  Ends in a
// barrier.
__device__ __forceinline__ void compact_members(const int* __restrict__ lab_b, int S, int N,
                                                const FactPtrs& p) {
  int* lab = p.arc_ptr;
  int* first = p.mem_idx;
  for (int u = threadIdx.x; u < S; u += blockDim.x) lab[u] = lab_b[u];
  __syncthreads();
  for (int u = threadIdx.x; u < S; u += blockDim.x) {
    const int l = lab[u];
    int f = l >= 0;
    for (int v = 0; v < u && f; ++v) f = lab[v] != l;
    first[u] = f;
  }
  __syncthreads();
  for (int u = threadIdx.x; u < S; u += blockDim.x) {
    if (first[u]) {
      int j = 0;
      for (int v = 0; v < u; ++v) j += first[v];
      p.slot_of[lab[u]] = j;
      p.label_of[j] = lab[u];
    }
    if (u == S - 1) {
      int n = 0;
      for (int v = 0; v < S; ++v) n += first[v];
      p.misc[kNlab] = n;
    }
  }
  __syncthreads();
  for (int u = threadIdx.x; u < S; u += blockDim.x)
    p.jslot[u] = lab[u] >= 0 ? p.slot_of[lab[u]] : -1;
  __syncthreads();
  for (int u = threadIdx.x; u < S; u += blockDim.x) {
    const int j = p.jslot[u];
    if (j >= 0) {
      int before = 0, pos = 0;
      for (int v = 0; v < S; ++v) {
        const int jv = p.jslot[v];
        before += jv >= 0 && jv < j;
        pos += jv == j && v < u;
      }
      p.mem_idx[before + pos] = u;
      if (pos == 0) p.mem_ptr[j] = before;
    }
    if (u == S - 1) {
      int n = 0;
      for (int v = 0; v < S; ++v) n += p.jslot[v] >= 0;
      p.mem_ptr[p.misc[kNlab]] = n;
    }
  }
  __syncthreads();
}

// ptr[i] = cnt[0] + ... + cnt[i - 1] for i = 0..n, a thread an entry.
__device__ __forceinline__ void offsets(const int* cnt, int* ptr, int n) {
  for (int i = threadIdx.x; i <= n; i += blockDim.x) {
    int sum = 0;
    for (int k = 0; k < i; ++k) sum += cnt[k];
    ptr[i] = sum;
  }
}

// The real arcs into each member (adj[u, s] != 0), counted a warp a row
// by ballot: cnt[m] = in-degree of member m.
__device__ __forceinline__ void dest_degrees(const float* A, int S, int S_l, const FactPtrs& p,
                                             int* cnt_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < S_l; m += blockDim.x >> 5) {
    const float* row = A + static_cast<long>(p.mem_idx[m]) * S;
    int cnt = 0;
    for (int c0 = 0; c0 < S; c0 += 128) {  // four chunks' loads in flight
      float a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = c0 + 32 * k + lane;
        a[k] = s < S ? row[s] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) cnt += __popc(__ballot_sync(kFull, a[k] != 0.0f));
    }
    if (lane == 0) cnt_out[m] = cnt;
  }
}

// Each member's arcs in increasing s, 8 bytes an arc (s, adj bits): a warp
// a row, each lane's position the popcount of the ballot below it.
__device__ __forceinline__ void fill_dest_arcs(const float* A, int S, int S_l, const FactPtrs& p,
                               int2* arcs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = warp; m < S_l; m += blockDim.x >> 5) {
    const float* row = A + static_cast<long>(p.mem_idx[m]) * S;
    int pos = p.arc_ptr[m];
    for (int c0 = 0; c0 < S; c0 += 128) {  // four chunks' loads in flight
      float a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = c0 + 32 * k + lane;
        a[k] = s < S ? row[s] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const unsigned bal = __ballot_sync(kFull, a[k] != 0.0f);
        if (a[k] != 0.0f)
          arcs[pos + __popc(bal & ((1u << lane) - 1u))] =
              make_int2(c0 + 32 * k + lane, __float_as_int(a[k]));
        pos += __popc(bal);
      }
    }
  }
}

// WT[j][s] = wsel[s, label_of[j]] for the slots in use.
__device__ __forceinline__ void fill_wt(const float* wsel_b, int S, int N, int Lu, const FactPtrs& p) {
#pragma unroll 4
  for (int i = threadIdx.x; i < Lu * S; i += blockDim.x) {
    const int j = i / S;
    p.wt[i] = wsel_b[static_cast<long>(i - j * S) * N + p.label_of[j]];
  }
}

// Each member's slot, group width (log2) and in-degree, packed (slot |
// lg << 13 | deg << 16) by all threads for the plan (slots < 2^13); the
// label columns' room serves, as WT is filled after the plan.  On the
// dense route every member has S arcs.
__device__ __forceinline__ int* member_info(const FactPtrs& p, int S_l, int S, bool dense) {
  int* info = reinterpret_cast<int*>(p.wt);
  for (int m = threadIdx.x; m < S_l; m += blockDim.x) {
    const int deg = dense ? S : p.arc_ptr[m + 1] - p.arc_ptr[m];
    info[m] = p.jslot[p.mem_idx[m]] | (__ffs(group_width(deg)) - 1) << 13 | deg << 16;
  }
  return info;
}

// Thread 0: the rounds.  Members in member order are packed into rounds
// of at most kShiftGroups consecutive slots and 32 lanes, each member a
// group of g lanes, g the round's largest group_width (S arcs a member on
// the dense route); a round is (m0 | m1 << 16, g).  With `warps`, the
// rounds are dealt to the warps in contiguous ranges of about equal cost
// (the shift, and the arcs a lane).
__device__ __forceinline__ void plan_dest_rounds(int S, const FactPtrs& p, int warps,
                                                 const int* info) {
  const int S_l = p.mem_ptr[p.misc[kNlab]];
  const int shift_cost = 2 * ((S + 7) / 8) + 8;
  int R = 0, m = 0, total = 0;
  int v = S_l > 0 ? info[0] : 0;
  while (m < S_l) {
    const int m0 = m, j0 = v & 0x1fff;
    int lg = 0, most = 0;
    while (m < S_l) {
      const int ln = max(lg, (v >> 13) & 7);
      if ((m - m0 + 1) << ln > 32 || (v & 0x1fff) - j0 >= kShiftGroups) break;
      lg = ln;
      most = max(most, v >> 16);
      ++m;
      v = m < S_l ? info[m] : 0;
    }
    const int cost = shift_cost + 3 * (((most + (1 << lg) - 1) >> lg) + 2);
    p.rnd[2 * R] = m0 | (m << 16);
    p.rnd[2 * R + 1] = (1 << lg) | (cost << 8);
    total += cost;
    ++R;
  }
  p.misc[kRounds] = R;
  if (warps <= 0) return;
  int cum = 0, w = 0;
  p.wbeg[0] = 0;
  for (int r = 0; r < R; ++r) {
    const int want = total > 0 ? cum * warps / total : 0;
    while (w < want && w < warps) p.wbeg[++w] = r;
    cum += p.rnd[2 * r + 1] >> 8;
  }
  while (w < warps) p.wbeg[++w] = R;
}

// What one lane serves in a round: destination u (-1: none), n arcs from
// a0 with stride g, the slot j0 + k of its destination; the round's slots
// are j0 .. j0 + nsl - 1.
struct Task {
  int u, a0, n, g, k, j0, nsl;
};

__device__ __forceinline__ Task round_task(const FactPtrs& p, int r, int lane, int S,
                                           bool dense) {
  const int code = p.rnd[2 * r];
  const int m0 = code & 0xffff, m1 = code >> 16, g = p.rnd[2 * r + 1] & 0xff;
  const int j0 = p.jslot[p.mem_idx[m0]];
  const int m = m0 + lane / g, sub = lane & (g - 1);
  Task t{-1, 0, 0, g, 0, j0, p.jslot[p.mem_idx[m1 - 1]] - j0 + 1};
  if (m < m1) {
    t.u = p.mem_idx[m];
    t.k = p.jslot[t.u] - j0;
    const int deg = dense ? S : p.arc_ptr[m + 1] - p.arc_ptr[m];
    t.n = deg > sub ? (deg - sub + g - 1) / g : 0;
    t.a0 = (dense ? 0 : p.arc_ptr[m]) + sub;
  }
  return t;
}

// z of the task's destination, left in the group's first lane (every lane
// of the group): the lane's arcs, then the group's xor merge.  x is e0
// (frame 0: z = sum adj e0[s]) or the previous alpha (z = sum adj
// exp((x + wsel) - sh)); on the dense route the arcs are the row itself.
__device__ __forceinline__ float dest_sum(const Task& t, const int2* arcs,
                                          const float* A, const float* x,
                                          const float* wcol, float sh, bool frame0,
                                          int S, bool dense) {
  float z = 0.0f;
  for (int i = 0; i < t.n; ++i) {
    const int k = t.a0 + i * t.g;
    int s;
    float a;
    if (dense) {
      s = k;
      a = A[static_cast<long>(t.u) * S + k];
    } else {
      const int2 arc = arcs[k];
      s = arc.x;
      a = __int_as_float(arc.y);
    }
    const float e = frame0 ? x[s] : expf((x[s] + wcol[s]) - sh);
    z += a * e;
  }
  for (int off = t.g >> 1; off > 0; off >>= 1) z += __shfl_xor_sync(kFull, z, off);
  return z;
}

// The TPU's per-label shift max(max_s x[s] + wsel[s, l], NEG) of the
// round's slots, 8 lanes a slot (lanes 8k .. 8k + 7: slot j0 + k, each
// lane every 8th state, then 3 xor shuffles); every lane of the group
// holds its slot's shift.  wr: the lane's K wsel entries in registers
// (-inf past S), or with K = 0 read from WT.
template <int K>
__device__ __forceinline__ float group_shift(const float* x, const float* wt,
                                             const float* wr, const Task& t, int S,
                                             int lane) {
  const int kg = lane >> 3;
  float m = -INFINITY;
  if (K > 0) {
    // four independent maxima, then theirs (max is exact); every entry is
    // read at a constant offset from the lane's first, so the loads issue
    // together.  Past S the entry weighs -inf, and what is read there (the
    // block's own shared memory) cannot win: fmaxf drops the NaN of
    // inf - inf
    const float* xl = x + (lane & 7);
    float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < K; ++i) m4[i & 3] = fmaxf(m4[i & 3], xl[8 * i] + wr[i]);
    m = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
  } else if (kg < t.nsl) {
    const float* w = wt + static_cast<long>(t.j0 + kg) * S;
    for (int s = lane & 7; s < S; s += 8) m = fmaxf(m, x[s] + w[s]);
  }
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 4));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 2));
  m = fmaxf(m, __shfl_xor_sync(kFull, m, 1));
  return fmaxf(m, kNeg);
}

// Copy n floats to shared memory by cp.async (this thread's share; with
// from_last the block's last threads copy, as the chain's rounds are
// dealt to its first warps); no commit.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n,
                                           bool from_last = false) {
  const int first = from_last ? blockDim.x - 1 - threadIdx.x : threadIdx.x;
  for (int i = first; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
}

// Every ring row but the kRing - 2 latest committed has landed (this
// thread's copies).
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 2) : "memory");
}

// The destination's emission (and at frame 0 its start weight).
__device__ __forceinline__ float emission(int u, bool f0, const float* em_row,
                                          const float* ws_b) {
  if (u < 0) return 0.0f;
  return f0 ? em_row[u] + ws_b[u] : em_row[u];
}

// The new alpha of a task's destination, from its group's first lane; em
// is emission()'s.
__device__ __forceinline__ void emit_alpha(int u, int g, float z, float sh, bool f0, float em,
                                           float* next, float* tr_t, int lane) {
  if (u >= 0 && (lane & (g - 1)) == 0) {
    float v;
    if (f0)
      v = z > 0.0f ? em + logf(fmaxf(z, kFloor)) : kNeg;
    else
      v = em + (z > 0.0f ? sh + logf(fmaxf(z, kFloor)) : kNeg);
    next[u] = v;
    tr_t[u] = v;
  }
}

// What the forward's frames read, after the prologue.
struct FwdArgs {
  const float* A;
  const float* em_b;
  const float* ws_b;
  float* tr_b;
  const int2* arcs;
  float* rows;
  int S, t_live, staged;
  bool dense;
};

// One round of a frame: the round's shifts (not at frame 0), each lane's
// destination sum, and the new alpha.
__device__ __forceinline__ void fwd_round(const FactPtrs& p, const FwdArgs& a, const Task& tk,
                                          const float* x, bool f0, const float* em_row,
                                          float* next, float* tr_t, int lane) {
  const float em = emission(tk.u, f0, em_row, a.ws_b);
  float sh = 0.0f;
  if (!f0)
    sh = __shfl_sync(kFull, group_shift<0>(x, p.wt, nullptr, tk, a.S, lane), 8 * tk.k);
  const float z = dest_sum(tk, a.arcs, a.A, x, p.wt + (tk.j0 + tk.k) * a.S, sh, f0, a.S,
                           a.dense);
  emit_alpha(tk.u, tk.g, z, sh, f0, em, next, tr_t, lane);
}

// The warp's one round with everything a lane needs in registers: the
// task, the wsel entries of its shift, and its (at most kCap) arcs as
// (source, adj, wsel[source, its label]); arcs past the lane's weigh
// adj 0 at wsel -inf, so they add an exact +0.
template <int K>
struct RegRound {
  Task tk;
  float wr[K];
  int xs[kCap];
  float av[kCap], wv[kCap];
};

template <int K>
__device__ __forceinline__ void load_reg_round(const FactPtrs& p, const FwdArgs& a, int r,
                                               int lane, RegRound<K>& q) {
  const int S = a.S;
  q.tk = round_task(p, r, lane, S, false);
  const int kg = lane >> 3;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int s = (lane & 7) + 8 * i;
    q.wr[i] = kg < q.tk.nsl && s < S ? p.wt[(q.tk.j0 + kg) * S + s] : -INFINITY;
  }
  const float* wcol = p.wt + (q.tk.j0 + q.tk.k) * S;
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    const bool ok = k < q.tk.n;
    const int2 arc = ok ? a.arcs[q.tk.a0 + k * q.tk.g] : make_int2(0, 0);
    q.xs[k] = arc.x;
    q.av[k] = ok ? __int_as_float(arc.y) : 0.0f;
    q.wv[k] = ok ? wcol[arc.x] : -INFINITY;
  }
}

template <int K>
__device__ __forceinline__ void fwd_round_regs(const FactPtrs& p, const FwdArgs& a,
                                               const RegRound<K>& q, const float* x, bool f0,
                                               const float* em_row, float* next, float* tr_t,
                                               int lane) {
  float sh = 0.0f;
  if (!f0)
    sh = __shfl_sync(kFull, group_shift<K>(x, p.wt, q.wr, q.tk, a.S, lane), 8 * q.tk.k);
  float z = 0.0f;
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    if (k < 2 || k < q.tk.n) {  // the first two always, so they overlap (pads add +0)
      const float e = f0 ? x[q.xs[k]] : expf((x[q.xs[k]] + q.wv[k]) - sh);
      z += q.av[k] * e;
    }
  }
  for (int off = q.tk.g >> 1; off > 0; off >>= 1) z += __shfl_xor_sync(kFull, z, off);
  emit_alpha(q.tk.u, q.tk.g, z, sh, f0, emission(q.tk.u, f0, em_row, a.ws_b), next, tr_t,
             lane);
}

// K > 0: route registers with K wsel entries a lane; 0: shared or global.
template <int K>
__device__ __forceinline__ void fwd_frames(const FactPtrs& p, const FwdArgs& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S;
  float* al0 = p.vec;  // frame t reads al0 (t odd: al1) and writes the other
  float* al1 = al0 + S;
  const float* e0 = al1 + S;
  const int rb = p.wbeg[warp], re = p.wbeg[warp + 1];
  RegRound<(K > 0 ? K : 1)> q;
  if (K > 0 && rb < re) load_reg_round(p, a, rb, lane, q);
  if (a.staged) __pipeline_wait_prior(0); else wait_ring();
  __syncthreads();  // row 0 (every row)

  for (int t = 0; t < a.t_live; ++t) {
    const float* prev = (t & 1) ? al1 : al0;
    float* next = (t & 1) ? al0 : al1;
    const float* em_row = a.rows + static_cast<long>(a.staged ? t : t % kRing) * S;
    float* tr_t = a.tr_b + static_cast<long>(t) * S;
    if (!a.staged) {
      // the slot of row t - 1, read in frame t - 1 before its barrier
      const int r = t + kRing - 1;
      if (r < a.t_live)
        copy_async(a.rows + static_cast<long>(r % kRing) * S,
                   a.em_b + static_cast<long>(r) * S, S);
      __pipeline_commit();
    }
    const bool f0 = t == 0;
    const float* x = f0 ? e0 : prev;
    if (K > 0) {
      if (rb < re) fwd_round_regs(p, a, q, x, f0, em_row, next, tr_t, lane);
    } else {
      for (int r = rb; r < re; ++r)
        fwd_round(p, a, round_task(p, r, lane, S, a.dense), x, f0, em_row, next, tr_t, lane);
    }
    if (!a.staged) wait_ring();
    __syncthreads();  // next complete, row t + 1 landed
  }
}

__global__ void __launch_bounds__(kFactThreads)
factored_scan_fwd_kernel(const float* __restrict__ em, const float* __restrict__ adj,
                         const float* __restrict__ wsel, const int* __restrict__ lab_idx,
                         const float* __restrict__ ws, const float* __restrict__ start,
                         const int* __restrict__ lens, float* __restrict__ traj, int T,
                         int S, int N, int L, int smem_words) {
  extern __shared__ __align__(16) int fact_smem[];
  const FactSmem lay = fact_layout(S, N, L, 3 * S);
  const FactPtrs p = fact_ptrs(fact_smem, lay);
  const int b = blockIdx.x;
  const float* A = adj + static_cast<long>(b) * S * S;
  compact_members(lab_idx + static_cast<long>(b) * S, S, N, p);
  const int Lu = p.misc[kNlab];
  const int S_l = p.mem_ptr[Lu];
  const int t_live = live_steps(lens[b], T);
  dest_degrees(A, S, S_l, p, p.rnd);
  float* e0 = p.vec + 2 * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    e0[s] = start_e(start[static_cast<long>(b) * S + s]);
    p.vec[s] = kNeg;
    p.vec[S + s] = kNeg;
  }
  __syncthreads();
  offsets(p.rnd, p.arc_ptr, S_l);
  __syncthreads();
  const int* info;
  {
    const int arena = smem_words - lay.arena;
    info = member_info(p, S_l, S, 2L * p.arc_ptr[S_l] + static_cast<long>(kRing) * S > arena);
  }
  int hub = 0;
  for (int m = threadIdx.x; m < S_l; m += blockDim.x)
    hub |= p.arc_ptr[m + 1] - p.arc_ptr[m] > 32 * kCap;
  hub = __syncthreads_or(hub);
  if (threadIdx.x == 0) {
    const int arena = smem_words - lay.arena;
    const int nnz = p.arc_ptr[S_l];
    const bool dense = 2L * nnz + static_cast<long>(kRing) * S > arena;
    const long arc_words = dense ? 0 : 2L * nnz;
    p.misc[kNnz] = nnz;
    p.misc[kStaged] = arc_words + static_cast<long>(t_live) * S <= arena;
    plan_dest_rounds(S, p, blockDim.x >> 5, info);
    int most = 0;
    for (int w = 0; w < (blockDim.x >> 5); ++w) most = max(most, p.wbeg[w + 1] - p.wbeg[w]);
    p.misc[kRoute] = dense ? kRouteGlobal
                     : (most <= kRegRounds && S <= 8 * kRegK && !hub) ? kRouteRegisters
                                                                        : kRouteShared;
  }
  __syncthreads();
  const bool dense = p.misc[kRoute] == kRouteGlobal;
  const int staged = p.misc[kStaged];
  int2* arcs = reinterpret_cast<int2*>(p.arena);
  float* rows = reinterpret_cast<float*>(p.arena) + (dense ? 0 : 2 * p.misc[kNnz]);
  const float* em_b = em + static_cast<long>(b) * T * S;
  // the emission rows: every live one (one copy before the frames), else
  // the ring's first kRing - 1
  if (staged) {
    copy_async(rows, em_b, t_live * S);
    __pipeline_commit();
  } else {
    for (int r = 0; r < kRing - 1; ++r) {
      if (r < t_live) copy_async(rows + r * S, em_b + static_cast<long>(r) * S, S);
      __pipeline_commit();
    }
  }
  if (!dense) fill_dest_arcs(A, S, S_l, p, arcs);
  fill_wt(wsel + static_cast<long>(b) * S * N, S, N, Lu, p);
  __syncthreads();  // arcs and WT

  float* tr_b = traj + static_cast<long>(b) * T * S;
  const FwdArgs args{A, em_b, ws + static_cast<long>(b) * S, tr_b, arcs, rows, S,
                     t_live, staged, dense};
  if (p.misc[kRoute] != kRouteRegisters)
    fwd_frames<0>(p, args);
  else if (S <= 8 * kRegKSmall)
    fwd_frames<kRegKSmall>(p, args);
  else
    fwd_frames<kRegK>(p, args);
  __pipeline_wait_prior(0);
  // states without a label stay NEG; the frozen tail keeps alpha (a
  // thread a state, its final value read once)
  const float* fin = (t_live & 1) ? p.vec + S : p.vec;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float v = fin[s];
    float* tr_s = tr_b + s;
    for (int t = p.jslot[s] < 0 ? 0 : t_live; t < T; ++t) tr_s[static_cast<long>(t) * S] = v;
  }
}

// The backward's statistics of each live frame, off the chain: sh_t[j]
// (t >= 1) and, for the labelled states, rz_t[u] = z > 0 ? 1 / max(z,
// 1e-37) : 0, from traj; grid (B, chunks), a warp a frame with its own row
// of the previous alpha in shared memory.
__global__ void __launch_bounds__(kFactThreads)
factored_stats_kernel(const float* __restrict__ traj, const float* __restrict__ adj,
                      const float* __restrict__ wsel, const int* __restrict__ lab_idx,
                      const float* __restrict__ start, const int* __restrict__ lens,
                      float* __restrict__ sh_out, float* __restrict__ rz_out, int T, int S,
                      int N, int L, int smem_words, int frames_per_chunk) {
  extern __shared__ __align__(16) int fact_smem[];
  const FactSmem lay = fact_layout(S, N, L, (1 + kFactWarps) * S);
  const FactPtrs p = fact_ptrs(fact_smem, lay);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the chain may start its prologue now (it waits for this pass's results)
  asm volatile("griddepcontrol.launch_dependents;");
  const int t_live = live_steps(lens[b], T);
  const int t0 = blockIdx.y * frames_per_chunk;
  const int t1 = min(t0 + frames_per_chunk, t_live);
  if (t0 >= t1) return;
  const float* A = adj + static_cast<long>(b) * S * S;
  compact_members(lab_idx + static_cast<long>(b) * S, S, N, p);
  const int Lu = p.misc[kNlab];
  const int S_l = p.mem_ptr[Lu];
  dest_degrees(A, S, S_l, p, p.rnd);
  float* e0 = p.vec;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    e0[s] = start_e(start[static_cast<long>(b) * S + s]);
  __syncthreads();
  offsets(p.rnd, p.arc_ptr, S_l);
  __syncthreads();
  const bool dense = 2L * p.arc_ptr[S_l] > smem_words - lay.arena;
  const int* info = member_info(p, S_l, S, dense);
  __syncthreads();
  if (threadIdx.x == 0) plan_dest_rounds(S, p, 0, info);
  __syncthreads();
  int2* arcs = reinterpret_cast<int2*>(p.arena);
  if (!dense) fill_dest_arcs(A, S, S_l, p, arcs);
  fill_wt(wsel + static_cast<long>(b) * S * N, S, N, Lu, p);
  __syncthreads();

  const int R = p.misc[kRounds];
  float* row = p.vec + (1 + warp) * S;
  const float* tr_b = traj + static_cast<long>(b) * T * S;
  for (int t = t0 + warp; t < t1; t += blockDim.x >> 5) {
    if (t > 0) {
      const float* src = tr_b + static_cast<long>(t - 1) * S;
      for (int s = lane; s < S; s += 32) row[s] = src[s];
      __syncwarp();
    }
    const float* x = t > 0 ? row : e0;
    float* sh_t = sh_out + (static_cast<long>(b) * T + t) * L;
    float* rz_t = rz_out + (static_cast<long>(b) * T + t) * S;
    for (int r = 0; r < R; ++r) {
      const Task tk = round_task(p, r, lane, S, dense);
      float sh = 0.0f;
      if (t > 0) {
        const float grp = group_shift<0>(x, p.wt, nullptr, tk, S, lane);
        if ((lane & 7) == 0 && (lane >> 3) < tk.nsl) sh_t[tk.j0 + (lane >> 3)] = grp;
        sh = __shfl_sync(kFull, grp, 8 * tk.k);
      }
      const float z = dest_sum(tk, arcs, A, x, p.wt + (tk.j0 + tk.k) * S, sh, t == 0, S,
                               dense);
      if (tk.u >= 0 && (lane & (tk.g - 1)) == 0)
        rz_t[tk.u] = z > 0.0f ? 1.0f / fmaxf(z, kFloor) : 0.0f;
    }
    __syncwarp();  // the row is read before the next frame overwrites it
  }
}

// The chain's arcs by source: arc_ptr[s + 1] = out-degree of s into the
// labelled states (a warp a source, ballot over the members), then each
// source's arcs in member order (u | slot << 16, adj bits).
__device__ __forceinline__ void source_degrees(const float* A, int S, int S_l, const FactPtrs& p,
                                               int* cnt_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < S; s += blockDim.x >> 5) {
    int cnt = 0;
#pragma unroll 4
    for (int c = 0; c < S_l; c += 32) {
      const int m = c + lane;
      cnt += __popc(__ballot_sync(
          kFull, m < S_l && A[static_cast<long>(p.mem_idx[m]) * S + s] != 0.0f));
    }
    if (lane == 0) cnt_out[s] = cnt;
  }
}

__device__ __forceinline__ void fill_source_arcs(const float* A, int S, int S_l, const FactPtrs& p,
                                 int2* arcs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < S; s += blockDim.x >> 5) {
    int pos = p.arc_ptr[s];
#pragma unroll 4
    for (int c = 0; c < S_l; c += 32) {
      const int m = c + lane;
      const int u = m < S_l ? p.mem_idx[m] : 0;
      const float a = m < S_l ? A[static_cast<long>(u) * S + s] : 0.0f;
      const unsigned bal = __ballot_sync(kFull, a != 0.0f);
      if (a != 0.0f)
        arcs[pos + __popc(bal & ((1u << lane) - 1u))] =
            make_int2(u | (p.jslot[u] << 16), __float_as_int(a));
      pos += __popc(bal);
    }
  }
}

// One lane's share of a source: source s (S: none), n arcs from a0 with
// stride g (one g for all sources).
struct SrcTask {
  int s, a0, n;
};

__device__ __forceinline__ SrcTask source_task(const FactPtrs& p, int r, int lane, int S,
                                               int g) {
  const int s = r * (32 / g) + lane / g, sub = lane & (g - 1);
  SrcTask t{S, 0, 0};
  if (s < S) {
    const int deg = p.arc_ptr[s + 1] - p.arc_ptr[s];
    t.s = s;
    t.n = deg > sub ? (deg - sub + g - 1) / g : 0;
    t.a0 = p.arc_ptr[s] + sub;
  }
  return t;
}

struct ChainArgs {
  const float* tr_b;
  const float* sh_b;
  const float* z_b;
  float* dz_b;  // null unless dadj is asked for
  float* dem_b;
  const int2* arcs;
  float* acc;  // each arc's dwsel sum
  float* ring;
  int S, L, Lu, t_live, g, rounds;
};

// One arc's term (adj dz[u]) E[s, l_u] of frame t, dz = g rz, from the
// frame's ring row.
__device__ __forceinline__ float arc_term(int2 arc, float ps, int s, const float* wt,
                                          int S, const float* zr, const float* shr,
                                          const float* gcur) {
  const int u = arc.x & 0xffff, j = arc.x >> 16;
  const float e = expf((ps + wt[j * S + s]) - shr[j]);
  return (__int_as_float(arc.y) * (gcur[u] * zr[u])) * e;
}

// Start copying chain frame i's ring row (traj[t - 1], rz_t, sh_t) or
// nothing; one commit either way.
__device__ __forceinline__ void fetch_chain_row(const ChainArgs& c, int i) {
  const int nf = c.t_live - 1;
  if (i < nf) {
    const int t = c.t_live - 1 - i;
    float* dst = c.ring + static_cast<long>(i % kRing) * (2 * c.S + c.L);
    copy_async(dst, c.tr_b + static_cast<long>(t - 1) * c.S, c.S, true);
    copy_async(dst + c.S, c.z_b + static_cast<long>(t) * c.S, c.S, true);
    copy_async(dst + 2 * c.S, c.sh_b + static_cast<long>(t) * c.L, c.Lu, true);
  }
  __pipeline_commit();
}

// g_{t-1}[s]: the source's group merges its lanes' sums by xor shuffles.
__device__ __forceinline__ void store_sum(int s, float sum, int g, int S, float* gnext,
                                          int lane) {
  for (int off = g >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (s < S && (lane & (g - 1)) == 0) gnext[s] = sum;
}

template <bool kRegs>
__device__ __forceinline__ void chain_frames(const FactPtrs& p, const ChainArgs& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int S = c.S, g = c.g;
  float* g0 = p.vec;  // chain frame i reads g0 (i odd: g1) and writes the other
  float* g1 = g0 + S;
  const bool mine = warp < c.rounds;
  const SrcTask tk = kRegs && mine ? source_task(p, warp, lane, S, g) : SrcTask{S, 0, 0};
  float acc[kCap];
#pragma unroll
  for (int k = 0; k < kCap; ++k) acc[k] = 0.0f;
  wait_ring();
  __syncthreads();  // the first ring row

  const int nf = c.t_live - 1;
  for (int i = 0; i < nf; ++i) {
    const int t = c.t_live - 1 - i;
    const float* gcur = (i & 1) ? g1 : g0;
    float* gnext = (i & 1) ? g0 : g1;
    const float* prev = c.ring + static_cast<long>(i % kRing) * (2 * S + c.L);
    const float* zr = prev + S;
    const float* shr = prev + 2 * S;
    fetch_chain_row(c, i + kRing - 1);
    float* dem_t = c.dem_b + static_cast<long>(t) * S;
    // dem (and dz) by the block's last warps, as the ring row's copy
    for (int u = blockDim.x - 1 - threadIdx.x; u < S; u += blockDim.x) {
      const bool lab = p.jslot[u] >= 0;
      const float ga = lab ? gcur[u] : 0.0f;
      dem_t[u] = ga;
      if (c.dz_b != nullptr && lab)
        c.dz_b[static_cast<long>(t) * S + u] = ga * zr[u];
    }
    if (kRegs) {
      if (mine) {
        float sum = 0.0f;
        const float ps = prev[tk.s < S ? tk.s : 0];
#pragma unroll
        for (int k = 0; k < kCap; ++k) {
          if (k < tk.n) {
            const float term = arc_term(c.arcs[tk.a0 + k * g], ps, tk.s, p.wt, S, zr, shr, gcur);
            sum += term;
            acc[k] += term;
          }
        }
        store_sum(tk.s, sum, g, S, gnext, lane);
      }
    } else {
      for (int r = warp; r < c.rounds; r += nwarps) {
        const SrcTask st = source_task(p, r, lane, S, g);
        float sum = 0.0f;
        const float ps = prev[st.s < S ? st.s : 0];
        for (int k = 0; k < st.n; ++k) {
          const int a = st.a0 + k * g;
          const float term = arc_term(c.arcs[a], ps, st.s, p.wt, S, zr, shr, gcur);
          sum += term;
          c.acc[a] += term;
        }
        store_sum(st.s, sum, g, S, gnext, lane);
      }
    }
    wait_ring();
    __syncthreads();  // gnext complete, the next ring row landed
  }
  if (kRegs) {
#pragma unroll
    for (int k = 0; k < kCap; ++k)
      if (k < tk.n) c.acc[tk.a0 + k * g] = acc[k];
  }
}

__global__ void __launch_bounds__(kFactThreads)
factored_chain_kernel(const float* __restrict__ traj, const float* __restrict__ adj,
                      const float* __restrict__ wsel, const int* __restrict__ lab_idx,
                      const int* __restrict__ lens, const float* __restrict__ g_final,
                      const float* __restrict__ sh_s, const float* __restrict__ z_s,
                      float* __restrict__ dz_s, int* __restrict__ jslot_s,
                      float* __restrict__ dem, float* __restrict__ dwsel,
                      float* __restrict__ dws, int* __restrict__ arcs_g, int T, int S,
                      int N, int L, int smem_words) {
  extern __shared__ __align__(16) int fact_smem[];
  const FactSmem lay = fact_layout(S, N, L, 2 * S);
  const FactPtrs p = fact_ptrs(fact_smem, lay);
  const int b = blockIdx.x;
  const float* A = adj + static_cast<long>(b) * S * S;
  compact_members(lab_idx + static_cast<long>(b) * S, S, N, p);
  const int Lu = p.misc[kNlab];
  const int S_l = p.mem_ptr[Lu];
  const int t_live = live_steps(lens[b], T);
  source_degrees(A, S, S_l, p, p.rnd);
  __syncthreads();
  offsets(p.rnd, p.arc_ptr, S);
  __syncthreads();
  const int ring_words = kRing * (2 * S + L);
  if (threadIdx.x == 0) {
    const int nnz = p.arc_ptr[S];
    int maxdeg = 0;
    for (int s = 0; s < S; ++s) maxdeg = max(maxdeg, p.arc_ptr[s + 1] - p.arc_ptr[s]);
    const int g = group_width(maxdeg);
    const int rounds = (S * g + 31) / 32;
    const int nwarps = blockDim.x >> 5;
    p.misc[kNnz] = nnz;
    p.misc[kGroup] = g;
    p.misc[kRounds] = rounds;
    const bool global = 3L * nnz + ring_words > smem_words - lay.arena;
    p.misc[kRoute] = global ? kRouteGlobal
                     : ((rounds + nwarps - 1) / nwarps <= kRegRounds && maxdeg <= g * kCap)
                         ? kRouteRegisters : kRouteShared;
  }
  __syncthreads();
  const int nnz = p.misc[kNnz];
  const int route = p.misc[kRoute];
  int2* arcs;
  float* acc;
  float* ring;
  if (route == kRouteGlobal) {
    arcs = reinterpret_cast<int2*>(arcs_g + 3L * b * S * S);
    acc = reinterpret_cast<float*>(arcs_g + 3L * b * S * S + 2L * S * S);
    ring = reinterpret_cast<float*>(p.arena);
  } else {
    arcs = reinterpret_cast<int2*>(p.arena);
    acc = reinterpret_cast<float*>(p.arena + 2 * nnz);
    ring = acc + nnz;
  }
  const float* tr_b = traj + static_cast<long>(b) * T * S;
  const ChainArgs c{tr_b, sh_s + static_cast<long>(b) * T * L,
                    z_s + static_cast<long>(b) * T * S,
                    dz_s ? dz_s + static_cast<long>(b) * T * S : nullptr,
                    dem + static_cast<long>(b) * T * S, arcs, acc, ring, S, L, Lu, t_live,
                    p.misc[kGroup], p.misc[kRounds]};
  fill_source_arcs(A, S, S_l, p, arcs);
  fill_wt(wsel + static_cast<long>(b) * S * N, S, N, Lu, p);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    p.vec[s] = g_final[static_cast<long>(b) * S + s];
    jslot_s[static_cast<long>(b) * S + s] = p.jslot[s];
  }
  if (route != kRouteRegisters)
    for (int k = threadIdx.x; k < nnz; k += blockDim.x) acc[k] = 0.0f;
  for (int t = t_live; t < T; ++t)
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      c.dem_b[static_cast<long>(t) * S + s] = 0.0f;
  float* dw_b = dwsel + static_cast<long>(b) * S * N;
  for (long i = threadIdx.x; i < static_cast<long>(S) * N; i += blockDim.x) dw_b[i] = 0.0f;
  // the statistics pass's results: the launch lets this block's prologue
  // overlap that pass (programmatic dependent launch); wait for it here
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int r = 0; r < kRing - 1; ++r) fetch_chain_row(c, r);
  // (the first barrier of chain_frames publishes all of these)

  if (route == kRouteRegisters)
    chain_frames<true>(p, c);
  else
    chain_frames<false>(p, c);
  __pipeline_wait_prior(0);

  // frame 0, entered from the start potentials
  const float* g = ((t_live - 1) & 1) ? p.vec + S : p.vec;
  for (int u = threadIdx.x; u < S; u += blockDim.x) {
    const bool lab = p.jslot[u] >= 0;
    const float rz0 = lab ? c.z_b[u] : 0.0f;
    const float ga = (rz0 > 0.0f && lab) ? g[u] : 0.0f;
    c.dem_b[u] = ga;
    dws[static_cast<long>(b) * S + u] = ga;
    if (c.dz_b != nullptr && lab) c.dz_b[u] = ga * rz0;
  }
  __syncthreads();  // every arc's sum stored
  // dwsel[s, l]: each source's arcs run by slot (member order), one writer
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    int k = p.arc_ptr[s];
    while (k < p.arc_ptr[s + 1]) {
      const int j = arcs[k].x >> 16;
      float sum = 0.0f;
      for (; k < p.arc_ptr[s + 1] && (arcs[k].x >> 16) == j; ++k) sum += acc[k];
      dw_b[static_cast<long>(s) * N + p.label_of[j]] = sum;
    }
  }
}

// dadj[u, s] = sum over the live frames t >= 1 (in decreasing t) of
// dz_t[u] exp((traj[t-1, s] + wsel[s, l_u]) - sh_t[j_u]), plus dz_0[u] e0[s];
// zero for rows without a label.  Grid (B, row blocks), a thread an entry.
__global__ void factored_dadj_kernel(const float* __restrict__ traj,
                                     const float* __restrict__ wsel,
                                     const int* __restrict__ lab_idx,
                                     const float* __restrict__ start,
                                     const int* __restrict__ lens,
                                     const int* __restrict__ jslot_s,
                                     const float* __restrict__ sh_s,
                                     const float* __restrict__ dz_s,
                                     float* __restrict__ dadj, int T, int S, int N, int L,
                                     int rows) {
  const int b = blockIdx.x;
  const int t_live = live_steps(lens[b], T);
  const long n = static_cast<long>(rows) * S;
  for (long i = threadIdx.x; i < n; i += blockDim.x) {
    const int u = blockIdx.y * rows + static_cast<int>(i / S);
    const int s = static_cast<int>(i % S);
    if (u >= S) break;
    const int j = jslot_s[static_cast<long>(b) * S + u];
    float acc = 0.0f;
    if (j >= 0) {
      const int l = lab_idx[static_cast<long>(b) * S + u];
      const float w = wsel[(static_cast<long>(b) * S + s) * N + l];
      const float* tr_b = traj + static_cast<long>(b) * T * S;
      const float* dz_b = dz_s + static_cast<long>(b) * T * S;
      const float* sh_b = sh_s + static_cast<long>(b) * T * L;
      for (int t = t_live - 1; t >= 1; --t)
        acc += dz_b[static_cast<long>(t) * S + u] *
               expf((tr_b[static_cast<long>(t - 1) * S + s] + w) - sh_b[static_cast<long>(t) * L + j]);
      acc += dz_b[u] * start_e(start[static_cast<long>(b) * S + s]);
    }
    dadj[(static_cast<long>(b) * S + u) * S + s] = acc;
  }
}

// One frame of the factored chain without arcs: a dependent shared-memory
// load, one expf and one logf, and a block barrier, `frames` times, in each
// of B blocks.
__global__ void factored_chain_probe_kernel(float* __restrict__ out, int frames) {
  __shared__ float buf[2][64];
  for (int k = threadIdx.x; k < 64; k += blockDim.x) buf[0][k] = 1e-3f * k;
  __syncthreads();
  const int i = threadIdx.x & 63;
  float x = 0.0f;
  for (int f = 0; f < frames; ++f) {
    x = logf(expf(buf[f & 1][i]) + 1.0f) - 0.6931472f;
    if (threadIdx.x < 64) buf[(f + 1) & 1][(i * 7 + 1) & 63] = x;
    __syncthreads();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = x;
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

// em [B, T, S], adj [B, S, S], wsel [B, S, N], ws/start [B, S] f32,
// lab_idx [B, S] i32 (each state's in-label in [0, N), -1 for none), lens
// [B] i32 -> traj [B, T, S] f32.  One block of kFactThreads a sample, with
// max_smem bytes of shared memory: the plan, the label columns and the
// vectors, then the arcs and the emission rows as they fit.
int factored_scan_fwd(const float* em, const float* adj, const float* wsel,
                      const int* lab_idx, const float* ws, const float* start,
                      const int* lens, float* traj, int B, int T, int S, int N,
                      int max_smem, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const int L = S < N ? S : N;
  if (L > kMaxSlots || S >= 65536) return static_cast<int>(cudaErrorInvalidValue);
  const FactSmem lay = fact_layout(S, N, L, 3 * S);
  const int words = max_smem / 4;
  if (lay.arena + kRing * S > words) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(factored_scan_fwd_kernel, max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  factored_scan_fwd_kernel<<<B, kFactThreads, max_smem, static_cast<cudaStream_t>(stream)>>>(
      em, adj, wsel, lab_idx, ws, start, lens, traj, T, S, N, L, words);
  return static_cast<int>(cudaGetLastError());
}

// traj [B, T, S], adj [B, S, S], wsel [B, S, N], start/g_final [B, S] f32,
// lab_idx [B, S] i32, lens [B] i32 -> dem [B, T, S], dwsel [B, S, N], dws
// [B, S] and, unless dadj is null, dadj [B, S, S] f32; scratch holds sh
// [B, T, Lmax], rz [B, T, S], the slots [B, S] (int32), with dadj dz
// [B, T, S], and, where a dense adjacency's arcs and sums (3 S^2 words)
// could not fit in shared memory beside the chain's ring, 3 S^2 words a
// sample (ops/dense_scan_pallas.py _bwd_scratch_words).  Two launches
// (statistics, chain), a third for dadj.
int factored_scan_bwd(const float* traj, const float* adj, const float* wsel,
                      const int* lab_idx, const float* start, const int* lens,
                      const float* g_final, float* dem, float* dadj, float* dwsel,
                      float* dws, float* scratch, int B, int T, int S, int N,
                      int max_smem, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int L = S < N ? S : N;
  if (L > kMaxSlots || S >= 65536) return static_cast<int>(cudaErrorInvalidValue);
  const int words = max_smem / 4;
  const FactSmem stats = fact_layout(S, N, L, (1 + kFactWarps) * S);
  const FactSmem chain = fact_layout(S, N, L, 2 * S);
  if (stats.arena > words || chain.arena + kRing * (2 * S + L) > words)
    return static_cast<int>(cudaErrorInvalidValue);
  float* sh_s = scratch;
  float* z_s = sh_s + static_cast<long>(B) * T * L;
  int* jslot_s = reinterpret_cast<int*>(z_s + static_cast<long>(B) * T * S);
  float* dz_s = reinterpret_cast<float*>(jslot_s + static_cast<long>(B) * S);
  int* arcs_g = reinterpret_cast<int*>(dz_s + (dadj ? static_cast<long>(B) * T * S : 0));

  // the statistics pass: its arcs in shared memory up to 72 KB a block
  // (else its dense rows from global memory), so that three blocks share
  // an SM, and as many frame chunks a sample as the card holds at once
  long want = stats.arena + 2L * S * S;
  const long cap = stats.arena + 2048 > 18432 ? stats.arena + 2048 : 18432;
  want = want < cap ? want : cap;
  const int stats_smem = static_cast<int>((want < words ? want : words) * 4);
  cudaError_t err = allow_smem(factored_stats_kernel, stats_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, factored_stats_kernel, kFactThreads,
                                                stats_smem);
  int chunks = sms * (per_sm < 1 ? 1 : per_sm) / B;
  chunks = chunks < 1 ? 1 : (chunks > T ? T : chunks);
  const int per = (T + chunks - 1) / chunks;
  chunks = (T + per - 1) / per;
  factored_stats_kernel<<<dim3(B, chunks), kFactThreads, stats_smem, st>>>(
      traj, adj, wsel, lab_idx, start, lens, sh_s, z_s, T, S, N, L, stats_smem / 4, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_smem(factored_chain_kernel, max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // launched as the statistics pass's programmatic dependent: its prologue
  // (which reads none of that pass's results) overlaps the pass
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(kFactThreads);
  cfg.dynamicSmemBytes = max_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  float* dz_arg = dadj ? dz_s : nullptr;
  err = cudaLaunchKernelEx(&cfg, factored_chain_kernel, traj, adj, wsel, lab_idx, lens,
                           g_final, static_cast<const float*>(sh_s),
                           static_cast<const float*>(z_s), dz_arg, jslot_s, dem, dwsel, dws,
                           arcs_g, T, S, N, L, words);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || dadj == nullptr) return static_cast<int>(err);

  const int rows = S >= 1024 ? 1 : 1024 / S;
  int threads = rows * S < 1024 ? rows * S : 1024;
  threads = (threads + 31) / 32 * 32;
  factored_dadj_kernel<<<dim3(B, (S + rows - 1) / rows), threads, 0, st>>>(
      traj, wsel, lab_idx, start, lens, jslot_s, sh_s, dz_s, dadj, T, S, N, L, rows);
  return static_cast<int>(cudaGetLastError());
}

// B blocks of `threads` threads run `frames` frames of the factored chain
// without arcs (factored_chain_probe_kernel); out [B threads] f32.
int factored_chain_probe(float* out, int B, int threads, int frames, void* stream) {
  factored_chain_probe_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, frames);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
