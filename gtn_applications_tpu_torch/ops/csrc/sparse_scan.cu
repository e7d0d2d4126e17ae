// Sparse-arc lattice recursions over compiled WFST arc tables: one step
// (seg_lse) and the whole scan with its epsilon closure, each with the
// reverse replay for the cotangents; the tropical step with its
// backpointers (seg_max); and the whole tropical scan with its backtrace
// (seg_max_scan) that the Viterbi decode of a table the bucket plan refuses
// runs, one launch a batch.
//
// Replaces gtn_applications_tpu/ops/seglse_pallas.py: _fwd_kernel (:69) and
// _bwd_kernel (:97), wrapped there by seg_lse (:139);
// gtn_applications_tpu/ops/sparse_scan_pallas.py: _fwd_kernel (:265) and
// _bwd_kernel (:312), wrapped there by sparse_scan (:450); and
// gtn_applications_tpu/ops/segmax_pallas.py: _kernel (:41), wrapped there by
// seg_max (:80), which gtn_applications_tpu/ops/sparse.py
// _viterbi_batched_pallas scans over the frames.  seg_max and seg_max_scan
// are described above their kernels, below.
//
// One step, for each destination state s of sample b:
//   c[a]   = (alpha[src[a]] + w[a]) + em[a]          (NEG where src < 0)
//   m      = max(max over arcs a into s of c[a], NEG)
//   z      = sum over those arcs with c[a] > DEAD of exp(c[a] - m)
//   new[s] = z > 0 ? m + log(max(z, 1e-30)) : NEG
// and its VJP dc[a] = (c > DEAD && z > 0) ? exp(c - m) / z g[s] : 0 (the
// posterior from the destination's own shift: seg_lse saves m and z, the
// whole scan recomputes them), dalpha[u] = sum over arcs from u of dc.
// The whole scan runs that
// step each frame with em[a] = em[b, t, label[a]], then eps_depth rounds of
// the epsilon closure (cur_d = step(cur_{d-1}) over the epsilon arcs, acc_d
// = logaddexp(acc_{d-1}, cur_d), dead inputs masked), and keeps alpha past
// a sample's length.  After each live frame the kernel subtracts the frame's
// largest alpha (0 if every state is dead) and adds it to the sample's
// running shift: the trajectory holds alpha relative to shift[b, t], so the
// values the posteriors compare stay small (at alpha ~ 700, one fp32 ulp is
// 6e-5, and exp(c - y) between two summation orders would differ by that),
// and the shift, which the gradient does not depend on, carries the rest.
// The forward carries alpha in float64 and rounds it to float only where
// it writes the trajectory (its shifts within a row, exponentials, sums
// and logarithms stay float: value_f, lae_f): a float state
// rounds a few times a frame, and over 576 frames a state 60-80 nats below
// the frame's largest drifted 1.8e-3 from the float64 recursion.
// Its backward recomputes each live frame's chain from
// the saved trajectory and runs it in reverse (the closure's logaddexp,
// then each epsilon step's VJP, then the arc step's), writing dem [B, T, C]
// by label, and accumulating dw [B, A] and deps [B, E] per sample.
//
// The TPU kernels recast the segment reductions as one-hot matmuls for the
// MXU and shift each row by its largest contribution.  Here the arcs are
// sorted by destination on the host (ops/seglse_pallas.py arc_index), and
// every destination gets its own shift (the plain forward_score's
// arithmetic).  seg_lse spreads its rows over a grid (below, above its
// kernels).  The whole scan
// runs a thread-block cluster of k blocks (1, 2, 4 or 8: the most with
// B k blocks on the card's 132 multiprocessors) per sample, on a schedule
// built once per table (ops/sparse_scan_pallas.py build_schedule):
//   - each block (rank) owns a contiguous range of states, cut so that
//     each holds about A / k of the arcs into them, and a range of labels;
//   - within a rank, each row (a destination, or in the backward a source
//     or a label) goes to a group of 1, 4, 8 or 32 lanes by its in-degree,
//     each lane holding up to 8 of its arcs in registers; a group reduces
//     with segmented shuffles, a max pass and then a sum pass; a hub of
//     more than 256 arcs is cut into chunks of a warp each, whose maxima
//     meet in shared memory before the sum pass, and then their sums, so
//     the hub keeps its own shift;
//   - after each phase (the arc step, each closure round) a block writes
//     its states' values into every block's copy of the state vector
//     through distributed shared memory, and cluster.sync() orders the
//     phases; the frame shift is computed by every block from its copy
//     of acc, so all agree;
//   - the backward keeps the float64 state of its own states only (in
//     shared memory; in a global scratch slice where even that does not
//     fit), and its sums by source and by label read the posteriors of
//     other blocks' arcs through distributed shared memory at (rank,
//     offset) codes computed on the host: no atomics, so the results are
//     deterministic.
// The tables, codes and schedule of a rank are staged in its shared memory
// when they fit.
//
// What bounds it on the H100: per frame a sample does ~10 fp32 operations
// an arc and ~15 an epsilon arc per closure round, a few MFLOP a frame at
// the 1k-wordpiece normaliser, microseconds at 67 TFLOP/s; the bytes
// (em rows, tables, trajectory) are a few MB.  The kernels instead wait on
// the chain of T frames, each 1 + depth phases forward (2 depth + 1
// backward) of one group reduction and one cluster barrier; the latency
// probe sparse_scan_probe times a phase without arcs.  Built without
// --use_fast_math: exact expf/logf.

#include <climits>
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
// NEG / 2 as the plain versions compare with it (a float32 tensor against
// the Python float -5e29)
constexpr float kHalfNeg = -5e29f;
constexpr float kDead = -1e28f;
constexpr float kFloor = 1e-30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kScanThreads = 512;

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

// The posterior of one contribution c into a destination of shift and sum
// sg, times the destination's cotangent g: exp(c - m) / z, formed from the
// destination's own shift (as autodiff of the plain version forms it), so
// the result is as precise as z, whatever the size of m.
template <typename V>
__device__ __forceinline__ V posterior(V c, Seg<V> sg, V g) {
  return (c > V(kDead) && sg.z > V(0)) ? ex(c - sg.m) / sg.z * g : V(0);
}

// A Seg's value and logaddexp of double values by float exp and log (the
// forward scan's): z is a float sum, and the logaddexp's sum lies in
// [1, 2], so the float log loses nothing the double result keeps.
__device__ __forceinline__ double value_f(Seg<double> sg) {
  const float z = static_cast<float>(sg.z);
  return z > 0.0f ? sg.m + static_cast<double>(logf(fmaxf(z, kFloor)))
                  : static_cast<double>(kNeg);
}

__device__ __forceinline__ double lae_f(double a, double b) {
  const double m = fmax(fmax(a, b), static_cast<double>(kNeg));
  const float s = (a > kDead ? expf(static_cast<float>(a - m)) : 0.0f) +
                  (b > kDead ? expf(static_cast<float>(b - m)) : 0.0f);
  return s > 0.0f ? m + static_cast<double>(logf(fmaxf(s, kFloor)))
                  : static_cast<double>(kNeg);
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

// ---------------------------------------------------------------------------
// seg_lse: one step with per-arc emissions em[a]
// ---------------------------------------------------------------------------

// The TPU pair (seglse_pallas.py _fwd_kernel, _bwd_kernel) scans tiles of
// arcs against one-hot [tile, S] masks on the MXU.  Here the work is one
// step over a few thousand arcs (the 1kwp normaliser's start closure: S =
// 1,004, 1,183 epsilon arcs, 99.8 % of the states without one, a hub of
// in-degree 1,002 and a row of 181), so what bounds it is latency: the
// launch and a chain of three dependent loads (the row's pointers, the
// arc's source and original id, then alpha, w and em).  The design keeps
// that chain short and spreads it over the card:
// - a grid of B x ceil(S / 256) blocks, a block 256 rows (destinations in
//   the forward, sources in the backward), a thread a row: its pointers
//   give the row's in- (out-) degree n;
// - each warp packs its own 32 rows into passes (warp_rows): a row of n
//   arcs takes a group of g = 1, 2, 4, 8, 16 or 32 lanes, the fewest that
//   hold n at 8 arcs a lane (in registers), none without arcs; the groups
//   are laid out widest first, so each sits on a multiple of its width
//   and a pass of 32 lanes mixes widths (a warp of short rows is one
//   pass); a group reduces by xor shuffles that stay inside it.  The
//   schedule is derived in the kernel from the pointers by ballots:
//   nothing is built on the host.  (16 arcs a lane halves the passes of
//   rows of 9-16 arcs but doubles every lane's predicated loads: slower
//   on every table but the 4-gram normaliser);
// - a lane loads its arcs in two rounds, each issued whole before any of
//   its values is used (every source and id, then every alpha, w and em,
//   at clamped addresses so that no load sits behind a branch): a pass
//   waits on two loads, not on two an arc;
// - a hub (n > 256) is taken by the warps that have no rows of their own
//   (by all, where every warp has some) while the others run their
//   passes; each of its threads holds 8 of its arcs in registers (more
//   rounds past that), and the warps' maxima and then their sums meet in
//   shared memory in warp order, so the hub keeps its own shift;
// - the arcs are read through the index (ops/seglse_pallas.py ArcIndex):
//   w and em at each arc's original id, so no gather into the sorted order
//   runs before the kernel and dcontrib is written in the arcs' own order;
//   em may be absent (the epsilon closure);
// - the forward writes each destination's shift m and sum z when autograd
//   will need them; the backward is one pass by source from them: an
//   arc's cotangent exp(c - m[d]) / z[d] g[d] needs only its own
//   destination's saved values, and the source's group sums its arcs' in a
//   fixed order (no atomics: deterministic).  It keeps the division, as
//   the plain version has it, and forms the posterior from the port's own
//   shift, not from JAX's residual out (exp(c - out) would turn the
//   rounding of out, an ulp of 6e-5 at |out| ~ 700, into a relative error
//   of the posterior).
// With `staged` (the wrapper's choice: where the copy takes at most 4
// loads a thread), the forward copies the vectors a lane reads at an arc's
// source and id (alpha, w, em) into shared memory while the row pointers
// load, so a pass waits on two loads from device memory (the pointers, then
// the arcs' sources and ids) and reads the rest from shared memory; else
// they are gathered from device memory (__ldg).  The copy is a chain of
// loads of its own, and on larger tables it costs more than it saves (the
// backward's five vectors never paid).

constexpr int kStepThreads = 256;
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepArcs = 8;                 // arcs a lane holds in registers
constexpr int kHubArcs = 32 * kStepArcs;     // a row of more arcs is a hub

// The lanes of a row of n arcs: 0 (no arcs), the fewest lanes g of 1, 2,
// 4, 8, 16 or 32 that hold them at kStepArcs a lane, or -1 (a hub).
__device__ __forceinline__ int row_width(int n) {
  if (n == 0) return 0;
  if (n > kHubArcs) return -1;
  int g = 1;
  while (g * kStepArcs < n) g <<= 1;
  return g;
}

// Reductions over aligned groups of g lanes, g a power of two that may
// differ from lane to lane: every lane takes part in every shuffle, and
// keeps the partner's value only while the partner is in its group.
template <typename Op>
__device__ __forceinline__ float mixed_reduce(float v, int g, Op op) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(kFull, v, off);
    if (off < g) v = op(v, o);
  }
  return v;
}

// The passes of a warp over its 32 rows, lane l's own row at positions
// [beg, end) of width w (row_width): the rows with arcs are laid out on
// lane positions widest first (each width's rows in lane order), so each
// group sits on a multiple of its width, and pass p takes positions 32 p ..
// 32 p + 31.  Every lane calls fn(own, b0, e0, g, sub) in every pass, where
// own is the lane that owns the row the lane serves (-1: no row; the lane
// still takes part in the shuffles), [b0, e0) its positions, g its
// group's width and sub the lane's place in it.  `list` is the warp's 32
// words of shared memory: the owners, widest rows first.
template <typename F>
__device__ __forceinline__ void warp_rows(int beg, int end, int w, int* list, F fn) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  // per width 2^e, widest first: its first row in the list and first position
  int row0[6], pos0[6], rows = 0, total = 0;
#pragma unroll
  for (int e = 5; e >= 0; --e) {
    const unsigned mask = __ballot_sync(kFull, w == 1 << e);
    if (w == 1 << e) list[rows + __popc(mask & below)] = lane;
    row0[e] = rows;
    pos0[e] = total;
    rows += __popc(mask);
    total += __popc(mask) << e;
  }
  __syncwarp();
  for (int p0 = 0; p0 < total; p0 += 32) {
    const int p = p0 + lane;
    int g = 1, i = -1, sub = 0;
#pragma unroll
    for (int e = 5; e >= 0; --e) {
      const int end_e = e > 0 ? pos0[e - 1] : total;  // the next width starts there
      if (p >= pos0[e] && p < end_e) {
        g = 1 << e;
        i = row0[e] + ((p - pos0[e]) >> e);
        sub = (p - pos0[e]) & (g - 1);
      }
    }
    const int own = i >= 0 ? list[i] : -1;
    const int b0 = __shfl_sync(kFull, beg, own & 31);
    const int e0 = __shfl_sync(kFull, end, own & 31);
    fn(own, b0, own >= 0 ? e0 : b0, g, sub);
  }
  __syncwarp();
}

// The block's hubs and the warps that take them.  Each warp lists its own
// hubs (hub_row: the owner lane, hub_n: how many) and whether it has rows
// for passes before the barrier; the hub warps are those without (all
// warps where every warp has some).  Returns whether the block has a hub,
// and in hw this warp's rank among the hub warps (-1: not one) and their
// number.
struct HubWarps {
  int rank, count;
};

__device__ __forceinline__ bool hubs_pending(int w, int* hub_row, int* hub_n, int* busy,
                                             HubWarps& hw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned mask = __ballot_sync(kFull, w < 0);
  const bool rows = __ballot_sync(kFull, w > 0) != 0;
  if (w < 0) hub_row[warp * 32 + __popc(mask & ((1u << lane) - 1u))] = lane;
  if (lane == 0) {
    hub_n[warp] = __popc(mask);
    busy[warp] = rows;
  }
  if (!__syncthreads_or(w < 0)) return false;
  unsigned idle = 0;
  for (int q = 0; q < kStepWarps; ++q) idle |= busy[q] ? 0u : 1u << q;
  if (!idle) idle = (1u << kStepWarps) - 1u;
  hw.count = __popc(idle);
  hw.rank = idle >> warp & 1u ? __popc(idle & ((1u << warp) - 1u)) : -1;
  return true;
}

// The arcs of one step: sorted position k (destination order) has source
// src[k] and original id arc[k]; w and em (kEm) are read at arc[k].
struct StepArcs {
  const int* src;
  const int* arc;
  const float* w;
  const float* em;
};

// A load from a staged copy in shared memory (kShared) or through the
// read-only cache.
template <bool kShared, typename T>
__device__ __forceinline__ T ld(const T* p, int i) {
  return kShared ? p[i] : __ldg(p + i);
}

// A lane's arcs at positions k0, k0 + stride, ... (below end; kStepArcs of
// them) in two rounds of loads, each issued whole before any of its values
// is used: every source and id, then every alpha, w and em (at addresses
// clamped into their arrays, so that no load waits on a branch); -inf past
// end.
template <bool kStaged, bool kEm>
__device__ __forceinline__ void lane_contribs(const StepArcs& arcs, const float* al, int k0,
                                              int stride, int end, float* c) {
  int u[kStepArcs], id[kStepArcs];
#pragma unroll
  for (int j = 0; j < kStepArcs; ++j) {
    const int k = k0 + j * stride;
    u[j] = k < end ? __ldg(arcs.src + k) : INT_MIN;
    id[j] = k < end ? __ldg(arcs.arc + k) : 0;
  }
  float a[kStepArcs], wv[kStepArcs], ev[kStepArcs];
#pragma unroll
  for (int j = 0; j < kStepArcs; ++j) {
    a[j] = ld<kStaged>(al, max(u[j], 0));
    wv[j] = ld<kStaged>(arcs.w, id[j]);
    ev[j] = kEm ? ld<kStaged>(arcs.em, id[j]) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kStepArcs; ++j) {
    const float x = (u[j] >= 0 ? a[j] : kNeg) + wv[j];
    c[j] = u[j] == INT_MIN ? -INFINITY : kEm ? x + ev[j] : x;
  }
}

template <bool kStaged, bool kEm>
__global__ void __launch_bounds__(kStepThreads)
seg_lse_fwd_kernel(const float* __restrict__ alpha, const int* __restrict__ dptr,
                   const int* __restrict__ src, const int* __restrict__ arc,
                   const float* __restrict__ w, const float* __restrict__ em,
                   float* __restrict__ out, float* __restrict__ m_out,
                   float* __restrict__ z_out, int S, int A, int sb, int wb, int eb) {
  extern __shared__ float staged[];
  __shared__ int list[kStepWarps][32];
  __shared__ int hub_row[kStepThreads];
  __shared__ int hub_n[kStepWarps], busy[kStepWarps];
  __shared__ float part_m[kStepWarps], part_z[kStepWarps];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kStepThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long so = sb ? static_cast<long>(b) : 0;
  const int* P = dptr + so * (S + 1);
  const int r = r0 + threadIdx.x;
  const int beg = r < S ? P[r] : 0, end = r < S ? P[r + 1] : 0;
  StepArcs arcs{src + so * A, arc + so * A, w + (wb ? static_cast<long>(b) * A : 0),
                kEm ? em + (eb ? static_cast<long>(b) * A : 0) : nullptr};
  const float* al = alpha + static_cast<long>(b) * S;
  if (kStaged) {
    Carve cv{staged};
    al = stage(al, S, cv.floats(S));
    arcs.w = stage(arcs.w, A, cv.floats(A));
    if (kEm) arcs.em = stage(arcs.em, A, cv.floats(A));
    __syncthreads();
  }
  auto emit = [&](int r, float m, float z) {
    const long o = static_cast<long>(b) * S + r;
    out[o] = Seg<float>{m, z}.value();
    if (m_out) {
      m_out[o] = m;
      z_out[o] = z;
    }
  };
  const int wd = row_width(end - beg);
  if (wd == 0 && r < S) emit(r, kNeg, 0.0f);
  HubWarps hw{-1, 0};
  const bool hubs = hubs_pending(wd, hub_row, hub_n, busy, hw);
  // hub warps take the hubs first, the others their passes first
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == (hw.rank >= 0 ? 1 : 0)) {
      warp_rows(beg, end, wd, list[warp], [&](int own, int b0, int e0, int g, int sub) {
        float c[kStepArcs];
        lane_contribs<kStaged, kEm>(arcs, al, b0 + sub, g, e0, c);
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < kStepArcs; ++j) m = fmaxf(m, c[j]);
        m = fmaxf(mixed_reduce(m, g, [](float x, float y) { return fmaxf(x, y); }), kNeg);
        float z = 0.0f;
#pragma unroll
        for (int j = 0; j < kStepArcs; ++j)
          if (c[j] > kDead) z += expf(c[j] - m);
        z = mixed_reduce(z, g, [](float x, float y) { return x + y; });
        if (sub == 0 && own >= 0) emit(r0 + warp * 32 + own, m, z);
      });
    }
    if (phase == 1 || !hubs) continue;
    // this thread's first hub position (none past the hub warps)
    const int ht = hw.rank >= 0 ? hw.rank * 32 + lane : 0, stride = hw.count * 32;
    for (int q = 0; q < kStepWarps; ++q) {
      for (int i = 0; i < hub_n[q]; ++i) {
        const int h = r0 + q * 32 + hub_row[q * 32 + i];
        const int hb = P[h], he = hw.rank >= 0 ? P[h + 1] : hb;
        float c[kStepArcs];
        lane_contribs<kStaged, kEm>(arcs, al, hb + ht, stride, he, c);
        float m = -INFINITY;
#pragma unroll
        for (int j = 0; j < kStepArcs; ++j) m = fmaxf(m, c[j]);
        const int k1 = hb + kStepArcs * stride + ht;  // rounds past the registers
        float more[kStepArcs];
        for (int k = k1; k < he; k += kStepArcs * stride) {
          lane_contribs<kStaged, kEm>(arcs, al, k, stride, he, more);
#pragma unroll
          for (int j = 0; j < kStepArcs; ++j) m = fmaxf(m, more[j]);
        }
        m = warp_max(m);
        if (lane == 0) part_m[warp] = m;
        __syncthreads();
        m = part_m[0];
        for (int x = 1; x < kStepWarps; ++x) m = fmaxf(m, part_m[x]);
        m = fmaxf(m, kNeg);
        float z = 0.0f;
#pragma unroll
        for (int j = 0; j < kStepArcs; ++j)
          if (c[j] > kDead) z += expf(c[j] - m);
        for (int k = k1; k < he; k += kStepArcs * stride) {
          lane_contribs<kStaged, kEm>(arcs, al, k, stride, he, more);
#pragma unroll
          for (int j = 0; j < kStepArcs; ++j)
            if (more[j] > kDead) z += expf(more[j] - m);
        }
        z = warp_sum(z);
        if (lane == 0) part_z[warp] = z;
        __syncthreads();
        if (threadIdx.x == 0) {
          z = 0.0f;
          for (int x = 0; x < kStepWarps; ++x) z += part_z[x];
          emit(h, m, z);
        }
      }
    }
  }
}

// By source: sptr [rows, S + 1] delimits each source's positions j, and
// sarc[j] / sdst[j] are the arc's original id and destination (-1 where
// invalid); positions past sptr[S] hold the arcs without a valid source.
// The cotangents of a lane's arcs at positions j0, j0 + stride, ... (below
// end; kStepArcs of them) from their source's value a, in two rounds of
// loads (ids and destinations, then w, em, m, z and g), written to dc
// (where it is not null); returns their sum, in position order.
struct StepGrad {
  const int* sarc;
  const int* sdst;
  const float* w;
  const float* em;
  const float* m;
  const float* z;
  const float* g;
  float* dc;
  // as lane_contribs: ids and destinations, then every w, em, m, z and g
  template <bool kEm>
  __device__ __forceinline__ float lane_sum(int j0, int stride, int end, float a) const {
    int id[kStepArcs], d[kStepArcs];
#pragma unroll
    for (int j = 0; j < kStepArcs; ++j) {
      const int k = j0 + j * stride;
      id[j] = k < end ? __ldg(sarc + k) : -1;
      d[j] = k < end ? __ldg(sdst + k) : -1;
    }
    float wv[kStepArcs], ev[kStepArcs], mv[kStepArcs], zv[kStepArcs], gv[kStepArcs];
#pragma unroll
    for (int j = 0; j < kStepArcs; ++j) {
      const int i = max(id[j], 0), q = max(d[j], 0);
      wv[j] = __ldg(w + i);
      ev[j] = kEm ? __ldg(em + i) : 0.0f;
      mv[j] = __ldg(m + q);
      zv[j] = __ldg(z + q);
      gv[j] = __ldg(g + q);
    }
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kStepArcs; ++j) {
      if (id[j] < 0) continue;
      const float c = kEm ? (a + wv[j]) + ev[j] : a + wv[j];
      const float v =
          d[j] >= 0 && c > kDead && zv[j] > 0.0f ? expf(c - mv[j]) / zv[j] * gv[j] : 0.0f;
      if (dc) dc[id[j]] = v;
      s += v;
    }
    return s;
  }
};

template <bool kEm>
__global__ void __launch_bounds__(kStepThreads)
seg_lse_bwd_kernel(const float* __restrict__ alpha, const float* __restrict__ g,
                   const float* __restrict__ m_in, const float* __restrict__ z_in,
                   const int* __restrict__ sptr, const int* __restrict__ sarc,
                   const int* __restrict__ sdst, const float* __restrict__ w,
                   const float* __restrict__ em, float* __restrict__ dalpha,
                   float* __restrict__ dcontrib, int S, int A, int sb, int wb, int eb) {
  __shared__ int list[kStepWarps][32];
  __shared__ int hub_row[kStepThreads];
  __shared__ int hub_n[kStepWarps], busy[kStepWarps];
  __shared__ float part[2][kStepWarps];
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kStepThreads;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long so = sb ? static_cast<long>(b) : 0;
  const long row = static_cast<long>(b) * S;
  const int* P = sptr + so * (S + 1);
  const int r = r0 + threadIdx.x;
  const int beg = r < S ? P[r] : 0, end = r < S ? P[r + 1] : 0;
  const float au = r < S ? alpha[row + r] : 0.0f;
  const StepGrad sg{sarc + so * A, sdst + so * A, w + (wb ? static_cast<long>(b) * A : 0),
                    kEm ? em + (eb ? static_cast<long>(b) * A : 0) : nullptr,
                    m_in + row, z_in + row, g + row,
                    dcontrib ? dcontrib + static_cast<long>(b) * A : nullptr};
  if (sg.dc) {  // the arcs without a valid source: spread over the sample's blocks
    for (int j = P[S] + blockIdx.x * kStepThreads + threadIdx.x; j < A;
         j += gridDim.x * kStepThreads)
      sg.dc[sg.sarc[j]] = 0.0f;
  }
  const int wd = row_width(end - beg);
  if (wd == 0 && r < S) dalpha[row + r] = 0.0f;
  HubWarps hw{-1, 0};
  const bool hubs = hubs_pending(wd, hub_row, hub_n, busy, hw);
  for (int phase = 0; phase < 2; ++phase) {
    if (phase == (hw.rank >= 0 ? 1 : 0)) {
      warp_rows(beg, end, wd, list[warp], [&](int own, int b0, int e0, int gw, int sub) {
        const float a = __shfl_sync(kFull, au, own & 31);
        const float s = mixed_reduce(sg.template lane_sum<kEm>(b0 + sub, gw, e0, a), gw,
                                     [](float x, float y) { return x + y; });
        if (sub == 0 && own >= 0) dalpha[row + r0 + warp * 32 + own] = s;
      });
    }
    if (phase == 1 || !hubs) continue;
    // this thread's first hub position (none past the hub warps)
    const int ht = hw.rank >= 0 ? hw.rank * 32 + lane : 0, stride = hw.count * 32;
    int n = 0;
    for (int q = 0; q < kStepWarps; ++q) {
      for (int i = 0; i < hub_n[q]; ++i, ++n) {
        const int h = r0 + q * 32 + hub_row[q * 32 + i];
        const float a = alpha[row + h];
        const int hb = P[h], he = hw.rank >= 0 ? P[h + 1] : hb;
        float s = 0.0f;
        for (int k = hb + ht; k < he; k += kStepArcs * stride)
          s += sg.template lane_sum<kEm>(k, stride, he, a);
        s = warp_sum(s);
        if (lane == 0) part[n & 1][warp] = s;
        __syncthreads();
        if (threadIdx.x == 0) {
          s = 0.0f;
          for (int x = 0; x < kStepWarps; ++x) s += part[n & 1][x];
          dalpha[row + h] = s;
        }
      }
    }
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

// The schedule (ops/sparse_scan_pallas.py build_schedule): a part per
// (sample or shared row, rank), `stride` words; its ranges, then per list
// 6 words (slot offset, slots, hub offset, hubs, hub chunks, task offset).
constexpr int kLaneArcs = 8;
constexpr int kChunkMask = 0xffff;
enum Range { kS0, kS1, kA0, kA1, kE0, kE1, kL0, kL1, kSJ0, kSJ1, kEJ0, kEJ1, kLJ0, kLJ1 };
enum List { kDst, kEpsDst, kSrc, kEpsSrc, kLabel };

struct ListHead {
  int slot_off, nslots, hub_off, nhubs, nchunks;
};

__device__ __forceinline__ ListHead list_head(const int* part, int list) {
  const int* h = part + 16 + 6 * list;
  return ListHead{h[0], h[1], h[2], h[3], h[4]};
}

// The task a lane serves in slot q: a group of g lanes (sub: the lane's
// place in it) reduces row `key` over positions [beg, end); aux is -1, or
// a hub chunk's (hub << 16 | chunk).  Lanes past the slot's tasks get an
// empty task (key -1) and still take part in the shuffles.
struct Task {
  int key, beg, end, aux, g, sub;
};

__device__ __forceinline__ Task slot_task(const int* part, const ListHead& h, int q,
                                          int lane) {
  const int* s = part + h.slot_off + 3 * q;
  const int g = s[0];
  Task t{-1, 0, 0, -1, g, lane & (g - 1)};
  const int i = lane / g;
  if (i < s[2]) {
    const int* w = part + s[1] + 4 * i;
    t.key = w[0];
    t.beg = w[1];
    t.end = w[2];
    t.aux = w[3];
  }
  return t;
}

// Reductions over a group of g lanes (g a power of two, the same across
// the warp): xor shuffles below g stay inside the group.
template <typename V>
__device__ __forceinline__ V group_max(V v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) v = vmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

template <typename V>
__device__ __forceinline__ V group_sum(V v, int g) {
  for (int off = g >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename V>
__device__ __forceinline__ V merged_max(const V* part_m, const int* hub) {
  V m = V(-INFINITY);
  for (int p = hub[1]; p < hub[1] + hub[2]; ++p) m = vmax(m, part_m[p]);
  return vmax(m, V(kNeg));
}

// One logsumexp phase over a list of this rank's part: the Seg of every
// row, handed to emit(row, seg) by one lane of its group (a hub's by one
// thread after its chunks' maxima, then sums, have met in part_m/part_z).
// value(k): the contribution at position k.  Every thread calls it.  The
// group's shift m, the exponentials and their sum z are taken in Z (V by
// default; the forward scan's float beside its double values: m is only a
// shift, m + log z is exact for any m near the largest c, and exp(c - m)
// of c - m <= ~0 needs no more; the values c do).
template <typename V, typename Z = V, typename F, typename Emit>
__device__ void lse_phase(const int* part, int list, V* part_m, Z* part_z, F value,
                          Emit emit) {
  const ListHead h = list_head(part, list);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int q = warp; q < h.nslots; q += nwarps) {
    const Task t = slot_task(part, h, q, lane);
    V c[kLaneArcs];
    V m = V(-INFINITY);
#pragma unroll
    for (int j = 0; j < kLaneArcs; ++j) {
      const int k = t.beg + t.sub + j * t.g;
      c[j] = k < t.end ? value(k) : V(-INFINITY);
      m = vmax(m, c[j]);
    }
    m = vmax(static_cast<V>(group_max(static_cast<Z>(m), t.g)), V(kNeg));
    if (t.aux >= 0) {  // a hub chunk (one a warp): its sum after the merge
      if (lane == 0) part_m[t.aux & kChunkMask] = m;
      continue;
    }
    Z z = Z(0);
#pragma unroll
    for (int j = 0; j < kLaneArcs; ++j)
      if (c[j] > V(kDead)) z += ex(static_cast<Z>(c[j] - m));
    z = group_sum(z, t.g);
    if (t.sub == 0 && t.key >= 0) emit(t.key, Seg<V>{m, static_cast<V>(z)});
  }
  if (h.nhubs == 0) return;
  __syncthreads();
  for (int q = warp; q < h.nchunks; q += nwarps) {  // the chunks' slots come first
    const Task t = slot_task(part, h, q, lane);
    const V m = merged_max(part_m, part + h.hub_off + 3 * (t.aux >> 16));
    Z z = Z(0);
#pragma unroll
    for (int j = 0; j < kLaneArcs; ++j) {
      const int k = t.beg + lane + j * 32;
      if (k < t.end) {
        const V c = value(k);
        if (c > V(kDead)) z += ex(static_cast<Z>(c - m));
      }
    }
    z = group_sum(z, 32);
    if (lane == 0) part_z[t.aux & kChunkMask] = z;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < h.nhubs; i += blockDim.x) {
    const int* hub = part + h.hub_off + 3 * i;
    Z z = Z(0);
    for (int p = hub[1]; p < hub[1] + hub[2]; ++p) z += part_z[p];
    emit(hub[0], Seg<V>{merged_max(part_m, hub), static_cast<V>(z)});
  }
}

// fn(row, k) for every position k of every row of a list of this rank.
template <typename F>
__device__ void map_phase(const int* part, int list, F fn) {
  const ListHead h = list_head(part, list);
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < h.nslots; q += blockDim.x >> 5) {
    const Task t = slot_task(part, h, q, lane);
#pragma unroll
    for (int j = 0; j < kLaneArcs; ++j) {
      const int k = t.beg + t.sub + j * t.g;
      if (k < t.end) fn(t.key, k);
    }
  }
}

// The float64 sum of value(k) over each row of a list of this rank, handed
// to emit(row, sum); a hub's chunks' sums meet in part (in chunk order).
template <typename F, typename Emit>
__device__ void sum_phase(const int* part, int list, double* part_s, F value, Emit emit) {
  const ListHead h = list_head(part, list);
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x >> 5; q < h.nslots; q += blockDim.x >> 5) {
    const Task t = slot_task(part, h, q, lane);
    double s = 0.0;
#pragma unroll
    for (int j = 0; j < kLaneArcs; ++j) {
      const int k = t.beg + t.sub + j * t.g;
      if (k < t.end) s += value(k);
    }
    s = group_sum(s, t.g);
    if (t.sub == 0 && t.key >= 0) {
      if (t.aux >= 0) {
        part_s[t.aux & kChunkMask] = s;
      } else {
        emit(t.key, s);
      }
    }
  }
  if (h.nhubs == 0) return;
  __syncthreads();
  for (int i = threadIdx.x; i < h.nhubs; i += blockDim.x) {
    const int* hub = part + h.hub_off + 3 * i;
    double s = 0.0;
    for (int p = hub[1]; p < hub[1] + hub[2]; ++p) s += part_s[p];
    emit(hub[0], s);
  }
}

// x at [s] of every block of the cluster's copy of `buf` (this block's
// included): a state value the next phase reads anywhere.
template <typename V>
__device__ __forceinline__ void push(cg::cluster_group& cl, V* buf, int s, V x) {
  for (unsigned r = 0; r < cl.num_blocks(); ++r) cl.map_shared_rank(buf, r)[s] = x;
}

// Shared memory in 4-byte words, as ops/sparse_scan_pallas.py smem_words:
// the forward's state (its vectors and shifts float64, the sums and the
// emission rows float), and its staged tables and schedule.
__host__ __device__ long fwd_state_words(int S, int C, int n, int p) {
  return 64 + 8L * S + 2L * n + 2L * C + 3L * p;
}

__host__ __device__ long fwd_table_words(int a, int e, int fwd_words) {
  return 3L * a + 2L * e + fwd_words;
}

// The backward's shared part (the state vectors other blocks write, their
// posteriors), its own part (the float64 state of its own states and
// arcs) and its staged tables, codes and schedule.
__host__ __device__ long bwd_shared_words(int S, int C, int D, int a, int e, int p) {
  return 2L * (static_cast<long>(D) * S + 2L * p) + 2L * S + 2L * a + 2L * e + 2L * C;
}

__host__ __device__ long bwd_own_words(int D, int n, int a, int e) {
  return 2L * (static_cast<long>(n) * (5 * D + 6) + a + e);
}

__host__ __device__ long bwd_table_words(int a, int e, int stride, int sj, int ej, int lj) {
  return 3L * a + 2L * e + stride + sj + ej + lj;
}

// Start copying n floats of src into dst (shared memory) with cp.async;
// __pipeline_wait_prior(0) and a barrier later make them visible.
__device__ __forceinline__ void prefetch(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
  __pipeline_commit();
}

__global__ void __launch_bounds__(kScanThreads)
sparse_scan_fwd_kernel(const float* __restrict__ em, const float* __restrict__ alpha0,
                       const int* __restrict__ lens, const int* src, const int* label,
                       const float* w, const int* esrc, const float* ew, const int* sched,
                       float* __restrict__ traj, double* __restrict__ shift, int T, int C,
                       int S, int A, int E, int depth, int sb, int wb, int esb, int ewb,
                       int qb, int stride, int fwd_words, int n_own, int a_own, int e_own,
                       int parts, int in_smem) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int k = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* part = sched + (static_cast<long>(qb ? b : 0) * k + rank) * stride;
  const int s0 = part[kS0], s1 = part[kS1], a0 = part[kA0], a1 = part[kA1];
  const int e0 = part[kE0], e1 = part[kE1];
  // the state in float64, carved first: a float state takes a rounding a
  // frame, and over hundreds of frames those of a state tens of nats below
  // the frame's largest add up to more than 1e-3
  Carve cv{smem};
  double* red = cv.doubles(32);
  double* cur0 = cv.doubles(S);
  double* cur1 = cv.doubles(S);
  // the frames' acc, every state, by frame parity: frame t reads alpha as
  // acc[t - 1] less the running frame shift sh, and writes acc[t]
  double* acc0 = cv.doubles(S);
  double* acc1 = cv.doubles(S);
  double* accl = cv.doubles(n_own);  // acc_d of the own states
  double* part_m = cv.doubles(parts);
  float* part_z = cv.floats(parts);
  float* em0 = cv.floats(C);  // the emission rows, by frame parity
  float* em1 = cv.floats(C);
  const long so = sb ? static_cast<long>(b) : 0;
  const int* Sr = src + so * A;
  const int* Lb = label + so * A;
  const float* W = w + (wb ? static_cast<long>(b) * A : 0);
  const int* ES = depth > 0 ? esrc + (esb ? static_cast<long>(b) * E : 0) : nullptr;
  const float* EW = depth > 0 ? ew + (ewb ? static_cast<long>(b) * E : 0) : nullptr;
  if (in_smem) {
    part = stage(part, fwd_words, cv.ints(fwd_words));
    Sr = stage(Sr + a0, a1 - a0, cv.ints(a_own)) - a0;
    Lb = stage(Lb + a0, a1 - a0, cv.ints(a_own)) - a0;
    W = stage(W + a0, a1 - a0, cv.floats(a_own)) - a0;
    if (depth > 0) {
      ES = stage(ES + e0, e1 - e0, cv.ints(e_own)) - e0;
      EW = stage(EW + e0, e1 - e0, cv.floats(e_own)) - e0;
    }
  }
  const long tb = static_cast<long>(b) * (T + 1) * S;
  const float* a0_b = alpha0 + static_cast<long>(b) * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) acc1[s] = a0_b[s];  // frame -1
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) traj[tb + s] = a0_b[s];
  const int t_live = min(max(lens[b], 0), T);
  const float* em_b = em + static_cast<long>(b) * T * C;
  double* shift_b = shift + static_cast<long>(b) * (T + 1);
  double k_run = 0.0;  // a sum of hundreds of shifts
  double sh = 0.0;
  const bool lead = rank == 0 && threadIdx.x == 0;
  if (lead) shift_b[0] = 0.0;
  if (t_live > 0)
    for (int c = threadIdx.x; c < C; c += blockDim.x) em0[c] = em_b[c];
  cl.sync();  // every block of the cluster runs, its staging done

  for (int t = 0; t < t_live; ++t) {
    const double* prev = (t & 1) ? acc0 : acc1;
    double* accp = (t & 1) ? acc1 : acc0;
    const float* em_row = (t & 1) ? em1 : em0;
    if (t + 1 < t_live) prefetch((t & 1) ? em0 : em1, em_b + static_cast<long>(t + 1) * C, C);
    // the arc step: y into acc_0 (own) and cur_0 (or, without a closure,
    // the frame's acc) of every block
    lse_phase<double, float>(
        part, kDst, part_m, part_z,
        [&](int kk) {
          const int s = Sr[kk];
          const int l = Lb[kk];
          return ((s >= 0 ? prev[s] - sh : static_cast<double>(kNeg)) +
                  static_cast<double>(W[kk])) +
                 ((l >= 0 && l < C) ? static_cast<double>(em_row[l]) : 0.0);
        },
        [&](int s, Seg<double> sg) {
          const double v = value_f(sg);
          accl[s - s0] = v;
          push(cl, depth > 0 ? cur0 : accp, s, v);
        });
    cl.sync();
    for (int d = 0; d < depth; ++d) {
      const double* c0 = (d & 1) ? cur1 : cur0;
      double* c1 = (d & 1) ? cur0 : cur1;
      const bool last = d == depth - 1;
      lse_phase<double, float>(
          part, kEpsDst, part_m, part_z,
          [&](int kk) {
            const int s = ES[kk];
            return (s >= 0 ? c0[s] : static_cast<double>(kNeg)) +
                   static_cast<double>(EW[kk]);
          },
          [&](int s, Seg<double> sg) {
            const double v = value_f(sg);
            const double a = lae_f(accl[s - s0], v);
            accl[s - s0] = a;
            if (last) {
              push(cl, accp, s, a);
            } else {
              push(cl, c1, s, v);
            }
          });
      cl.sync();
    }
    // the frame's shift: its largest alpha, 0 if every state is dead; every
    // block takes it from its own copy of acc, so all agree
    double m = -INFINITY;
    for (int s = threadIdx.x; s < S; s += blockDim.x) m = fmax(m, accp[s]);
    m = warp_max(m);
    if (lane == 0) red[warp] = m;
    __pipeline_wait_prior(0);
    __syncthreads();
    m = -INFINITY;
    for (int i = 0; i < nwarps; ++i) m = fmax(m, red[i]);
    sh = m > kDead ? m : 0.0;
    k_run += sh;
    float* tr = traj + tb + static_cast<long>(t + 1) * S;
    for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x)
      tr[s] = static_cast<float>(accp[s] - sh);
    if (lead) shift_b[t + 1] = k_run;
  }
  // frozen tail: alpha and the shift keep their values past the length
  const double* last = ((t_live - 1) & 1) ? acc1 : acc0;
  for (int t = t_live; t < T; ++t) {
    float* tr = traj + tb + static_cast<long>(t + 1) * S;
    for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x)
      tr[s] = static_cast<float>(last[s] - sh);
    if (lead) shift_b[t + 1] = k_run;
  }
  cl.sync();  // no block leaves while another may still address its memory
}

// The backward recomputes each frame's chain in double precision (its
// inputs and outputs are float): over a few hundred frames, the posteriors
// of float intermediates (|value| ~ 10-30, an ulp ~ 1e-6) put ~1e-5 of
// noise on the cotangents; the recompute is latency-bound, and the card's
// fp64 rate is half its fp32 rate.  Each step of the closure's reverse is
// taken where its inputs are last written: logaddexp's VJP at round d in
// the emit that finishes cur_d (round D) or the cotangent of cur_d (the
// sum by source of round d + 1).
__global__ void __launch_bounds__(kScanThreads)
sparse_scan_bwd_kernel(const float* __restrict__ em, const float* __restrict__ traj,
                       const int* __restrict__ lens, const float* __restrict__ g_final,
                       const int* src, const int* label, const float* w, const int* esrc,
                       const float* ew, const int* sched, const int* sref,
                       const int* esref, const int* lref, float* __restrict__ dem,
                       double* __restrict__ dw, double* __restrict__ deps,
                       float* __restrict__ dalpha0, float* scratch, int T, int C, int S,
                       int A, int E, int depth, int sb, int wb, int esb, int ewb, int qb,
                       int stride, int n_own, int a_own, int e_own, int parts, int sj_own,
                       int ej_own, int lj_own, int own_smem, int in_smem) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int k = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / k;
  const int D = depth;
  const int n = n_own;
  const long row = qb ? static_cast<long>(b) : 0;
  const int* part = sched + (row * k + rank) * stride;
  const int s0 = part[kS0], s1 = part[kS1], a0 = part[kA0], a1 = part[kA1];
  const int e0 = part[kE0], e1 = part[kE1];
  const int sj0 = part[kSJ0], sj1 = part[kSJ1], ej0 = part[kEJ0], ej1 = part[kEJ1];
  const int lj0 = part[kLJ0], lj1 = part[kLJ1];
  // doubles first: the shared part's, then the own part where it lies in
  // shared memory (else in this block's slice of global scratch, which
  // only this block touches: __syncthreads orders it)
  Carve cv{smem};
  double* curs = cv.doubles(static_cast<long>(D) * S);  // cur_0 .. cur_{D-1}, every state
  double* part_m = cv.doubles(parts);
  double* part_z = cv.doubles(parts);
  const long own_words = bwd_own_words(D, n, a_own, e_own);
  Carve ov{own_smem ? cv.p : scratch + static_cast<long>(blockIdx.x) * own_words};
  if (own_smem) cv.p += own_words;
  double* cown = ov.doubles((D + 1L) * n);  // cur_0 .. cur_D of the own states
  double* seg_m = ov.doubles((D + 1L) * n);  // their shifts
  double* seg_z = ov.doubles((D + 1L) * n);  // and sums
  double* accs = ov.doubles(static_cast<long>(D) * n);  // acc_1 .. acc_D
  double* g = ov.doubles(n);
  double* gacc = ov.doubles(n);
  double* gcur = ov.doubles((D + 1L) * n);  // the cotangents of cur_1 .. cur_D
  double* dw_acc = ov.doubles(a_own);
  double* deps_acc = ov.doubles(e_own);
  float* a_in0 = cv.floats(S);  // the trajectory's rows, by frame parity
  float* a_in1 = cv.floats(S);
  float* dcb = cv.floats(2L * a_own);   // the own arcs' posteriors, by frame parity
  float* dceb = cv.floats(2L * e_own);  // the own epsilon arcs', by round parity
  float* em0 = cv.floats(C);  // the emission rows, by frame parity
  float* em1 = cv.floats(C);
  const long so = sb ? static_cast<long>(b) : 0;
  const int* Sr = src + so * A;
  const int* Lb = label + so * A;
  const float* W = w + (wb ? static_cast<long>(b) * A : 0);
  const int* ES = D > 0 ? esrc + (esb ? static_cast<long>(b) * E : 0) : nullptr;
  const float* EW = D > 0 ? ew + (ewb ? static_cast<long>(b) * E : 0) : nullptr;
  const int* SR = sref + row * A;
  const int* ESR = D > 0 ? esref + row * E : nullptr;
  const int* LR = lref + row * A;
  if (in_smem) {
    part = stage(part, stride, cv.ints(stride));
    Sr = stage(Sr + a0, a1 - a0, cv.ints(a_own)) - a0;
    Lb = stage(Lb + a0, a1 - a0, cv.ints(a_own)) - a0;
    W = stage(W + a0, a1 - a0, cv.floats(a_own)) - a0;
    if (D > 0) {
      ES = stage(ES + e0, e1 - e0, cv.ints(e_own)) - e0;
      EW = stage(EW + e0, e1 - e0, cv.floats(e_own)) - e0;
      ESR = stage(ESR + ej0, ej1 - ej0, cv.ints(ej_own)) - ej0;
    }
    SR = stage(SR + sj0, sj1 - sj0, cv.ints(sj_own)) - sj0;
    LR = stage(LR + lj0, lj1 - lj0, cv.ints(lj_own)) - lj0;
  }
  for (int i = threadIdx.x; i < s1 - s0; i += blockDim.x)
    g[i] = g_final[static_cast<long>(b) * S + s0 + i];
  for (int i = threadIdx.x; i < a1 - a0; i += blockDim.x) dw_acc[i] = 0.0;
  for (int i = threadIdx.x; i < e1 - e0; i += blockDim.x) deps_acc[i] = 0.0;
  // arcs past dptr[S] (no valid destination) keep a posterior of 0
  for (int i = threadIdx.x; i < 2 * a_own; i += blockDim.x) dcb[i] = 0.0f;
  for (int i = threadIdx.x; i < 2 * e_own; i += blockDim.x) dceb[i] = 0.0f;
  const int t_live = min(max(lens[b], 0), T);
  float* dem_b = dem + static_cast<long>(b) * T * C;
  for (long i = static_cast<long>(t_live) * C + rank * blockDim.x + threadIdx.x;
       i < static_cast<long>(T) * C; i += static_cast<long>(k) * blockDim.x)
    dem_b[i] = 0.0f;
  const float* em_b = em + static_cast<long>(b) * T * C;
  const float* tr_b = traj + static_cast<long>(b) * (T + 1) * S;
  if (t_live > 0) {
    const int t = t_live - 1;
    float* a_in = (t & 1) ? a_in1 : a_in0;
    float* em_row = (t & 1) ? em1 : em0;
    for (int c = threadIdx.x; c < C; c += blockDim.x) em_row[c] = em_b[static_cast<long>(t) * C + c];
    for (int s = threadIdx.x; s < S; s += blockDim.x) a_in[s] = tr_b[static_cast<long>(t) * S + s];
  }
  cl.sync();  // every block of the cluster runs, its staging done

  // logaddexp's VJP at round d of an own state i: its posteriors from its
  // own shift (as autodiff forms them); gcur_d gets the share of cur_d,
  // gacc keeps acc_{d-1}'s
  auto lae_vjp = [&](int i, int d) {
    const double a = d == 1 ? cown[i] : accs[(d - 2L) * n + i];
    const double c = cown[static_cast<long>(d) * n + i];
    const double m = fmax(fmax(a, c), static_cast<double>(kNeg));
    const double ea = a > kDead ? exp(a - m) : 0.0;
    const double ec = c > kDead ? exp(c - m) : 0.0;
    const double z = ea + ec;
    const double gz = z > 0.0 ? gacc[i] / z : 0.0;
    gcur[static_cast<long>(d) * n + i] += gz * ec;
    gacc[i] = gz * ea;
  };
  auto remote = [&](float* buf, int code) {
    return static_cast<double>(cl.map_shared_rank(buf, code & 7)[code >> 3]);
  };
  for (int t = t_live - 1; t >= 0; --t) {
    const float* a_in = (t & 1) ? a_in1 : a_in0;
    const float* em_row = (t & 1) ? em1 : em0;
    if (t > 0) {
      prefetch((t & 1) ? em0 : em1, em_b + (t - 1L) * C, C);
      prefetch((t & 1) ? a_in0 : a_in1, tr_b + (t - 1L) * S, S);
    }
    auto arc = [&](int kk) {
      const int s = Sr[kk];
      const int l = Lb[kk];
      const double a = s >= 0 ? static_cast<double>(a_in[s]) : static_cast<double>(kNeg);
      return (a + static_cast<double>(W[kk])) +
             ((l >= 0 && l < C) ? static_cast<double>(em_row[l]) : 0.0);
    };
    // recompute the frame's chain: y0, then cur_d and acc_d; the last
    // phase starts the reverse: gacc = g, and logaddexp's VJP at round D
    lse_phase<double>(part, kDst, part_m, part_z, arc, [&](int s, Seg<double> sg) {
      const int i = s - s0;
      const double v = sg.value();
      cown[i] = v;
      seg_m[i] = sg.m;
      seg_z[i] = sg.z;
      if (D > 0) {
        push(cl, curs, s, v);
      } else {
        gacc[i] = g[i];
      }
    });
    if (D > 0) {
      cl.sync();
    } else {
      __syncthreads();
    }
    for (int d = 1; d <= D; ++d) {
      const double* prev = curs + (d - 1L) * S;
      double* next = curs + static_cast<long>(d) * S;
      lse_phase<double>(
          part, kEpsDst, part_m, part_z,
          [&](int kk) {
            const int s = ES[kk];
            return (s >= 0 ? prev[s] : static_cast<double>(kNeg)) +
                   static_cast<double>(EW[kk]);
          },
          [&](int s, Seg<double> sg) {
            const int i = s - s0;
            const long di = static_cast<long>(d) * n + i;
            const double v = sg.value();
            cown[di] = v;
            seg_m[di] = sg.m;
            seg_z[di] = sg.z;
            accs[di - n] = lae(d == 1 ? cown[i] : accs[di - 2L * n], v);
            if (d < D) {
              push(cl, next, s, v);
            } else {
              gacc[i] = g[i];
              gcur[di] = 0.0;
              lae_vjp(i, D);
            }
          });
      if (d < D) {
        cl.sync();
      } else {
        __syncthreads();
      }
    }
    // reverse the closure: cur_d = eps(cur_{d-1}), then logaddexp's VJP at
    // round d - 1 in the emit of cur_{d-1}'s cotangent
    for (int d = D; d >= 1; --d) {
      const double* prev = curs + (d - 1L) * S;
      const double* sm = seg_m + static_cast<long>(d) * n;
      const double* sz = seg_z + static_cast<long>(d) * n;
      const double* gcd = gcur + static_cast<long>(d) * n;
      float* dce = dceb + (d & 1) * static_cast<long>(e_own);
      map_phase(part, kEpsDst, [&](int s, int kk) {
        const int i = s - s0;
        const int u = ES[kk];
        const double c = (u >= 0 ? prev[u] : static_cast<double>(kNeg)) +
                         static_cast<double>(EW[kk]);
        const double v = posterior(c, Seg<double>{sm[i], sz[i]}, gcd[i]);
        dce[kk - e0] = static_cast<float>(v);
        deps_acc[kk - e0] += v;
      });
      cl.sync();
      sum_phase(
          part, kEpsSrc, part_z, [&](int j) { return remote(dce, ESR[j]); },
          [&](int u, double v) {
            const int i = u - s0;
            if (d > 1) {
              gcur[(d - 1L) * n + i] = v;
              lae_vjp(i, d - 1);
            } else {
              gacc[i] += v;  // the cotangent of y0
            }
          });
      __syncthreads();
    }
    // the arc step's VJP
    float* dc = dcb + (t & 1) * static_cast<long>(a_own);
    map_phase(part, kDst, [&](int s, int kk) {
      const int i = s - s0;
      const double v = posterior(arc(kk), Seg<double>{seg_m[i], seg_z[i]}, gacc[i]);
      dc[kk - a0] = static_cast<float>(v);
      dw_acc[kk - a0] += v;
    });
    cl.sync();
    sum_phase(
        part, kSrc, part_z, [&](int j) { return remote(dc, SR[j]); },
        [&](int u, double v) { g[u - s0] = v; });
    float* dem_t = dem_b + static_cast<long>(t) * C;
    sum_phase(
        part, kLabel, part_m, [&](int j) { return remote(dc, LR[j]); },
        [&](int l, double v) { dem_t[l] = static_cast<float>(v); });
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < s1 - s0; i += blockDim.x)
    dalpha0[static_cast<long>(b) * S + s0 + i] = static_cast<float>(g[i]);
  for (int i = threadIdx.x; i < a1 - a0; i += blockDim.x)
    dw[static_cast<long>(b) * A + a0 + i] = dw_acc[i];
  if (D > 0)
    for (int i = threadIdx.x; i < e1 - e0; i += blockDim.x)
      deps[static_cast<long>(b) * E + e0 + i] = deps_acc[i];
  cl.sync();  // no block leaves while another may still read its posteriors
}

// The scans' chain without arcs: each phase one load from the next block's
// shared memory that depends on the last phase's, and one cluster barrier.
__global__ void __launch_bounds__(kScanThreads)
sparse_scan_probe_kernel(float* __restrict__ out, int phases) {
  __shared__ float buf[2][32];
  cg::cluster_group cl = cg::this_cluster();
  const int k = static_cast<int>(cl.num_blocks());
  const int next = (static_cast<int>(cl.block_rank()) + 1) % k;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) buf[0][lane] = static_cast<float>(lane);
  cl.sync();
  float v = 0.0f;
  for (int p = 0; p < phases; ++p) {
    v = cl.map_shared_rank(&buf[p & 1][0], next)[lane] + 1.0f;
    if (threadIdx.x < 32) buf[(p + 1) & 1][lane] = v;
    cl.sync();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// ---------------------------------------------------------------------------
// seg_max_scan: the whole tropical scan of a shared decode table, and its
// backtrace
// ---------------------------------------------------------------------------
//
// For frames t < len[b] (past it alpha is kept and the backarcs row is 2^30):
//   new[s] = max(NEG, max over arcs a into s of (alpha[src[a]] + w[a]) +
//            em[b, t, label[a]])
//   backarcs[b, t, s] = the lowest arc id attaining it, if it is strictly
//            above NEG; else 2^30
// which is what T launches of seg_max compute; then the first argmax of
// final + accept, and the walk back through the backarcs (label -1 and the
// state kept on an arc id >= A; every label -1 where the score is <= NEG/2).
//
// The TPU decode scans seg_max's one-hot tiles frame by frame
// (jax.lax.scan).  Here one launch runs the frames of a sample on a
// thread-block cluster, on the sparse scans' schedule (its list of rows by
// destination): each rank owns a range of states cut by arc count, its rows
// go to lane groups by in-degree, and a hub of more than 256 in-arcs (the
// 4-gram decode table's backoff state, 1,057) is cut into warp chunks.  Every
// reduction merges (value, sorted position) pairs under "greater value, else
// lower position", an associative and exact rule, so ties need no order
// between lanes or chunks; within a row the stable sort of arc_index keeps
// positions in increasing arc id, so the lowest position is the lowest id,
// and a lane's strict > over its increasing positions keeps it.  Alpha is
// double-buffered in every rank's shared memory: after the arc step a rank
// pushes its states' new values into every rank's copy of the next buffer
// (distributed shared memory), and one cluster.sync() a frame orders the
// frames (a fast rank's frame t + 1 writes the buffer that frame t read only
// after every rank has passed frame t's barrier).  Each rank keeps its
// states' winning positions in a buffer of its own (by frame parity) and
// writes them to the frame's backarcs row during the next frame,
// coalesced, while its slower warps finish their slots; after the last
// frame it maps its columns' positions to arc ids in one pass.  A rank's
// arcs (source and label packed in one word, and the weight) and its list
// of rows are staged in its shared memory where they fit.  After a last
// barrier (the backarcs of every rank visible), rank 0 takes the argmax
// and one thread walks the T frames (backarcs read at L2).
//
// What bounds it on the H100: per live frame and sample 3 fp32 operations
// an arc and the backarcs row written (at the 4-gram table, B = 32,
// T = 300: 1.0 G operations, 41 MB, ~15 us); the kernel instead waits on
// the chain of T frames, each one pass of the busiest rank's slots and one
// cluster barrier (sparse_scan_probe times a phase without arcs: ~0.7 us),
// and then on the walk's T dependent loads.  On an H100 at that shape a
// frame takes ~11 us at k = 4: the busiest rank's pass over its ~100
// slots (~300 instructions each, 6 a warp) holds it, the barrier and the
// pushes ~2 us of it.

__host__ __device__ long decode_state_words(int S, int C, int n, int p) {
  return 66 + 2L * S + 2L * C + 2L * n + 2L * p;
}

__host__ __device__ long decode_table_words(int a, int dst_words) {
  return 2L * a + dst_words;
}

// (v, k) merged into (best, bk): greater value, else lower position
__device__ __forceinline__ void max_merge(float& best, int& bk, float v, int k) {
  if (v > best || (v == best && k < bk)) {
    best = v;
    bk = k;
  }
}

// The decode's arc step over this rank's list by destination: for every
// row, the maximum of c[k] = (prev[src[k]] + w[k]) + em_row[label[k]] over
// its positions k and the lowest position attaining it, handed to
// emit(row, max, position) by one lane of its group (a hub's by one thread
// after its chunks have met in part_m / part_k); a row without a live arc
// emits (-INFINITY, INT_MAX).  The arcs come packed, src | label << 16,
// with an arc whose source lies outside [0, S) given source 0 and weight
// -INFINITY (it never wins), and a label outside [0, C) given C, where
// em_row holds 0: the sum is formed in the plain version's order, so c is
// the same float.  Each lane first loads all of its arcs (a clamped
// position, masked after: no load waits on a branch), then gathers their
// sources' alpha and emissions, so a slot costs one round of table loads
// and one of gathers; a slot takes only the rounds its longest row needs.
template <typename Emit>
__device__ void max_phase(const int* part, const int* arcs, const float* w,
                          const float* prev, const float* em_row, int safe, float* part_m,
                          int* part_k, Emit emit) {
  const ListHead h = list_head(part, kDst);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int q = warp; q < h.nslots; q += nwarps) {
    const Task t = slot_task(part, h, q, lane);
    const int k0 = t.beg + t.sub;
    // the rounds the slot's longest row needs (the same in every lane)
    const int nj = (__reduce_max_sync(kFull, t.end - t.beg) + t.g - 1) >> (__ffs(t.g) - 1);
    int pk[kLaneArcs];
    float wv[kLaneArcs];
#pragma unroll
    for (int j = 0; j < kLaneArcs; ++j) {
      if (j < nj) {
        const int kc = k0 + j * t.g < t.end ? k0 + j * t.g : safe;
        pk[j] = arcs[kc];
        wv[j] = w[kc];
      }
    }
    float best = -INFINITY;
    int bj = kLaneArcs;
#pragma unroll
    for (int j = 0; j < kLaneArcs; ++j) {
      if (j < nj) {
        const float c = (prev[pk[j] & 0xffff] + wv[j]) + em_row[pk[j] >> 16];
        if (k0 + j * t.g < t.end && c > best) {  // j increases: the lowest wins ties
          best = c;
          bj = j;
        }
      }
    }
    int bk = bj < kLaneArcs ? k0 + bj * t.g : INT_MAX;
    for (int off = t.g >> 1; off > 0; off >>= 1)
      max_merge(best, bk, __shfl_xor_sync(kFull, best, off), __shfl_xor_sync(kFull, bk, off));
    if (t.aux >= 0) {  // a hub chunk (one a warp)
      if (lane == 0) {
        part_m[t.aux & kChunkMask] = best;
        part_k[t.aux & kChunkMask] = bk;
      }
      continue;
    }
    if (t.sub == 0 && t.key >= 0) emit(t.key, best, bk);
  }
  if (h.nhubs == 0) return;
  __syncthreads();
  for (int i = threadIdx.x; i < h.nhubs; i += blockDim.x) {
    const int* hub = part + h.hub_off + 3 * i;
    float best = -INFINITY;
    int bk = INT_MAX;
    for (int p = hub[1]; p < hub[1] + hub[2]; ++p) max_merge(best, bk, part_m[p], part_k[p]);
    emit(hub[0], best, bk);
  }
}

// kInSmem: the rank's arcs and list are staged in shared memory (two
// instantiations, so that the compiler knows which loads are shared ones)
template <bool kInSmem>
__global__ void __launch_bounds__(kScanThreads)
seg_max_scan_kernel(const float* __restrict__ em, const int* __restrict__ lens,
                    const float* __restrict__ start, const float* __restrict__ accept,
                    const int* arcs, const float* w, const int* __restrict__ ids,
                    const int* __restrict__ tsrc, const int* __restrict__ tlabel,
                    const int* sched, int* __restrict__ backarcs,
                    float* __restrict__ final_alpha, int* __restrict__ labels,
                    float* __restrict__ score, int T, int C, int S, int A, int em_sb,
                    int em_st, int stride, int dst_words, int n_own, int a_own, int parts) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int k = static_cast<int>(cl.num_blocks());
  const int rank = static_cast<int>(cl.block_rank());
  const int b = blockIdx.x / k;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int* part = sched + static_cast<long>(rank) * stride;  // one shared row
  const int s0 = part[kS0], s1 = part[kS1], a0 = part[kA0], a1 = part[kA1];
  const int n = s1 - s0;
  const int safe = min(max(a1 - 1, a0), A - 1);  // a position every load may read
  Carve cv{smem};
  float* red_v = cv.floats(32);
  int* red_k = cv.ints(32);
  float* al0 = cv.floats(S);  // alpha, every state, by frame parity: frame t
  float* al1 = cv.floats(S);  // reads al1 (t even) or al0 and writes the other
  float* em0 = cv.floats(C + 1);  // the emission rows, by frame parity, and a 0
  float* em1 = cv.floats(C + 1);  // for the labels outside [0, C)
  int* bar0 = cv.ints(n_own);  // the own states' winning positions, by frame parity
  int* bar1 = cv.ints(n_own);
  float* part_m = cv.floats(parts);
  int* part_k = cv.ints(parts);
  const int* Ar = arcs;
  const float* W = w;
  if (kInSmem) {
    part = stage(part, dst_words, cv.ints(dst_words));
    Ar = stage(Ar + a0, a1 - a0, cv.ints(a_own)) - a0;
    W = stage(W + a0, a1 - a0, cv.floats(a_own)) - a0;
  }
  const int t_live = min(max(lens[b], 0), T);
  const float* em_b = em + static_cast<long>(b) * em_sb;
  for (int s = threadIdx.x; s < S; s += blockDim.x) al1[s] = start[s];
  if (t_live > 0)
    for (int c = threadIdx.x; c < C; c += blockDim.x) em0[c] = em_b[c];
  if (threadIdx.x == 0) em0[C] = em1[C] = 0.0f;
  cl.sync();  // every block of the cluster runs, its staging done

  // frame t's row of backarcs holds the own states' winning positions
  // until the scan ends (written during frame t + 1, while the slower
  // warps finish their slots: no load on that path)
  int* back_b = backarcs + static_cast<long>(b) * T * S;
  auto write_row = [&](int t) {
    const int* barc = (t & 1) ? bar1 : bar0;
    int* row = back_b + static_cast<long>(t) * S + s0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) row[i] = barc[i];
  };
  for (int t = 0; t < t_live; ++t) {
    const float* prev = (t & 1) ? al0 : al1;
    float* next = (t & 1) ? al1 : al0;
    int* barc = (t & 1) ? bar1 : bar0;
    if (t + 1 < t_live)
      prefetch((t & 1) ? em0 : em1, em_b + static_cast<long>(t + 1) * em_st, C);
    max_phase(part, Ar, W, prev, (t & 1) ? em1 : em0, safe, part_m, part_k,
              [&](int s, float v, int kk) {
                const bool live = v > kNeg;
                push(cl, next, s, live ? v : kNeg);
                barc[s - s0] = live ? kk : kBig;
              });
    // the last frame's positions were written before the last barrier; the
    // frame that writes them again comes after this one's
    if (t > 0) write_row(t - 1);
    __pipeline_wait_prior(0);
    cl.sync();
  }
  if (t_live > 0) write_row(t_live - 1);
  __syncthreads();
  // positions to arc ids in the own states' columns of the live rows (the
  // index's order, L2-resident), and 2^30 in the rows past the length: a
  // warp a row at a time, four loads in flight a lane
  for (int t = warp; t < T; t += nwarps) {
    int* row = back_b + static_cast<long>(t) * S + s0;
    for (int i0 = lane; i0 < n; i0 += 4 * 32) {
      int p[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + 32 * u;
        p[u] = (t < t_live && i < n) ? row[i] : kBig;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = p[u] == kBig ? kBig : __ldg(ids + p[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i0 + 32 * u < n) row[i0 + 32 * u] = p[u];
    }
  }
  const float* fin = ((t_live - 1) & 1) ? al1 : al0;
  for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x)
    final_alpha[static_cast<long>(b) * S + s] = fin[s];
  cl.sync();  // every rank's backarcs written (and no block leaves while
              // another may still write into its shared memory)
  if (rank != 0) return;

  // the backtrace: the first argmax of final + accept, then the walk
  float best = -INFINITY;
  int bs = INT_MAX;
  for (int s = threadIdx.x; s < S; s += blockDim.x) max_merge(best, bs, fin[s] + accept[s], s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    max_merge(best, bs, __shfl_xor_sync(kFull, best, off), __shfl_xor_sync(kFull, bs, off));
  if (lane == 0) {
    red_v[warp] = best;
    red_k[warp] = bs;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int i = 1; i < nwarps; ++i) max_merge(best, bs, red_v[i], red_k[i]);
  score[b] = best;
  int* lab = labels + static_cast<long>(b) * T;
  const bool feasible = best > kHalfNeg;
  int state = bs;
  for (int t = T - 1; t >= 0; --t) {
    int l = -1;
    if (feasible && t < t_live) {
      const int arc = __ldcg(back_b + static_cast<long>(t) * S + state);
      if (arc < A) {
        l = tlabel[arc];
        state = tsrc[arc];
      }
    }
    lab[t] = l;
  }
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

// A launch of B clusters of k blocks of kScanThreads threads.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int B, int k, size_t smem, void* stream) {
    cfg.gridDim = dim3(static_cast<unsigned>(B * k));
    cfg.blockDim = dim3(kScanThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(k);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// Launches; raises (returns an error) where not one cluster fits on the
// card.
template <typename K, typename... Args>
int launch_cluster(K kernel, int B, int k, size_t smem, void* stream, Args... args) {
  int err = launch_config(kernel, smem);
  if (err) return err;
  ClusterLaunch l(B, k, smem, stream);
  int clusters = 0;
  cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &l.cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  e = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename K>
int max_clusters(K kernel, int k, size_t smem, int* out) {
  int err = launch_config(kernel, smem);
  if (err) return err;
  ClusterLaunch l(1, k, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, kernel, &l.cfg));
}

}  // namespace

extern "C" {

// alpha [B, S]; the index tables (ops/seglse_pallas.py ArcIndex): dptr
// [1 or B, S + 1], src and arc [1 or B, A] int32 (each sorted position's
// source and original arc id); w, em [1 or B, A] f32 in the arcs' own order
// (em null: 0); writes out [B, S] and, where m_out is not null, each
// destination's shift and sum m_out, z_out [B, S].  sb/wb/eb: 1 where that
// input is per sample; staged: 1 to copy alpha, w and em into shared memory
// (S + A or S + 2 A words).
int seg_lse_fwd(const float* alpha, const int* dptr, const int* src, const int* arc,
                const float* w, const float* em, float* out, float* m_out, float* z_out,
                int B, int S, int A, int sb, int wb, int eb, int staged, void* stream) {
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kStepThreads - 1) / kStepThreads, B);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t smem =
      staged ? (static_cast<size_t>(S) + static_cast<size_t>(A) * (em ? 2 : 1)) * sizeof(float)
             : 0;
  auto kernel = staged ? (em ? seg_lse_fwd_kernel<true, true> : seg_lse_fwd_kernel<true, false>)
                       : (em ? seg_lse_fwd_kernel<false, true> : seg_lse_fwd_kernel<false, false>);
  int err = launch_config(kernel, smem);
  if (err) return err;
  kernel<<<grid, kStepThreads, smem, st>>>(alpha, dptr, src, arc, w, em, out, m_out, z_out, S,
                                           A, sb, wb, eb);
  return static_cast<int>(cudaGetLastError());
}

// The VJP of seg_lse_fwd from its saved m, z [B, S] and the cotangent g
// [B, S] of its output; the index by source: sptr [1 or B, S + 1], sarc
// and sdst [1 or B, A]; w, em as seg_lse_fwd's.  Writes dalpha [B, S] and,
// where it is not null, dcontrib [B, A] in the arcs' own order.
int seg_lse_bwd(const float* alpha, const float* g, const float* m, const float* z,
                const int* sptr, const int* sarc, const int* sdst, const float* w,
                const float* em, float* dalpha, float* dcontrib, int B, int S, int A,
                int sb, int wb, int eb, void* stream) {
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kStepThreads - 1) / kStepThreads, B);
  auto kernel = em ? seg_lse_bwd_kernel<true> : seg_lse_bwd_kernel<false>;
  kernel<<<grid, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      alpha, g, m, z, sptr, sarc, sdst, w, em, dalpha, dcontrib, S, A, sb, wb, eb);
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

// em [B, T, C], alpha0 [B, S], lens [B]; the main arcs in the index's
// destination order (src, label) and their weights w, the epsilon arcs'
// (esrc) and weights ew (null when depth is 0); the schedule sched [rows,
// k, stride] (qb: 1 where a row per sample); traj [B, T + 1, S], alpha
// relative to shift [B, T + 1] (float64: the running sum of the frames'
// shifts).  sb, wb, esb, ewb: 1 where per sample.  k: blocks a cluster;
// fwd_words, n_own, a_own, e_own, parts: the schedule's sizes; in_smem:
// stage the tables and schedule in shared memory (the caller checked that
// they fit; the state always must).
int sparse_scan_fwd(const float* em, const float* alpha0, const int* lens, const int* src,
                    const int* label, const float* w, const int* esrc, const float* ew,
                    const int* sched, float* traj, double* shift, int B, int T, int C,
                    int S, int A, int E, int depth, int sb, int wb, int esb, int ewb,
                    int qb, int k, int stride, int fwd_words, int n_own, int a_own,
                    int e_own, int parts, int in_smem, void* stream) {
  if (B == 0 || S == 0) return 0;
  long words = fwd_state_words(S, C, n_own, parts);
  if (in_smem) words += fwd_table_words(a_own, e_own, fwd_words);
  return launch_cluster(sparse_scan_fwd_kernel, B, k, static_cast<size_t>(words) * 4,
                        stream, em, alpha0, lens, src, label, w, esrc, ew, sched, traj,
                        shift, T, C, S, A, E, depth, sb, wb, esb, ewb, qb, stride,
                        fwd_words, n_own, a_own, e_own, parts, in_smem);
}

// As sparse_scan_fwd, with the (shifted) traj [B, T + 1, S] and the final
// cotangent g_final [B, S], and the schedule's (rank, offset) codes by
// source (sref [rows, A]), epsilon source (esref [rows, E]) and label
// (lref [rows, A]); writes dem [B, T, C], dw [B, A] and deps [B, E]
// (float64; deps null when depth is 0; both in the index's arc order) and
// dalpha0 [B, S].  scratch: null, or [B k, bwd_own_words] words of global
// memory for the own state where it does not fit in shared memory
// (own_smem 0; in_smem must then be 0).
int sparse_scan_bwd(const float* em, const float* traj, const int* lens,
                    const float* g_final, const int* src, const int* label, const float* w,
                    const int* esrc, const float* ew, const int* sched, const int* sref,
                    const int* esref, const int* lref, float* dem, double* dw,
                    double* deps, float* dalpha0, float* scratch, int B, int T, int C,
                    int S, int A, int E, int depth, int sb, int wb, int esb, int ewb,
                    int qb, int k, int stride, int n_own, int a_own, int e_own, int parts,
                    int sj_own, int ej_own, int lj_own, int own_smem, int in_smem,
                    void* stream) {
  if (B == 0 || S == 0) return 0;
  if (own_smem == (scratch != nullptr) || (in_smem && !own_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  long words = bwd_shared_words(S, C, depth, a_own, e_own, parts);
  if (own_smem) words += bwd_own_words(depth, n_own, a_own, e_own);
  if (in_smem) words += bwd_table_words(a_own, e_own, stride, sj_own, ej_own, lj_own);
  return launch_cluster(sparse_scan_bwd_kernel, B, k, static_cast<size_t>(words) * 4,
                        stream, em, traj, lens, g_final, src, label, w, esrc, ew, sched,
                        sref, esref, lref, dem, dw, deps, dalpha0, scratch, T, C, S, A, E,
                        depth, sb, wb, esb, ewb, qb, stride, n_own, a_own, e_own, parts,
                        sj_own, ej_own, lj_own, own_smem, in_smem);
}

// B clusters of k blocks run `phases` phases of the scans' chain without
// arcs (sparse_scan_probe_kernel); out [B k].
int sparse_scan_probe(float* out, int B, int k, int phases, void* stream) {
  return launch_cluster(sparse_scan_probe_kernel, B, k, 0, stream, out, phases);
}

// How many clusters of k blocks of the forward (backward 0) or backward
// (1) scan, with smem_bytes of shared memory each, the card holds at once:
// *out.
int sparse_scan_fit(int* out, int backward, int k, int smem_bytes, void* stream) {
  (void)stream;
  const size_t smem = static_cast<size_t>(smem_bytes);
  return backward ? max_clusters(sparse_scan_bwd_kernel, k, smem, out)
                  : max_clusters(sparse_scan_fwd_kernel, k, smem, out);
}

// em: row (b, t) at em + b * em_sb + t * em_st (C channels), lens [B];
// start, accept [S]; the shared decode table's arcs in the index's
// destination order: arcs [A] int32, each (src + 1) | (label + 1) << 16
// (src -1 where outside [0, S), label -1 where outside [0, C)), w [A] f32
// and ids [A] int32 (the arc id at each sorted position); the table's own
// src and label [A] (tsrc, tlabel: the walk's); the schedule sched [1, k,
// stride]; writes backarcs [B, T, S] int32, final_alpha [B, S], labels
// [B, T] int32 and score [B].  k: blocks a cluster; dst_words, n_own,
// a_own, parts: the schedule's sizes; in_smem: stage the arcs and the
// schedule's list by destination in shared memory (the caller checked that
// they fit; the state always must).
int seg_max_scan(const float* em, const int* lens, const float* start, const float* accept,
                 const int* arcs, const float* w, const int* ids, const int* tsrc,
                 const int* tlabel, const int* sched, int* backarcs, float* final_alpha,
                 int* labels, float* score, int B, int T, int C, int S, int A, int em_sb,
                 int em_st, int k, int stride, int dst_words, int n_own, int a_own,
                 int parts, int in_smem, void* stream) {
  if (B == 0 || S == 0 || T == 0 || A == 0) return 0;
  long words = decode_state_words(S, C, n_own, parts);
  if (in_smem) words += decode_table_words(a_own, dst_words);
  const size_t smem = static_cast<size_t>(words) * 4;
  auto kernel = in_smem ? seg_max_scan_kernel<true> : seg_max_scan_kernel<false>;
  return launch_cluster(kernel, B, k, smem, stream, em, lens, start, accept, arcs, w, ids,
                        tsrc, tlabel, sched, backarcs, final_alpha, labels, score, T, C, S,
                        A, em_sb, em_st, stride, dst_words, n_own, a_own, parts);
}

// How many clusters of k blocks of seg_max_scan (its tables staged in shared
// memory or not), with smem_bytes of shared memory each, the card holds at
// once: *out.
int seg_max_scan_fit(int* out, int k, int smem_bytes, int in_smem, void* stream) {
  (void)stream;
  const size_t smem = static_cast<size_t>(smem_bytes);
  return in_smem ? max_clusters(seg_max_scan_kernel<true>, k, smem, out)
                 : max_clusters(seg_max_scan_kernel<false>, k, smem, out);
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
