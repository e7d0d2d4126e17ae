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
// C=80, 82 states, D=81, 6,480 real arcs) the scan moves ~3 MB (em in,
// slots out; ~1 us at 3.35 TB/s) and does 2 adds and a compare for each of
// B T D S = 53 M slots (~2.1 us at 67 TFLOP/s); but each frame needs the
// last, so a frame's latency sets the time.  The TPU kernel gathered em
// along the arcs first and ran each frame as a one-hot MXU gather plus D
// slice maxima.  Here one block a sample runs the time loop inside, and a
// frame is one pass over the table's real arcs and one block barrier:
// - the arcs come as a list by destination (ops/viterbi_scan_pallas.py
//   pack_buckets): each state's real slots in increasing d, 8 bytes an arc
//   (src | label << 16, weight), so a list position less its row's start
//   is the slot d, and a relaxation is two shared loads (alpha[src],
//   em[label]) besides the arc's own;
// - lanes are matched to in-degree (lane_schedule): a state of n arcs gets
//   a group of g lanes (g a power of two, n / g <= the per-lane cap), a
//   hub of more than 32 cap arcs a warp per chunk; groups of one width fill
//   a warp slot, and every warp serves its slots in turn.  Each lane takes
//   every g-th arc with a strict > (the lowest d wins within a lane), the
//   group merges (value, d) by xor shuffles under "greater, else lower d",
//   and a hub's chunks meet in shared memory after a second barrier (only
//   in tables with hubs);
// - route "registers": where the schedule has no more slots than a block
//   has warps, each lane loads its arcs once into registers (as byte
//   offsets into alpha and the emission row, and the weight) and a frame
//   reads only alpha and the emission row from shared memory; "shared":
//   the arcs and schedule are staged in shared memory; "global": read
//   from global memory (L1/L2) when they do not fit;
// - the emission rows are in shared memory before their frame: a
//   sample's rows all copied (cp.async) before the first frame where they
//   fit beside the rest (rows == T), else a ring of kRing rows filled by
//   cp.async, row t + kRing - 1 during frame t; no frame waits on a global
//   load;
// - alpha is double-buffered, so a frame ends in its one barrier (after
//   its row's copy has landed), and a second one only where hubs merge;
// - a state of no arcs takes no lane (its value is NEG, its slot DEAD in
//   every frame): the block's last threads write it, beside the row copy.
// The backtrace stages the sample's slots and bucket tables in shared
// memory (from global memory when they do not fit) and walks with one
// thread.

#include <climits>
#include <cuda_pipeline.h>
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

// The lane schedule (ops/viterbi_scan_pallas.py lane_schedule): a header,
// then 3 words a slot (g, first task, tasks), 4 a task (key, position,
// arcs, first slot d), 3 a hub (state, first chunk, chunks), 1 a state of
// no arcs.  A task's key is its state, or -1 - p for a hub chunk whose
// (value, d) goes to part p.
// A lane holds at most kLaneArcs arcs and runs that many rounds; a block
// has at most kMaxWarps warps.  Must match the Python side.
constexpr int kLaneArcs = 12;
constexpr int kRing = 8;
constexpr int kMaxWarps = 24;
constexpr int kNoTask = INT_MIN;
enum Head {
  kSlots, kTasks, kHubs, kChunks, kSlotOff, kTaskOff, kHubOff, kCap, kEmpty, kEmptyOff
};
enum Route { kRegisters, kShared, kGlobal };

// What one lane serves in a slot: nl arcs at positions pos, pos + g, ...,
// the first of slot d.
struct Lane {
  int key, pos, nl, d, g;
};

__device__ __forceinline__ Lane lane_task(const int* sched, int q, int lane, int pad) {
  const int* s = sched + sched[kSlotOff] + 3 * q;
  const int g = s[0], i = lane / g, sub = lane & (g - 1);
  Lane ln{kNoTask, pad, 0, 0, g};
  if (i < s[2]) {
    const int* t = sched + sched[kTaskOff] + 4 * (s[1] + i);
    ln.key = t[0];
    ln.nl = t[2] > sub ? (t[2] - sub + g - 1) / g : 0;
    ln.pos = ln.nl > 0 ? t[1] + sub : pad;
    ln.d = t[3] + sub;
  }
  return ln;
}

// The lane's arcs, one a round: each packed (src | label << 16, weight)
// and unpacked into byte offsets into alpha and into an emission row (so a
// relaxation adds no address arithmetic).  A round past the lane's arcs
// reads a real position (or the pad arc) at weight -inf, so it never wins
// and no round needs a branch.
__device__ __forceinline__ void load_arcs(const int2* arcs, const Lane& ln, unsigned* so,
                                          unsigned* lo, float* wv) {
#pragma unroll
  for (int j = 0; j < kLaneArcs; ++j) {
    const int2 a = arcs[j < ln.nl ? ln.pos + j * ln.g : ln.pos];
    so[j] = (static_cast<unsigned>(a.x) & 0xffffu) * sizeof(float);
    lo[j] = (static_cast<unsigned>(a.x) >> 16) * sizeof(float);
    wv[j] = j < ln.nl ? __int_as_float(a.y) : -INFINITY;
  }
}

// The float at byte offset `off` of `base` (shared memory)
__device__ __forceinline__ float at(const float* base, unsigned off) {
  return *reinterpret_cast<const float*>(reinterpret_cast<const char*>(base) + off);
}

// (v, d) merged into (best, bd): greater value, else lower slot
__device__ __forceinline__ void max_merge(float& best, int& bd, float v, int d) {
  if (v > best || (v == best && d < bd)) {
    best = v;
    bd = d;
  }
}

// The best (value, slot) of the lane's group: each lane's strict > over
// its increasing slots, then xor shuffles within the group (g is the same
// across the warp's slot).  The sum is formed in the plain version's order.
__device__ __forceinline__ void relax(const Lane& ln, const unsigned* so, const unsigned* lo,
                                      const float* wv, const float* prev, const float* em_row,
                                      float& best, int& bd) {
  best = -INFINITY;
  int bj = kLaneArcs;
#pragma unroll
  for (int j = 0; j < kLaneArcs; ++j) {
    const float c = (at(prev, so[j]) + wv[j]) + at(em_row, lo[j]);
    if (c > best) {
      best = c;
      bj = j;
    }
  }
  bd = bj < kLaneArcs ? ln.d + bj * ln.g : INT_MAX;
  for (int off = ln.g >> 1; off > 0; off >>= 1)
    max_merge(best, bd, __shfl_xor_sync(kFull, best, off), __shfl_xor_sync(kFull, bd, off));
}

// Start copying one emission row into the ring (or nothing); one commit
// group either way, so that the waits count rows.  The block's last
// threads copy (as they write the states of no arcs): the schedule gives
// its last warps the least work.
__device__ __forceinline__ void fetch_row(float* ring, const float* em_b, int r, int t_live,
                                          int C) {
  if (r < t_live) {
    float* dst = ring + (r % kRing) * C;
    const float* src = em_b + static_cast<long>(r) * C;
    for (int c = blockDim.x - 1 - threadIdx.x; c < C; c += blockDim.x)
      __pipeline_memcpy_async(dst + c, src + c, sizeof(float));
  }
  __pipeline_commit();
}

// Every row but the kRing - 2 latest fetched has landed (this thread's).
__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 2) : "memory");
}

template <int kRoute>
__global__ void __launch_bounds__(kMaxWarps * 32)
viterbi_scan_fwd_kernel(const float* __restrict__ em, const int2* arcs, const int* sched,
                        const float* __restrict__ start, const int* __restrict__ lens,
                        int* __restrict__ slots, float* __restrict__ final_alpha, int T,
                        int C, int S, int A, int sched_words, int chunks, int rows) {
  extern __shared__ __align__(16) float fsmem[];
  float* p = fsmem;
  if (kRoute == kShared) {
    int2* arcs_s = reinterpret_cast<int2*>(p);
    for (int i = threadIdx.x; i <= A; i += blockDim.x) arcs_s[i] = arcs[i];
    int* sched_s = reinterpret_cast<int*>(p + 2L * (A + 1));
    for (int i = threadIdx.x; i < sched_words; i += blockDim.x) sched_s[i] = sched[i];
    arcs = arcs_s;
    sched = sched_s;
    p += 2L * (A + 1) + sched_words;
  }
  float* al0 = p;  // alpha by frame parity: frame t reads al0 (t even) or al1
  float* al1 = al0 + S;
  float* ring = al1 + S;
  float* part_v = ring + static_cast<long>(rows) * C;
  int* part_d = reinterpret_cast<int*>(part_v + chunks);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t_live = min(max(lens[b], 0), T);
  const float* em_b = em + static_cast<long>(b) * T * C;
  // the emission rows: all of them (one copy before the frames) where
  // rows == T, else a ring of kRing filled kRing - 1 frames ahead
  const bool in_ring = rows < T;
  if (in_ring) {
    for (int r = 0; r < kRing - 1; ++r) fetch_row(ring, em_b, r, t_live, C);
  } else {
    for (long i = threadIdx.x; i < static_cast<long>(t_live) * C; i += blockDim.x)
      __pipeline_memcpy_async(ring + i, em_b + i, sizeof(float));
    __pipeline_commit();
  }
  for (int s = threadIdx.x; s < S; s += blockDim.x) al0[s] = start[s];
  __syncthreads();  // the staged tables
  const int nslots = sched[kSlots];
  const int nhubs = sched[kHubs];
  const int nempty = sched[kEmpty];
  const int* hubs = sched + sched[kHubOff];
  const int* empty = sched + sched[kEmptyOff];

  Lane ln{kNoTask, A, 0, 0, 1};
  unsigned so[kLaneArcs], lo[kLaneArcs];
  float wv[kLaneArcs];
  if (kRoute == kRegisters && warp < nslots) {
    ln = lane_task(sched, warp, lane, A);
    load_arcs(arcs, ln, so, lo, wv);
  }
  if (in_ring)
    wait_rows();
  else
    __pipeline_wait_prior(0);
  __syncthreads();  // row 0 (every row)

  int* slots_b = slots + static_cast<long>(b) * T * S;
  for (int t = 0; t < t_live; ++t) {
    const float* prev = (t & 1) ? al1 : al0;
    float* next = (t & 1) ? al0 : al1;
    const float* em_row = ring + (in_ring ? t % kRing : t) * C;
    int* slot_t = slots_b + static_cast<long>(t) * S;
    auto emit = [&](int s, float v, int d) {
      v = fmaxf(v, kNeg);
      next[s] = v;
      slot_t[s] = v > kNeg ? d : kDead;
    };
    // the ring slot of row t - 1, read in frame t - 1 (before its barrier)
    if (in_ring) fetch_row(ring, em_b, t + kRing - 1, t_live, C);
    for (int i = blockDim.x - 1 - threadIdx.x; i < nempty; i += blockDim.x)
      emit(empty[i], -INFINITY, INT_MAX);
    for (int q = warp; q < nslots; q += nwarps) {
      if (kRoute != kRegisters) {
        ln = lane_task(sched, q, lane, A);
        load_arcs(arcs, ln, so, lo, wv);
      }
      float best;
      int bd;
      relax(ln, so, lo, wv, prev, em_row, best, bd);
      if (ln.key != kNoTask && (lane & (ln.g - 1)) == 0) {
        if (ln.key >= 0) {
          emit(ln.key, best, bd);
        } else {
          part_v[-1 - ln.key] = best;
          part_d[-1 - ln.key] = bd;
        }
      }
    }
    if (nhubs > 0) {
      __syncthreads();  // the hub chunks' parts
      for (int i = threadIdx.x; i < nhubs; i += blockDim.x) {
        const int* h = hubs + 3 * i;
        float best = -INFINITY;
        int bd = INT_MAX;
        for (int c = h[1]; c < h[1] + h[2]; ++c) max_merge(best, bd, part_v[c], part_d[c]);
        emit(h[0], best, bd);
      }
    }
    if (in_ring) wait_rows();
    __syncthreads();  // next complete, row t + 1 landed
  }
  __pipeline_wait_prior(0);
  for (int t = t_live; t < T; ++t) {
    int* slot_t = slots_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) slot_t[s] = kDead;
  }
  const float* fin = (t_live & 1) ? al1 : al0;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    final_alpha[static_cast<long>(b) * S + s] = fin[s];
}

// One frame of the scan's chain without arcs: a dependent shared-memory
// load and a block barrier, `frames` times, in each of B blocks.
__global__ void viterbi_chain_probe_kernel(int* __restrict__ out, int frames) {
  __shared__ int link[64];
  for (int k = threadIdx.x; k < 64; k += blockDim.x) link[k] = (7 * k + 1) & 63;
  __syncthreads();
  int i = threadIdx.x & 63;
  for (int f = 0; f < frames; ++f) {
    i = link[i];
    __syncthreads();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = i;
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

// em [B, T, C] f32, the plan's arcs by destination [A + 1] (int2: src |
// label << 16 and the weight's bits; the last a pad arc of weight -inf)
// and its lane schedule (sched_words int32), start [S] f32, lens [B] i32
// -> slots [B, T, S] i32 and final alpha [B, S] f32.  threads: 32 a slot
// of the schedule, at most 32 kMaxWarps (route kRegisters: exactly 32 a
// slot); route: kRegisters, kShared or kGlobal; rows: T (every emission
// row staged) or kRing (a ring).  Shared memory: (2 S + rows C + 2 chunks)
// words, plus 2 (A + 1) + sched_words for route kShared.
int viterbi_scan_fwd(const float* em, const int* arcs, const int* sched,
                     const float* start, const int* lens, int* slots,
                     float* final_alpha, int B, int T, int C, int S, int A,
                     int sched_words, int chunks, int threads, int route, int rows,
                     void* stream) {
  if (B == 0 || S == 0) return 0;
  if (rows != T && rows != kRing) return static_cast<int>(cudaErrorInvalidValue);
  long words = 2L * S + static_cast<long>(rows) * C + 2L * chunks;
  if (route == kShared) words += 2L * (A + 1) + sched_words;
  const size_t smem = static_cast<size_t>(words) * sizeof(float);
  auto kernel = route == kRegisters ? viterbi_scan_fwd_kernel<kRegisters>
                : route == kShared  ? viterbi_scan_fwd_kernel<kShared>
                                    : viterbi_scan_fwd_kernel<kGlobal>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      em, reinterpret_cast<const int2*>(arcs), sched, start, lens, slots,
      final_alpha, T, C, S, A, sched_words, chunks, rows);
  return static_cast<int>(cudaGetLastError());
}

// B blocks of `threads` threads run `frames` frames of the scan's chain
// without arcs (viterbi_chain_probe_kernel); out [B threads] i32.
int viterbi_chain_probe(int* out, int B, int threads, int frames, void* stream) {
  viterbi_chain_probe_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, frames);
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
