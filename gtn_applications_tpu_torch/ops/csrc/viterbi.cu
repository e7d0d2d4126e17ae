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
// row.  Here one block a sample walks its table out of a ring of kBtRing
// chunks in shared memory, each F frames of C words (dense_bt_frames: F
// about kBtChunkWords / C, fewer where kBtRing chunks would not fit), taken
// from the last frame backwards:
// - warps 1.. copy: a chunk's words are contiguous in global memory, so
//   they go as 16-byte cp.async, every copying thread at once, with a
//   4-byte head up to the first 16-byte boundary and a 4-byte tail; the
//   chunk sits in its shared slot at the same offset mod 4 words as in
//   global memory (a sample starts at b (T-1) C words, misaligned for odd
//   b where (T-1) C is odd), so the body's copies are aligned on both
//   sides.  Each copying thread then arrives on the slot's "full" mbarrier
//   when its copies land (cp.async.mbarrier.arrive.noinc);
// - thread 0 walks: it waits on the chunk's "full" mbarrier alone (no
//   block barrier), walks its frames (one dependent shared load a frame;
//   the path stored fire-and-forget to global memory, off the chain) and
//   arrives on the slot's "empty" mbarrier, on which the copiers wait to
//   refill it with the chunk kBtRing further back.  (A shared store of the
//   path a frame, then a coalesced store a chunk, made the frame slower:
//   scripts/profile_dense_bt.py.)
// One route for every T.  Where kBtRing chunks of one frame do not fit (C
// past 19,365 words at 227 KB of shared memory) thread 0 walks the table
// straight from global memory, one dependent load a frame.

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
// The backtrace is the tail of the same launch (walk mode), not a launch
// of its own:
// - walk words: when a frame emits state s from its winning arc, it also
//   writes that arc's packed word src | label << 16 (the list's own first
//   word, held in registers beside the arc's offsets; the group's winner is
//   lane d mod g of its group, so one shuffle brings it to the group's first
//   lane), or on a DEAD slot s | 0xffff << 16 (label -1, the state kept);
// - route "walk shared": a sample's T x S words stay in shared memory beside
//   the alpha, the rows and the route's tables; route "walk chunked" (where
//   they do not fit, ops/viterbi_scan_pallas.py walk_route): a frame's row
//   is staged in shared memory and stored coalesced to a global scratch
//   [B, T, S padded to 4], which the walk reads back by chunks of
//   kWalkChunk frames, double-buffered by 16-byte cp.async;
// - after the last frame the block takes the first argmax of final + accept
//   (warp shuffles, then one merge of the warps: the lowest state on ties,
//   as torch.max), writes score and final alpha, and one thread walks: a
//   live frame is one dependent shared load, the word, whose halves are
//   the label and the next state; frames past the length and infeasible
//   samples (score <= NEG/2) write -1 with no load.  The labels go through
//   shared memory and are stored coalesced.

#include <climits>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kDead = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

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
// The walk: frames a chunk of route "walk chunked", and the label half of a
// DEAD slot's word.  Must match the Python side.
constexpr int kWalkChunk = 32;
constexpr unsigned kDeadLabel = 0xffffu;
enum Head {
  kSlots, kTasks, kHubs, kChunks, kSlotOff, kTaskOff, kHubOff, kCap, kEmpty, kEmptyOff
};
enum Route { kRegisters, kShared, kGlobal };
enum Walk { kNoWalk, kWalkShared, kWalkChunked };

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

// Shared memory of the walk, in words: the walk words (a sample's T S, or
// two chunks of padded rows), the labels and the argmax's scratch.
__host__ __device__ __forceinline__ int walk_words(int walk, int T, int S) {
  if (walk == kNoWalk) return 0;
  const int rows = walk == kWalkShared ? round4(T * S) : 2 * kWalkChunk * round4(S);
  return rows + round4(T) + 64;
}

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
// relaxation adds no address arithmetic); with kWords the packed word too
// (the walk's word).  A round past the lane's arcs reads a real position
// (or the pad arc) at weight -inf, so it never wins and no round needs a
// branch.
template <bool kWords>
__device__ __forceinline__ void load_arcs(const int2* arcs, const Lane& ln, unsigned* so,
                                          unsigned* lo, float* wv, unsigned* pw) {
#pragma unroll
  for (int j = 0; j < kLaneArcs; ++j) {
    const int2 a = arcs[j < ln.nl ? ln.pos + j * ln.g : ln.pos];
    so[j] = (static_cast<unsigned>(a.x) & 0xffffu) * sizeof(float);
    lo[j] = (static_cast<unsigned>(a.x) >> 16) * sizeof(float);
    wv[j] = j < ln.nl ? __int_as_float(a.y) : -INFINITY;
    if constexpr (kWords) pw[j] = static_cast<unsigned>(a.x);
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
// With kWords also the winning arc's word: slot d is lane d mod g's of the
// group (a group's first slot is a multiple of g), so one shuffle from that
// lane brings it.
template <bool kWords>
__device__ __forceinline__ void relax(const Lane& ln, const unsigned* so, const unsigned* lo,
                                      const float* wv, const unsigned* pw, const float* prev,
                                      const float* em_row, float& best, int& bd, unsigned& bw) {
  best = -INFINITY;
  int bj = kLaneArcs;
  unsigned w = 0;
#pragma unroll
  for (int j = 0; j < kLaneArcs; ++j) {
    const float c = (at(prev, so[j]) + wv[j]) + at(em_row, lo[j]);
    if (c > best) {
      best = c;
      bj = j;
      if constexpr (kWords) w = pw[j];
    }
  }
  bd = bj < kLaneArcs ? ln.d + bj * ln.g : INT_MAX;
  for (int off = ln.g >> 1; off > 0; off >>= 1)
    max_merge(best, bd, __shfl_xor_sync(kFull, best, off), __shfl_xor_sync(kFull, bd, off));
  if constexpr (kWords)
    bw = __shfl_sync(kFull, w, (threadIdx.x & 31 & ~(ln.g - 1)) | (bd & (ln.g - 1)));
}

// Copy 16 bytes from global to shared memory through L2 (cp.async.cg).
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(to), "l"(src) : "memory");
}

// Store a staged row of n words (a multiple of 4) to global memory, 16
// bytes a thread, by the block's last threads (the schedule gives its last
// warps the least work).
__device__ __forceinline__ void store_row(unsigned* dst, const unsigned* src, int n) {
  for (int i = blockDim.x - 1 - threadIdx.x; i < n / 4; i += blockDim.x)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// The walk down frames hi .. lo from `state`, over rows of `stride` words
// whose first is frame row0: one dependent shared load a frame, the word,
// whose halves are the label (kDeadLabel: -1) and the next state.
__device__ __forceinline__ int walk_frames(const unsigned* rows, int stride, int row0, int hi,
                                           int lo, int state, int* out) {
  for (int t = hi; t >= lo; --t) {
    const unsigned w = rows[(t - row0) * stride + state];
    const unsigned lab = w >> 16;
    out[t] = lab == kDeadLabel ? -1 : static_cast<int>(lab);
    state = static_cast<int>(w & 0xffffu);
  }
  return state;
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

template <int kRoute, int kWalk>
__global__ void __launch_bounds__(kMaxWarps * 32)
viterbi_scan_fwd_kernel(const float* __restrict__ em, const int2* arcs, const int* sched,
                        const float* __restrict__ start, const int* __restrict__ lens,
                        int* __restrict__ slots, float* __restrict__ final_alpha,
                        const float* __restrict__ accept, int* __restrict__ labels,
                        float* __restrict__ score, unsigned* __restrict__ words, int T, int C,
                        int S, int A, int sched_words, int chunks, int rows) {
  constexpr bool kWords = kWalk != kNoWalk;
  extern __shared__ __align__(16) float fsmem[];
  float* p = fsmem;
  // the walk's area first (16-byte aligned for the chunks' copies): its
  // words, the labels, the argmax's scratch
  unsigned* walk_s = reinterpret_cast<unsigned*>(p);
  const int walk_rows = kWalk == kWalkShared ? round4(T * S) : 2 * kWalkChunk * round4(S);
  int* labels_s = reinterpret_cast<int*>(p + walk_rows);
  float* red_v = p + walk_rows + round4(T);
  int* red_s = reinterpret_cast<int*>(red_v + 32);
  p += walk_words(kWalk, T, S);
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
  unsigned* part_w = reinterpret_cast<unsigned*>(part_d + chunks);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int t_live = min(max(lens[b], 0), T);
  const int S_pad = round4(S);
  unsigned* words_b = words + static_cast<long>(b) * T * S_pad;  // walk chunked
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
  unsigned so[kLaneArcs], lo[kLaneArcs], pw[kWords ? kLaneArcs : 1];
  float wv[kLaneArcs];
  if (kRoute == kRegisters && warp < nslots) {
    ln = lane_task(sched, warp, lane, A);
    load_arcs<kWords>(arcs, ln, so, lo, wv, pw);
  }
  if (in_ring)
    wait_rows();
  else
    __pipeline_wait_prior(0);
  __syncthreads();  // row 0 (every row)

  int* slots_b = slots + static_cast<long>(b) * T * S;
  int* slot_t = slots_b;  // frame t's slots, advanced a frame at a time
  for (int t = 0; t < t_live; ++t, slot_t += S) {
    const float* prev = (t & 1) ? al1 : al0;
    float* next = (t & 1) ? al0 : al1;
    const float* em_row = ring + (in_ring ? t % kRing : t) * C;
    // walk chunked: frame t's words are staged in shared row t & 1 and
    // stored to the global scratch, coalesced, during frame t + 1
    unsigned* word_t = kWalk == kWalkShared    ? walk_s + t * S
                       : kWalk == kWalkChunked ? walk_s + (t & 1) * S_pad
                                               : nullptr;
    if (kWalk == kWalkChunked && t > 0)
      store_row(words_b + (t - 1L) * S_pad, walk_s + ((t - 1) & 1) * S_pad, S_pad);
    auto emit = [&](int s, float v, int d, unsigned w) {
      v = fmaxf(v, kNeg);
      next[s] = v;
      slot_t[s] = v > kNeg ? d : kDead;
      if constexpr (kWords) word_t[s] = v > kNeg ? w : (kDeadLabel << 16) | s;
    };
    // the ring slot of row t - 1, read in frame t - 1 (before its barrier)
    if (in_ring) fetch_row(ring, em_b, t + kRing - 1, t_live, C);
    for (int i = blockDim.x - 1 - threadIdx.x; i < nempty; i += blockDim.x)
      emit(empty[i], -INFINITY, INT_MAX, 0u);
    for (int q = warp; q < nslots; q += nwarps) {
      if (kRoute != kRegisters) {
        ln = lane_task(sched, q, lane, A);
        load_arcs<kWords>(arcs, ln, so, lo, wv, pw);
      }
      float best;
      int bd;
      unsigned bw = 0;
      relax<kWords>(ln, so, lo, wv, pw, prev, em_row, best, bd, bw);
      if (ln.key != kNoTask && (lane & (ln.g - 1)) == 0) {
        if (ln.key >= 0) {
          emit(ln.key, best, bd, bw);
        } else {
          part_v[-1 - ln.key] = best;
          part_d[-1 - ln.key] = bd;
          if constexpr (kWords) part_w[-1 - ln.key] = bw;
        }
      }
    }
    if (nhubs > 0) {
      __syncthreads();  // the hub chunks' parts
      for (int i = threadIdx.x; i < nhubs; i += blockDim.x) {
        const int* h = hubs + 3 * i;
        float best = -INFINITY;
        int bd = INT_MAX;
        unsigned bw = 0;
        for (int c = h[1]; c < h[1] + h[2]; ++c) {
          if (part_v[c] > best || (part_v[c] == best && part_d[c] < bd)) {
            best = part_v[c];
            bd = part_d[c];
            if constexpr (kWords) bw = part_w[c];
          }
        }
        emit(h[0], best, bd, bw);
      }
    }
    if (in_ring) wait_rows();
    __syncthreads();  // next complete, row t + 1 landed
  }
  __pipeline_wait_prior(0);
  if (kWalk == kWalkChunked && t_live > 0)
    store_row(words_b + (t_live - 1L) * S_pad, walk_s + ((t_live - 1) & 1) * S_pad, S_pad);
  for (int t = t_live; t < T; ++t) {
    int* dead_t = slots_b + static_cast<long>(t) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) dead_t[s] = kDead;
  }
  const float* fin = (t_live & 1) ? al1 : al0;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    final_alpha[static_cast<long>(b) * S + s] = fin[s];
  if constexpr (!kWords) return;

  // the walk: the first argmax of final + accept (each thread's states in
  // increasing s with a strict >, then the warps' and the block's merges
  // under "greater, else lower state": torch.max's first index)
  float v = -INFINITY;
  int arg = INT_MAX;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float x = fin[s] + accept[s];
    if (x > v) {
      v = x;
      arg = s;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    max_merge(v, arg, __shfl_xor_sync(kFull, v, off), __shfl_xor_sync(kFull, arg, off));
  if (lane == 0) {
    red_v[warp] = v;
    red_s[warp] = arg;
  }
  // chunked: the scan's global words reach L2 before the cp.async reads
  if (kWalk == kWalkChunked) __threadfence();
  __syncthreads();
  if (warp == 0) {
    v = lane < nwarps ? red_v[lane] : -INFINITY;
    arg = lane < nwarps ? red_s[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1)
      max_merge(v, arg, __shfl_xor_sync(kFull, v, off), __shfl_xor_sync(kFull, arg, off));
    if (lane == 0) {
      red_v[31] = v;
      red_s[31] = arg;
      score[b] = v;
    }
  }
  __syncthreads();
  // frames the walk takes: the live ones of a feasible sample; the others
  // are -1 with no load
  const int walked = red_v[31] > kNeg / 2 ? t_live : 0;
  int state = red_s[31];
  for (int t = walked + threadIdx.x; t < T; t += blockDim.x) labels_s[t] = -1;
  if (kWalk == kWalkShared) {
    if (threadIdx.x == 0) walk_frames(walk_s, S, 0, walked - 1, 0, state, labels_s);
  } else if (walked > 0) {
    // chunks of kWalkChunk frames from the last, each copied while the one
    // above it is walked
    const int nck = (walked + kWalkChunk - 1) / kWalkChunk;
    for (int c = nck - 1; c >= 0; --c) {
      // chunk c - 1 (and chunk c, the last, before the walk starts) copied
      // into buffer (chunk & 1) while chunk c is walked; a commit group each
      for (int f = c == nck - 1 ? c : c - 1; f >= max(c - 1, 0); --f) {
        const int t0 = f * kWalkChunk;
        const int n = (min(t0 + kWalkChunk, walked) - t0) * S_pad / 4;
        const uint4* from = reinterpret_cast<const uint4*>(words_b + static_cast<long>(t0) * S_pad);
        uint4* to = reinterpret_cast<uint4*>(walk_s + (f & 1) * kWalkChunk * S_pad);
        for (int i = threadIdx.x; i < n; i += blockDim.x) copy16(to + i, from + i);
        __pipeline_commit();
      }
      if (c > 0)
        __pipeline_wait_prior(1);
      else
        __pipeline_wait_prior(0);
      __syncthreads();  // chunk c landed (every thread's copies)
      const int t0 = c * kWalkChunk;
      if (threadIdx.x == 0)
        state = walk_frames(walk_s + (c & 1) * kWalkChunk * S_pad, S_pad, t0,
                            min(t0 + kWalkChunk, walked) - 1, t0, state, labels_s);
      __syncthreads();  // chunk c walked: its buffer is free
    }
  }
  __syncthreads();
  int* lab_b = labels + static_cast<long>(b) * T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) lab_b[t] = labels_s[t];
}

// The dense backtrace's ring (see the header): kBtRing chunks of F frames,
// each at most about kBtChunkWords words (16 KB), in blocks of kBtThreads
// (warp 0's thread 0 walks, the other warps copy).  Must match the Python
// side (ops/viterbi_scan_pallas.py dense_bt_plan).
constexpr int kBtRing = 3;
constexpr int kBtChunkWords = 4096;
constexpr int kBtThreads = 128;

// A ring slot of F frames of C words: 3 words of room for the offset mod 4
// and rounded up to 16 bytes.
__host__ __device__ __forceinline__ int bt_slot_words(int F, int C) { return round4(F * C + 3); }

// Frames a chunk for a [T-1, C] table in max_smem bytes, or 0 where
// kBtRing chunks of one frame do not fit (the global walk).
int dense_bt_frames(int T, int C, int max_smem) {
  const int cap = (max_smem / (4 * kBtRing)) & ~3;  // a slot's words at most
  const int most = (cap - 3) / C;
  if (most < 1) return 0;
  int F = kBtChunkWords / C < 1 ? 1 : kBtChunkWords / C;
  F = F < most ? F : most;
  return F < T - 1 ? F : T - 1;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n .reg .pred q;\n mbarrier.try_wait.parity.shared::cta.b64 q, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, q;\n}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__global__ void __launch_bounds__(kBtThreads)
dense_backtrace_kernel(const int* __restrict__ bp, const int* __restrict__ last,
                       int* __restrict__ path, int T, int C, int F) {
  extern __shared__ __align__(16) int bt_ring[];
  __shared__ unsigned long long full[kBtRing], empty[kBtRing];
  const int b = blockIdx.x;
  const long g_b = static_cast<long>(b) * (T - 1) * C;  // the sample's first word
  int* path_b = path + static_cast<long>(b) * T;
  if (F == 0) {  // the global walk
    if (threadIdx.x == 0) {
      int state = last[b];
      path_b[T - 1] = state;
      for (int t = T - 2; t >= 0; --t) {
        state = bp[g_b + static_cast<long>(t) * C + state];
        path_b[t] = state;
      }
    }
    return;
  }
  // chunk j holds frames [j F, min(j F + F, T - 1)); the c-th copied and
  // walked is j = nck - 1 - c, in slot c mod kBtRing
  const int nck = (T - 2) / F + 1;
  const int slot = bt_slot_words(F, C);
  const int copiers = blockDim.x - 32;
  if (threadIdx.x < kBtRing) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(&full[threadIdx.x])),
                 "r"(copiers));
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(&empty[threadIdx.x])));
  }
  __syncthreads();  // the barriers' initialisation; none after it

  if (threadIdx.x < 32) {
    if (threadIdx.x > 0) return;
    int state = last[b];
    path_b[T - 1] = state;
    for (int c = 0; c < nck; ++c) {
      const int j = nck - 1 - c, t0 = j * F, t1 = min(t0 + F, T - 1), r = c % kBtRing;
      mbar_wait(&full[r], (c / kBtRing) & 1);
      // frame t1 - 1's row: the slot, the chunk's offset mod 4, its frames
      const int* row = bt_ring + r * slot + static_cast<int>((g_b + static_cast<long>(t0) * C) & 3)
                       + (t1 - 1 - t0) * C;
      for (int t = t1 - 1; t >= t0; --t, row -= C) {
        state = row[state];
        path_b[t] = state;
      }
      asm volatile("{\n .reg .b64 st;\n mbarrier.arrive.shared::cta.b64 st, [%0];\n}"
                   ::"r"(smem_addr(&empty[r])) : "memory");
    }
    return;
  }
  const int ct = threadIdx.x - 32;
  for (int c = 0; c < nck; ++c) {
    const int j = nck - 1 - c, t0 = j * F, r = c % kBtRing;
    const int words = (min(t0 + F, T - 1) - t0) * C;
    if (c >= kBtRing) mbar_wait(&empty[r], (c / kBtRing - 1) & 1);  // chunk c - kBtRing walked
    const long g0 = g_b + static_cast<long>(t0) * C;
    const int mis = static_cast<int>(g0 & 3);
    const int head = min((4 - mis) & 3, words);
    const int body = (words - head) >> 2;
    const int tail = words - head - 4 * body;
    int* dst = bt_ring + r * slot + mis;
    const int* src = bp + g0;
    if (ct < head) __pipeline_memcpy_async(dst + ct, src + ct, sizeof(int));
    for (int i = ct; i < body; i += copiers) copy16(dst + head + 4 * i, src + head + 4 * i);
    if (ct < tail) {
      const int k = head + 4 * body + ct;
      __pipeline_memcpy_async(dst + k, src + k, sizeof(int));
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 ::"r"(smem_addr(&full[r])) : "memory");
  }
  __pipeline_wait_prior(0);
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

// One frame of the walk's chain: the dependent shared load of a word and
// its unpacking (walk_frames over a 16 x 64 table, labels to shared
// memory), `frames` times, one thread in each of B blocks.
__global__ void backtrace_chain_probe_kernel(int* __restrict__ out, int frames) {
  __shared__ unsigned table[16 * 64];
  __shared__ int labs[16];
  for (int k = threadIdx.x; k < 16 * 64; k += blockDim.x)
    table[k] = static_cast<unsigned>((7 * k + 1) & 63) | ((k % 3 ? k & 63 : kDeadLabel) << 16);
  __syncthreads();
  if (threadIdx.x == 0) {
    int state = 0;
    for (int f = 0; f < frames; f += 16) state = walk_frames(table, 64, 0, 15, 0, state, labs);
    out[blockIdx.x] = state + labs[0];
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

// bp [B, T-1, C], last [B] int32 -> path [B, T] int32, T >= 2.  A ring of
// kBtRing chunks of dense_bt_frames(T, C, max_smem) frames in shared
// memory, or (0 frames) the walk from global memory.
int dense_backtrace(const int* bp, const int* last, int* path, int B, int T,
                    int C, int max_smem, void* stream) {
  if (B == 0) return 0;
  const int F = dense_bt_frames(T, C, max_smem);
  const size_t smem = F ? static_cast<size_t>(kBtRing) * bt_slot_words(F, C) * sizeof(int) : 0;
  cudaError_t err = allow_smem(dense_backtrace_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_backtrace_kernel<<<B, kBtThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      bp, last, path, T, C, F);
  return static_cast<int>(cudaGetLastError());
}

// em [B, T, C] f32, the plan's arcs by destination [A + 1] (int2: src |
// label << 16 and the weight's bits; the last a pad arc of weight -inf)
// and its lane schedule (sched_words int32), start [S] f32, lens [B] i32
// -> slots [B, T, S] i32 and final alpha [B, S] f32; with walk kWalkShared
// or kWalkChunked also accept [S] f32 -> labels [B, T] i32 and score [B]
// f32 (kWalkChunked: words, a scratch of B T round4(S) i32).  threads: 32 a
// slot of the schedule, at most 32 kMaxWarps (route kRegisters: exactly 32
// a slot); route: kRegisters, kShared or kGlobal; rows: T (every emission
// row staged) or kRing (a ring).  Shared memory: (2 S + rows C + 3 chunks)
// words, plus 2 (A + 1) + sched_words for route kShared and walk_words.
int viterbi_scan_fwd(const float* em, const int* arcs, const int* sched,
                     const float* start, const int* lens, int* slots,
                     float* final_alpha, const float* accept, int* labels, float* score,
                     int* words, int B, int T, int C, int S, int A, int sched_words, int chunks,
                     int threads, int route, int rows, int walk, void* stream) {
  if (B == 0 || S == 0) return 0;
  if (rows != T && rows != kRing) return static_cast<int>(cudaErrorInvalidValue);
  if (route < kRegisters || route > kGlobal || walk < kNoWalk || walk > kWalkChunked)
    return static_cast<int>(cudaErrorInvalidValue);
  long n_words = 2L * S + static_cast<long>(rows) * C + 3L * chunks + walk_words(walk, T, S);
  if (route == kShared) n_words += 2L * (A + 1) + sched_words;
  const size_t smem = static_cast<size_t>(n_words) * sizeof(float);
  using Kernel = decltype(&viterbi_scan_fwd_kernel<kRegisters, kNoWalk>);
  const Kernel kernels[3][3] = {
      {viterbi_scan_fwd_kernel<kRegisters, kNoWalk>, viterbi_scan_fwd_kernel<kRegisters, kWalkShared>,
       viterbi_scan_fwd_kernel<kRegisters, kWalkChunked>},
      {viterbi_scan_fwd_kernel<kShared, kNoWalk>, viterbi_scan_fwd_kernel<kShared, kWalkShared>,
       viterbi_scan_fwd_kernel<kShared, kWalkChunked>},
      {viterbi_scan_fwd_kernel<kGlobal, kNoWalk>, viterbi_scan_fwd_kernel<kGlobal, kWalkShared>,
       viterbi_scan_fwd_kernel<kGlobal, kWalkChunked>}};
  const Kernel kernel = kernels[route][walk];
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      em, reinterpret_cast<const int2*>(arcs), sched, start, lens, slots, final_alpha, accept,
      labels, score, reinterpret_cast<unsigned*>(words), T, C, S, A, sched_words, chunks, rows);
  return static_cast<int>(cudaGetLastError());
}

// B blocks of `threads` threads run `frames` frames of the scan's chain
// without arcs (viterbi_chain_probe_kernel); out [B threads] i32.
int viterbi_chain_probe(int* out, int B, int threads, int frames, void* stream) {
  viterbi_chain_probe_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      out, frames);
  return static_cast<int>(cudaGetLastError());
}

// B blocks run `frames` (a multiple of 16) frames of the walk's chain, one
// thread each (backtrace_chain_probe_kernel); out [B] i32.
int backtrace_chain_probe(int* out, int B, int frames, void* stream) {
  backtrace_chain_probe_kernel<<<B, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, frames);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
