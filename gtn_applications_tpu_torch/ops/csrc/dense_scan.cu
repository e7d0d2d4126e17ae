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
//             alpha[u] = (z >= FLT_MIN && lab[u]) ? em[t, u] + sh + log(max(z, 1e-37))
//                                          : NEG        (sh = 0 at t = 0)
//             frozen (alpha kept) where t >= len; frame 0 always applied.
//   backward: g = dL/dalpha[T-1]; for t = T-1 .. 0 on applied frames:
//             ga = (z >= FLT_MIN && lab) ? g : 0;  dem[t] = ga;  dz = ga / max(z, floor)
//             dadj[u, s] += dz[u] e[s];  g[s] = (sum_u adj[u, s] dz[u]) e[s]
//             (frozen frames: dem = 0, g passes through).
// The floor is 1e-37 (the JAX kernels' and ops/factored.py's), not the CTC
// kernels' 1e-30.  Built without --use_fast_math, so a sum can be a float32
// denormal: one below FLT_MIN is dead (kTiny), as on JAX's devices, which
// flush denormals to zero; kept alive, the floor would lift it to e^-85 of
// its shift, a frame at a time.
//
// What bounds them on the H100: the lattices are almost empty (the STC
// headline, S=96, holds 273 real arcs a sample, 3 % of S^2, in-degree at
// most 3; the 1k word decompositions, S=376, 1,052-1,354, in-degree at
// most 13), so a frame's work is small, and each frame needs the last: the
// chain of T frames bounds both recursions.  Both pairs therefore share one
// design (described above the factored kernels, whose prologue helpers the
// dense kernels call): the adjacency compacted into its real arcs in the
// kernel, lanes matched to degree, emission rows staged, one block barrier
// a frame, and a backward of one statistics pass across the card plus a
// chain of one sparse product by source a frame.  The dense recursion has
// one shift a frame, the largest alpha, where the factored one has one a
// label; the dense kernels are described at their section below.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr float kFloor = 1e-37f;
constexpr float kTiny = 1.17549435e-38f;  // FLT_MIN
constexpr unsigned kFull = 0xffffffffu;

// exp(x) with a result below FLT_MIN flushed to 0, as JAX's devices do:
// kLogTiny is the least float whose expf is normal, so the test runs beside
// the exp rather than after it (one select on the chain; no fast math).
constexpr float kLogTiny = -0x1.5d589ep+6f;  // -87.33654f
__device__ __forceinline__ float exp_ftz(float x) {
  const float e = expf(x);
  return x >= kLogTiny ? e : 0.0f;
}

__device__ __forceinline__ float start_e(float s) {
  return s > kNeg / 2 ? exp_ftz(fminf(s, 0.0f)) : 0.0f;
}

__device__ __forceinline__ int live_steps(int len, int T) {
  return len < 1 ? 1 : (len < T ? len : T);
}

// A float's bits as an int whose order is the float's (an involution).
__device__ __forceinline__ int float_order(int bits) {
  return bits < 0 ? bits ^ 0x7fffffff : bits;
}

// The warp's largest v, exact, in one redux (every lane gets it).
__device__ __forceinline__ float warp_max(float v) {
  return __int_as_float(float_order(__reduce_max_sync(kFull, float_order(__float_as_int(v)))));
}

// The barrier of a frame among the block's first `threads` threads (the
// warps that run the frames; the others have left after the prologue).
__device__ __forceinline__ void frame_sync(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// ---------------------------------------------------------------------------
// Transition-factored recursion.  Each state u has one in-label l_u (or
// none); wsel[s, l] = W[l_s, l] carries the bigram weight of entering label
// l from state s.  The TPU kernel computes, every frame, the full
//   v[s, l] = alpha[s] + wsel[s, l],  sh[l] = max(max_s v[s, l], NEG)
//   z[u, l] = sum_s adj[u, s] exp(v[s, l] - sh[l])     ([S, S] x [S, N])
//   alpha[u] = has[u] ? em[t, u] + (z[u, l_u] >= FLT_MIN ? sh + log(max(z, 1e-37))
//                                                 : NEG) : NEG
// and keeps only column l_u of row u.  Frame 0 enters from
// e0 = exp(min(start, 0)) (start > NEG/2) and adds ws[u]:
// alpha = (z >= FLT_MIN && has) ? (em + ws) + log(max(z, 1e-37)) : NEG.  Frames
// t >= len keep alpha; frame 0 is always applied.  The backward replays the
// trajectory: with ga = has ? g : 0 (dem[t] = ga) and dz[u] = z >= FLT_MIN ?
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
//   rz_t[u] = z >= FLT_MIN ? 1 / max(z, 1e-37) : 0, into scratch of B T (Lmax + S)
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
enum Misc { kNlab, kNnz, kRounds, kRoute, kStaged, kGroup, kWarps, kMiscWords = 8 };

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

// A state's in-label as the factored kernels read it (lab_idx, -1 for
// none) and as the dense kernels do: one label, 0, for every state with
// has_lab > 0, so that their members are the labelled states in order.
struct LabelIndex {
  static constexpr bool kOneSlot = false;
  const int* lab;
  __device__ __forceinline__ int operator()(int u) const { return lab[u]; }
};
struct HasLabel {
  static constexpr bool kOneSlot = true;
  const float* has;
  __device__ __forceinline__ int operator()(int u) const { return has[u] > 0.0f ? 0 : -1; }
};

// Label slots j = 0..Lu-1 in order of first use (label_of[j], jslot[u], -1
// for none) and the members of each slot in increasing u (mem_idx, CSR
// mem_ptr), each by a thread a state comparing it with the states before
// it (O(S) shared loads a thread, no serial pass): a state is its label's
// first use when no earlier state has the label, a first use's slot is
// the number of first uses before it, and a member's place is the members
// of earlier slots and of its slot before it.  arc_ptr holds the labels
// and mem_idx the first-use flags until they are written.  With one slot
// (Labels::kOneSlot) the members are the labelled states in order, placed
// by warp 0's ballots.  Ends in a barrier.
template <typename Labels>
__device__ __forceinline__ void compact_members(Labels label, int S, int N,
                                                const FactPtrs& p) {
  int* lab = p.arc_ptr;
  int* first = p.mem_idx;
  for (int u = threadIdx.x; u < S; u += blockDim.x) lab[u] = label(u);
  __syncthreads();
  if (Labels::kOneSlot) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int n = 0;
      for (int c = 0; c < S; c += 32) {
        const int u = c + lane;
        const bool in = u < S && lab[u] == 0;
        const unsigned bal = __ballot_sync(kFull, in);
        if (u < S) p.jslot[u] = in ? 0 : -1;
        if (in) p.mem_idx[n + __popc(bal & ((1u << lane) - 1u))] = u;
        n += __popc(bal);
      }
      if (lane == 0) {
        p.misc[kNlab] = n > 0;
        p.slot_of[0] = 0;
        p.label_of[0] = 0;
        p.mem_ptr[0] = 0;
        p.mem_ptr[n > 0] = n;
      }
    }
    __syncthreads();
    return;
  }
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

// ptr[i] = cnt[0] + ... + cnt[i - 1] for i = 0..n, by warp 0: 32 entries
// a step, each an inclusive shuffle scan plus the running total (the
// caller's barrier publishes ptr).
__device__ __forceinline__ void offsets(const int* cnt, int* ptr, int n) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int base = 0;
  for (int c = 0; c <= n; c += 32) {
    const int i = c + lane;
    int v = i > 0 && i <= n ? cnt[i - 1] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += o;
    }
    if (i <= n) ptr[i] = base + v;
    base += __shfl_sync(kFull, v, 31);
  }
}

// Four columns of a row at a time: lane l of chunk c holds columns
// 4 (32 c + l) .. + 3 (S a multiple of 4; zeros past S).
__device__ __forceinline__ float4 row_quad(const float* row, int S, int c, int lane) {
  const int q = 32 * c + lane;
  return 4 * q < S ? reinterpret_cast<const float4*>(row)[q] : make_float4(0.f, 0.f, 0.f, 0.f);
}

constexpr int kRowsInFlight = 4;  // rows a warp reads at once in a block's prologue
constexpr int kFactStatsRows = 2;  // the same in the factored statistics pass, whose
                                   // registers decide how many blocks share an SM

// The real arcs into each member (adj[u, s] != 0), counted a warp a row,
// kRows rows at once: cnt[m] = in-degree of member m.  Rows of a multiple
// of 4 columns are read 16 bytes a lane, four such loads a row in flight;
// others 4 bytes a lane.
template <int kRows = kRowsInFlight>
__device__ __forceinline__ void dest_degrees(const float* A, int S, int S_l, const FactPtrs& p,
                                             int* cnt_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int m0 = warp; m0 < S_l; m0 += kRows * nw) {
    const float* row[kRows];
    int cnt[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int m = m0 + r * nw;
      row[r] = m < S_l ? A + static_cast<long>(p.mem_idx[m]) * S : nullptr;
      cnt[r] = 0;
    }
    if ((S & 3) == 0) {
      for (int c0 = 0; 128 * c0 < S; c0 += 4) {
        float4 a[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[r][k] = row[r] ? row_quad(row[r], S, c0 + k, lane) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (128 * (c0 + k) < S)
              cnt[r] += (a[r][k].x != 0.0f) + (a[r][k].y != 0.0f) + (a[r][k].z != 0.0f) +
                        (a[r][k].w != 0.0f);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) cnt[r] = __reduce_add_sync(kFull, cnt[r]);
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (row[r] == nullptr) continue;
        for (int c0 = 0; c0 < S; c0 += 128) {  // four chunks' loads in flight
          float a[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int s = c0 + 32 * k + lane;
            a[k] = s < S ? row[r][s] : 0.0f;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) cnt[r] += __popc(__ballot_sync(kFull, a[k] != 0.0f));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (lane == 0 && row[r] != nullptr) cnt_out[m0 + r * nw] = cnt[r];
  }
}

// Each member's arcs in increasing s from ptr[m], 8 bytes an arc (s, adj
// bits; with kTag s | m << 16): a warp a row (kRows at once where the rows
// are read 16 bytes a lane, as dest_degrees reads them), each
// lane's position the popcount of the ballots below it (the lanes below
// hold the lower columns, the lane's own lower components come first).
template <bool kTag = false, int kRows = kRowsInFlight>
__device__ __forceinline__ void fill_dest_arcs(const float* A, int S, int S_l, const FactPtrs& p,
                                               int2* arcs, const int* ptr = nullptr) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  ptr = ptr ? ptr : p.arc_ptr;
  if ((S & 3) == 0) {
    for (int m0 = warp; m0 < S_l; m0 += kRows * nw) {
      const float* row[kRows];
      int pos[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int m = m0 + r * nw;
        row[r] = m < S_l ? A + static_cast<long>(p.mem_idx[m]) * S : nullptr;
        pos[r] = m < S_l ? ptr[m] : 0;
      }
      for (int c0 = 0; 128 * c0 < S; c0 += 4) {
        float4 a[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            a[r][k] = row[r] ? row_quad(row[r], S, c0 + k, lane) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int tag = kTag ? (m0 + r * nw) << 16 : 0;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (128 * (c0 + k) >= S) break;  // the chunks past S (the same in every lane)
            const float v[4] = {a[r][k].x, a[r][k].y, a[r][k].z, a[r][k].w};
            unsigned bal[4];
            int at = pos[r];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bal[e] = __ballot_sync(kFull, v[e] != 0.0f);
              at += __popc(bal[e] & below);
            }
            const int s0 = 4 * (32 * (c0 + k) + lane);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (v[e] != 0.0f) arcs[at++] = make_int2((s0 + e) | tag, __float_as_int(v[e]));
              pos[r] += __popc(bal[e]);
            }
          }
        }
      }
    }
    return;
  }
  for (int m = warp; m < S_l; m += nw) {
    const float* row = A + static_cast<long>(p.mem_idx[m]) * S;
    const int tag = kTag ? m << 16 : 0;
    int pos = ptr[m];
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
          arcs[pos + __popc(bal & below)] =
              make_int2((c0 + 32 * k + lane) | tag, __float_as_int(a[k]));
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
// rounds are dealt to the warps: one a warp to the first ones where there
// are no more rounds than warps (misc kWarps: the warps that hold rounds,
// at least 1), else in contiguous ranges of about equal cost (shift_cost
// a round, the factored kernels' shift, and the arcs a lane).
__device__ __forceinline__ void plan_dest_rounds(const FactPtrs& p, int warps, const int* info,
                                                 int shift_cost) {
  // warp 0 packs a round a step: lane i weighs member m0 + i, which joins
  // where i + 1 lanes at the largest width up to it fit in 32 and its slot
  // is within kShiftGroups of the first's (both hold for a prefix of the
  // lanes); lane 0 then deals the rounds
  const int lane = threadIdx.x & 31;
  const int S_l = p.mem_ptr[p.misc[kNlab]];
  int R = 0, total = 0;
  for (int m0 = 0; m0 < S_l;) {
    const int m = m0 + lane;
    const int v = m < S_l ? info[m] : 0;
    const int j0 = __shfl_sync(kFull, v & 0x1fff, 0);
    // the largest width up to this lane: the levels some lane up to it
    // reaches (widths are 0..5)
    const int mine = (v >> 13) & 7;
    int lg = 0;
#pragma unroll
    for (int level = 1; level <= 5; ++level)
      lg += (__ballot_sync(kFull, mine >= level) & ((2u << lane) - 1u)) != 0;
    const bool fits = m < S_l && ((lane + 1) << lg) <= 32 && (v & 0x1fff) - j0 < kShiftGroups;
    const int k = __popc(__ballot_sync(kFull, fits));
    const int g_lg = __shfl_sync(kFull, lg, k - 1);
    const int most = __reduce_max_sync(kFull, lane < k ? v >> 16 : 0);
    const int cost = shift_cost + 3 * (((most + (1 << g_lg) - 1) >> g_lg) + 2);
    if (lane == 0) {
      p.rnd[2 * R] = m0 | ((m0 + k) << 16);
      p.rnd[2 * R + 1] = (1 << g_lg) | (cost << 8);
    }
    total += cost;
    ++R;
    m0 += k;
  }
  if (lane != 0) return;
  p.misc[kRounds] = R;
  if (warps <= 0) return;
  p.misc[kWarps] = max(1, min(warps, R));
  int cum = 0, w = 0;
  p.wbeg[0] = 0;
  for (int r = 0; r < R; ++r) {
    const int want = R <= warps ? r : (total > 0 ? cum * warps / total : 0);
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
// exp((x + wsel) - sh), without kLabels sum adj exp(x - sh)); on the
// dense route the arcs are the row itself.
template <bool kLabels = true>
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
    const float e = frame0 ? x[s] : exp_ftz((kLabels ? x[s] + wcol[s] : x[s]) - sh);
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

// Copy n floats to shared memory by cp.async, this thread's share of
// `threads` copying threads, `first` its rank among them; no commit.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, int first,
                                           int threads) {
  for (int i = first; i < n; i += threads)
    __pipeline_memcpy_async(dst + i, src + i, sizeof(float));
}

// The same 16 bytes a copy where dst and src are 16-byte aligned and n a
// multiple of 4 (else 4 bytes).
__device__ __forceinline__ void copy_async16(float* dst, const float* src, int n, int first,
                                             int threads) {
  if (((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) & 15) != 0 || (n & 3) != 0)
    return copy_async(dst, src, n, first, threads);
  for (int i = first; 4 * i < n; i += threads)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 4 * sizeof(float));
}

// The same by the whole block (with from_last the block's last threads
// first, as the factored chain's rounds are dealt to its first warps).
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n,
                                           bool from_last = false) {
  copy_async(dst, src, n, from_last ? blockDim.x - 1 - threadIdx.x : threadIdx.x, blockDim.x);
}

// Every ring row but the kRing - 2 latest committed has landed (this
// thread's copies).
__device__ __forceinline__ void wait_ring() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 2) : "memory");
}

// The same with one more row landed (the dense chain reads the next one).
__device__ __forceinline__ void wait_ring_ahead() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kRing - 3) : "memory");
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
      v = z >= kTiny ? em + logf(fmaxf(z, kFloor)) : kNeg;
    else
      v = em + (z >= kTiny ? sh + logf(fmaxf(z, kFloor)) : kNeg);
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
      const float e = f0 ? x[q.xs[k]] : exp_ftz((x[q.xs[k]] + q.wv[k]) - sh);
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
  compact_members(LabelIndex{lab_idx + static_cast<long>(b) * S}, S, N, p);
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
  if (threadIdx.x < 32) plan_dest_rounds(p, blockDim.x >> 5, info, 2 * ((S + 7) / 8) + 8);
  if (threadIdx.x == 0) {
    const int arena = smem_words - lay.arena;
    const int nnz = p.arc_ptr[S_l];
    const bool dense = 2L * nnz + static_cast<long>(kRing) * S > arena;
    const long arc_words = dense ? 0 : 2L * nnz;
    p.misc[kNnz] = nnz;
    p.misc[kStaged] = arc_words + static_cast<long>(t_live) * S <= arena;
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
// (t >= 1) and, for the labelled states, rz_t[u] = z >= FLT_MIN ? 1 / max(z,
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
  compact_members(LabelIndex{lab_idx + static_cast<long>(b) * S}, S, N, p);
  const int Lu = p.misc[kNlab];
  const int S_l = p.mem_ptr[Lu];
  dest_degrees<kFactStatsRows>(A, S, S_l, p, p.rnd);
  float* e0 = p.vec;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    e0[s] = start_e(start[static_cast<long>(b) * S + s]);
  __syncthreads();
  offsets(p.rnd, p.arc_ptr, S_l);
  __syncthreads();
  const bool dense = 2L * p.arc_ptr[S_l] > smem_words - lay.arena;
  const int* info = member_info(p, S_l, S, dense);
  __syncthreads();
  if (threadIdx.x < 32) plan_dest_rounds(p, 0, info, 2 * ((S + 7) / 8) + 8);
  __syncthreads();
  int2* arcs = reinterpret_cast<int2*>(p.arena);
  if (!dense) fill_dest_arcs<false, kFactStatsRows>(A, S, S_l, p, arcs);
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
        rz_t[tk.u] = z >= kTiny ? 1.0f / fmaxf(z, kFloor) : 0.0f;
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
  const float e = exp_ftz((ps + wt[j * S + s]) - shr[j]);
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

// g_{t-1}[s]: the source's group merges its lanes' sums by xor shuffles
// (times the source's factor `scale`, the dense chain's exp); returns it.
__device__ __forceinline__ float store_sum(int s, float sum, int g, int S, float* gnext,
                                           int lane, float scale = 1.0f) {
  for (int off = g >> 1; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  sum *= scale;
  if (s < S && (lane & (g - 1)) == 0) gnext[s] = sum;
  return sum;
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
  compact_members(LabelIndex{lab_idx + static_cast<long>(b) * S}, S, N, p);
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
// Both pairs': without kLabels (the dense one) there is no wsel
// (exp(traj[t-1, s] - sh_t)) and one shift a frame (L = 1, every slot 0).
template <bool kLabels>
__global__ void scan_dadj_kernel(const float* __restrict__ traj,
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
      const float w =
          kLabels ? wsel[(static_cast<long>(b) * S + s) * N + lab_idx[static_cast<long>(b) * S + u]]
                  : 0.0f;
      const float* tr_b = traj + static_cast<long>(b) * T * S;
      const float* dz_b = dz_s + static_cast<long>(b) * T * S;
      const float* sh_b = sh_s + static_cast<long>(b) * T * L;
      for (int t = t_live - 1; t >= 1; --t)
        acc += dz_b[static_cast<long>(t) * S + u] *
               exp_ftz((tr_b[static_cast<long>(t - 1) * S + s] + w) - sh_b[static_cast<long>(t) * L + j]);
      acc += dz_b[u] * start_e(start[static_cast<long>(b) * S + s]);
    }
    dadj[(static_cast<long>(b) * S + u) * S + s] = acc;
  }
}

// ---------------------------------------------------------------------------
// The plain dense recursion (dense_scan_fwd, dense_scan_bwd): the factored
// pair's design without the label factor, on the same prologue helpers.
// - Forward: one block of kFactWarps warps a sample runs the prologue:
//   compact_members with one label for every state with has_lab > 0 (the
//   members are the labelled states in increasing u; states without a
//   label take no lane and stay NEG), dest_degrees and fill_dest_arcs (each
//   member's real arcs, 8 bytes an arc), plan_dest_rounds (a member of
//   in-degree n a group of g lanes, g matched to n; a hub beyond 32 kCap
//   takes several arcs a lane).  The warps that hold rounds (misc kWarps:
//   3 at the STC headline, S=96) then run the frames and the others leave.
//   A frame: the shift is the largest of the previous frame's warp maxima
//   (one a lane, read after the barrier, and a redux; double-buffered like
//   alpha); each lane sums every one of its kCap arc slots (pads add +0)
//   of adj exp(alpha[s] - sh), an exp a source per arc, so no barrier
//   separates the exps from the sums; the group merges by xor
//   shuffles; its first lane stores the new alpha, (em + sh) + log z where
//   z >= FLT_MIN else NEG, to shared memory and, fire and forget, to traj; the
//   warp's maximum goes out by one redux; one named barrier among the frame
//   warps ends the frame.  Routes: registers (at most kDenseRegRounds
//   rounds a warp, each lane's arcs in its registers), shared (the arcs in
//   shared memory, any number of rounds a warp, hubs), global (the
//   members' dense rows read from global memory, where the arcs do not fit
//   in shared memory).  The emission rows are copied by cp.async, 16 bytes
//   a copy, before frame 0 where they fit beside the arcs, else through a
//   ring of kRing rows filled kRing - 1 frames ahead.
// - Backward, what does not depend on g apart from what does:
//   - dense_stats_kernel: each live frame's sh_t and rz_t[u] = z >= FLT_MIN ?
//     1 / max(z, 1e-37) : 0 (0 for states without a label), recomputed from
//     traj with the forward's arcs and rounds; grid B x chunks of one wave,
//     a warp a frame, no barrier in its loop; B T (S + 1) floats of scratch;
//   - dense_chain_kernel, that pass's programmatic dependent: one block a
//     sample with the arcs by source and one group of g lanes a source, g
//     matched to the largest out-degree; the arcs by source are the rows'
//     arcs (read as the forward reads them) sorted stably by source in
//     shared memory (transpose_arcs), or, where the two lists do not fit
//     there, the columns' (fill_source_arcs) in global memory; a frame is
//     one sparse product
//       g_{t-1}[s] = exp(traj[t-1, s] - sh_t) sum_{u in out(s)} adj dz[u]
//     (dz = g rz_t, one rounding more than g / max(z, 1e-37); formed
//     before adj multiplies it, since g can be denormal where dz is not),
//     with the factors from a ring row (traj[t-1], rz_t, sh_t) that a side warp
//     copies 16 bytes a lane kRing - 1 frames ahead, while each source's
//     first lane, from the next row's rz, also writes dem[t-1] = rz > 0 ?
//     g : 0 (and dz for dadj); g double-buffered, one named barrier a
//     frame; frozen frames are never visited (dem 0, g passed through),
//     frame 0 ends the chain;
//   - scan_dadj_kernel, only when dadj is asked for, from the saved dz.

constexpr int kDenseRegRounds = 2;  // rounds (source rounds) a warp may hold in registers
constexpr int kDenseRoundCost = 8;  // a round's fixed cost in the plan: the new alpha

// Words of the forward's vectors: alpha twice, e0, the warps' maxima twice.
__host__ __device__ inline int dense_fwd_vec(int S) { return 3 * S + 2 * kFactWarps; }

// Words of a chain ring row: traj[t - 1], rz_t, sh_t (a multiple of 4).
__host__ __device__ inline int dense_ring_row(int S) { return 2 * S + 4; }

// Words of shared memory the arcs take before the rows after them (16-byte
// aligned, for the rows' 16-byte copies).
__host__ __device__ inline long dense_arc_words(long nnz) { return (2 * nnz + 3) & ~3L; }

// One lane's share of a round held in registers: its destination u (-1:
// none), group width and (at most kCap) arcs (source, adj); arcs past the
// lane's weigh adj 0 at source 0, an exact +0.
struct DenseLane {
  int u, g;
  int xs[kCap];
  float av[kCap];
};

__device__ __forceinline__ void load_dense_lane(const FactPtrs& p, const int2* arcs, int r,
                                                int lane, int S, DenseLane& q) {
  const Task t = round_task(p, r, lane, S, false);
  q.u = t.u;
  q.g = t.g;
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    const bool ok = k < t.n;
    const int2 arc = ok ? arcs[t.a0 + k * t.g] : make_int2(0, 0);
    q.xs[k] = arc.x;
    q.av[k] = ok ? __int_as_float(arc.y) : 0.0f;
  }
}

// The new alpha of destination u (-1: none, NEG) from its group's merged
// z, stored by the group's first lane to next and traj (the log taken on
// every lane, so that none waits on another's branch).
__device__ __forceinline__ float dense_alpha(int u, int g, float z, float sh, float em,
                                             float* next, float* tr_t, int lane) {
  const float lz = logf(fmaxf(z, kFloor));
  const float v = u >= 0 && z >= kTiny ? (em + sh) + lz : kNeg;
  if (u >= 0 && (lane & (g - 1)) == 0) {
    tr_t[u] = v;
    next[u] = v;
  }
  return v;
}

// What the dense forward's frames read, after the prologue.
struct DenseFwdArgs {
  const float* A;
  const float* em_b;
  float* tr_b;
  const int2* arcs;
  float* rows;
  int S, frames, staged, warps;
  bool dense;
};

// The frames, by the first a.warps warps; kRegs: route registers.
template <bool kRegs>
__device__ __forceinline__ void dense_fwd_frames(const FactPtrs& p, const DenseFwdArgs& a) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = a.S, frames = a.frames, threads = 32 * a.warps;
  float* al0 = p.vec;  // frame t reads al0 (t odd: al1) and writes the other
  float* al1 = al0 + S;
  const float* e0 = al1 + S;
  float* mx0 = al1 + 2 * S;  // frame t writes its warps' maxima to mx0 (t odd: mx1)
  float* mx1 = mx0 + kFactWarps;
  const int rb = p.wbeg[warp], re = p.wbeg[warp + 1];
  DenseLane q[kDenseRegRounds];
  if (kRegs) {
#pragma unroll
    for (int i = 0; i < kDenseRegRounds; ++i)
      if (rb + i < re) load_dense_lane(p, a.arcs, rb + i, lane, S, q[i]);
  }
  if (!a.staged) {
    wait_ring();
    frame_sync(threads);  // row 0
  }

  for (int t = 0; t < frames; ++t) {
    const float* prev = (t & 1) ? al1 : al0;
    float* next = (t & 1) ? al0 : al1;
    const float* mprev = (t & 1) ? mx0 : mx1;
    float* mnext = (t & 1) ? mx1 : mx0;
    const float* em_row = a.rows + static_cast<long>(a.staged ? t : t % kRing) * S;
    float* tr_t = a.tr_b + static_cast<long>(t) * S;
    if (!a.staged) {
      // the slot of row t - 1, read in frame t - 1 before its barrier
      const int r = t + kRing - 1;
      if (r < frames)
        copy_async16(a.rows + static_cast<long>(r % kRing) * S,
                     a.em_b + static_cast<long>(r) * S, S, threadIdx.x, threads);
      __pipeline_commit();
    }
    const bool f0 = t == 0;
    const float* x = f0 ? e0 : prev;
    // the shift: the frame warps' maxima, a lane's each, and a redux
    const float sh = f0 ? 0.0f : warp_max(lane < a.warps ? mprev[lane] : kNeg);
    float wm = kNeg;
    if (kRegs) {
#pragma unroll
      for (int i = 0; i < kDenseRegRounds; ++i) {
        if (rb + i < re) {
          const DenseLane& l = q[i];
          const float em = l.u >= 0 ? em_row[l.u] : 0.0f;
          float z = 0.0f;
#pragma unroll
          for (int k = 0; k < kCap; ++k) {  // every slot, no branch (pads add +0)
            const float xs = x[l.xs[k]];
            z += l.av[k] * (f0 ? xs : exp_ftz(xs - sh));
          }
          for (int off = l.g >> 1; off > 0; off >>= 1) z += __shfl_xor_sync(kFull, z, off);
          wm = fmaxf(wm, dense_alpha(l.u, l.g, z, sh, em, next, tr_t, lane));
        }
      }
    } else {
      for (int r = rb; r < re; ++r) {
        const Task tk = round_task(p, r, lane, S, a.dense);
        const float em = tk.u >= 0 ? em_row[tk.u] : 0.0f;
        const float z = dest_sum<false>(tk, a.arcs, a.A, x, nullptr, sh, f0, S, a.dense);
        wm = fmaxf(wm, dense_alpha(tk.u, tk.g, z, sh, em, next, tr_t, lane));
      }
    }
    wm = warp_max(wm);
    if (lane == 0) mnext[warp] = wm;
    if (!a.staged) wait_ring();
    frame_sync(threads);  // next and the maxima complete, row t + 1 landed
  }
}

__global__ void __launch_bounds__(kFactThreads)
dense_scan_fwd_kernel(const float* __restrict__ em, const float* __restrict__ adj,
                      const float* __restrict__ start, const float* __restrict__ has_lab,
                      const int* __restrict__ lens, float* __restrict__ traj, int T, int S,
                      int smem_words) {
  extern __shared__ __align__(16) int fact_smem[];
  const FactSmem lay = fact_layout(S, 1, 1, dense_fwd_vec(S));
  const FactPtrs p = fact_ptrs(fact_smem, lay);
  const int b = blockIdx.x, warp = threadIdx.x >> 5;
  const float* A = adj + static_cast<long>(b) * S * S;
  compact_members(HasLabel{has_lab + static_cast<long>(b) * S}, S, 1, p);
  const int S_l = p.mem_ptr[p.misc[kNlab]];
  const int frames = live_steps(lens[b], T);
  dest_degrees(A, S, S_l, p, p.rnd);
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    p.vec[s] = kNeg;
    p.vec[S + s] = kNeg;
    p.vec[2 * S + s] = start_e(start[static_cast<long>(b) * S + s]);
  }
  __syncthreads();
  offsets(p.rnd, p.arc_ptr, S_l);
  __syncthreads();
  const int arena = smem_words - lay.arena;
  const int nnz = p.arc_ptr[S_l];
  const bool dense = dense_arc_words(nnz) + static_cast<long>(kRing) * S > arena;
  const int* info = member_info(p, S_l, S, dense);
  int wide = 0;  // a member past the registers' kCap arcs a lane
  for (int m = threadIdx.x; m < S_l; m += blockDim.x)
    wide |= p.arc_ptr[m + 1] - p.arc_ptr[m] > 32 * kCap;
  wide = __syncthreads_or(wide);
  if (threadIdx.x < 32) plan_dest_rounds(p, kFactWarps, info, kDenseRoundCost);
  if (threadIdx.x == 0) {
    p.misc[kStaged] = (dense ? 0L : dense_arc_words(nnz)) + static_cast<long>(frames) * S <= arena;
    int most = 0;
    for (int w = 0; w < kFactWarps; ++w) most = max(most, p.wbeg[w + 1] - p.wbeg[w]);
    p.misc[kRoute] = dense ? kRouteGlobal
                     : (most <= kDenseRegRounds && !wide) ? kRouteRegisters : kRouteShared;
  }
  __syncthreads();
  const int staged = p.misc[kStaged], warps = p.misc[kWarps];
  int2* arcs = reinterpret_cast<int2*>(p.arena);
  float* rows = reinterpret_cast<float*>(p.arena) + (dense ? 0 : dense_arc_words(nnz));
  const float* em_b = em + static_cast<long>(b) * T * S;
  // the emission rows: every live one (the whole block, waited for below),
  // else the ring's first kRing - 1 (the frame warps, which wait for them)
  if (staged) {
    copy_async16(rows, em_b, frames * S, threadIdx.x, blockDim.x);
    __pipeline_commit();
  } else if (warp < warps) {
    for (int r = 0; r < kRing - 1; ++r) {
      if (r < frames)
        copy_async16(rows + r * S, em_b + static_cast<long>(r) * S, S, threadIdx.x, 32 * warps);
      __pipeline_commit();
    }
  }
  if (!dense) fill_dest_arcs(A, S, S_l, p, arcs);
  if (staged) __pipeline_wait_prior(0);
  __syncthreads();  // the arcs and every staged row
  if (warp >= warps) return;

  float* tr_b = traj + static_cast<long>(b) * T * S;
  const DenseFwdArgs args{A, em_b, tr_b, arcs, rows, S, frames, staged, warps, dense};
  if (p.misc[kRoute] == kRouteRegisters)
    dense_fwd_frames<true>(p, args);
  else
    dense_fwd_frames<false>(p, args);
  __pipeline_wait_prior(0);
  // the frozen tail keeps alpha; states without a label are NEG on every
  // frame (a frame warp's thread a state)
  const float* last = (frames & 1) ? p.vec + S : p.vec;
  for (int s = threadIdx.x; s < S; s += 32 * warps) {
    const float v = last[s];
    for (int t = p.jslot[s] < 0 ? 0 : frames; t < T; ++t) tr_b[static_cast<long>(t) * S + s] = v;
  }
}

// The backward's statistics of each live frame, off the chain: sh_t (t >=
// 1) and rz_t[u] = z >= FLT_MIN ? 1 / max(z, 1e-37) : 0 (0 for the states without
// a label), from traj; grid (B, chunks), a warp a frame with its own row
// of the previous alpha in shared memory.
__global__ void __launch_bounds__(kFactThreads)
dense_stats_kernel(const float* __restrict__ traj, const float* __restrict__ adj,
                   const float* __restrict__ start, const float* __restrict__ has_lab,
                   const int* __restrict__ lens, float* __restrict__ sh_out,
                   float* __restrict__ rz_out, int T, int S, int smem_words,
                   int frames_per_chunk) {
  extern __shared__ __align__(16) int fact_smem[];
  const FactSmem lay = fact_layout(S, 1, 1, (1 + kFactWarps) * S);
  const FactPtrs p = fact_ptrs(fact_smem, lay);
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the chain may start its prologue now (it waits for this pass's results)
  asm volatile("griddepcontrol.launch_dependents;");
  const int frames = live_steps(lens[b], T);
  const int t0 = blockIdx.y * frames_per_chunk;
  const int t1 = min(t0 + frames_per_chunk, frames);
  if (t0 >= t1) return;
  const float* A = adj + static_cast<long>(b) * S * S;
  compact_members(HasLabel{has_lab + static_cast<long>(b) * S}, S, 1, p);
  const int S_l = p.mem_ptr[p.misc[kNlab]];
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
  if (threadIdx.x < 32) plan_dest_rounds(p, 0, info, kDenseRoundCost);
  __syncthreads();
  int2* arcs = reinterpret_cast<int2*>(p.arena);
  if (!dense) fill_dest_arcs(A, S, S_l, p, arcs);
  __syncthreads();

  const int R = p.misc[kRounds];
  float* row = p.vec + (1 + warp) * S;
  const float* tr_b = traj + static_cast<long>(b) * T * S;
  for (int t = t0 + warp; t < t1; t += kFactWarps) {
    float sh = 0.0f;
    if (t > 0) {
      const float* src = tr_b + static_cast<long>(t - 1) * S;
      float m = kNeg;
      for (int s = lane; s < S; s += 32) {
        const float v = src[s];
        row[s] = v;
        m = fmaxf(m, v);
      }
      sh = warp_max(m);
      if (lane == 0) sh_out[static_cast<long>(b) * T + t] = sh;
      __syncwarp();
    }
    const float* x = t > 0 ? row : e0;
    float* rz_t = rz_out + (static_cast<long>(b) * T + t) * S;
    for (int s = lane; s < S; s += 32)
      if (p.jslot[s] < 0) rz_t[s] = 0.0f;
    for (int r = 0; r < R; ++r) {
      const Task tk = round_task(p, r, lane, S, dense);
      const float z = dest_sum<false>(tk, arcs, A, x, nullptr, sh, t == 0, S, dense);
      if (tk.u >= 0 && (lane & (tk.g - 1)) == 0)
        rz_t[tk.u] = z >= kTiny ? 1.0f / fmaxf(z, kFloor) : 0.0f;
    }
    __syncwarp();  // the row is read before the next frame overwrites it
  }
}

// One lane's share of a source round held in registers: source s (S:
// none), arc count and (at most kCap) arcs (destination, adj); arcs past
// the lane's add an exact +0 (their dz is not taken).
struct DenseSrc {
  int s, n;
  int us[kCap];
  float av[kCap];
};

__device__ __forceinline__ void load_dense_src(const FactPtrs& p, const int2* arcs, int r,
                                               int lane, int S, int g, DenseSrc& q) {
  const SrcTask t = source_task(p, r, lane, S, g);
  q.s = t.s;
  q.n = t.n;
#pragma unroll
  for (int k = 0; k < kCap; ++k) {
    const bool ok = k < t.n;
    const int2 arc = ok ? arcs[t.a0 + k * g] : make_int2(0, 0);
    q.us[k] = arc.x & 0xffff;
    q.av[k] = ok ? __int_as_float(arc.y) : 0.0f;
  }
}

// The arcs by source from the rows' (tmp: s | m << 16, adj bits, in
// member order, nnz of them), into arcs at ptr (each source's arcs in
// member order: u | slot << 16, adj bits), with the out-degrees counted
// into cnt (S words, zero on entry) and their offsets in ptr: the counts
// by shared atomics (their sums do not depend on the order), then a
// stable placement by warp 0, 32 arcs a step in order, each lane's rank
// among the step's arcs of its source by __match_any_sync.
__device__ __forceinline__ void transpose_arcs(const FactPtrs& p, const int2* tmp, int nnz, int S,
                                               int* cnt, int* ptr, int2* arcs) {
  for (int k = threadIdx.x; k < nnz; k += blockDim.x) atomicAdd(&cnt[tmp[k].x & 0xffff], 1);
  __syncthreads();
  offsets(cnt, ptr, S);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    for (int s = lane; s < S; s += 32) cnt[s] = ptr[s];  // each source's next place
    __syncwarp();
    for (int k0 = 0; k0 < nnz; k0 += 32) {
      const int k = k0 + lane;
      const int2 arc = k < nnz ? tmp[k] : make_int2(-1, 0);
      const int s = k < nnz ? arc.x & 0xffff : -1;
      const unsigned same = __match_any_sync(kFull, s);
      if (k < nnz) {
        const int u = p.mem_idx[static_cast<unsigned>(arc.x) >> 16];
        arcs[cnt[s] + __popc(same & ((1u << lane) - 1u))] = make_int2(u | (p.jslot[u] << 16), arc.y);
      }
      __syncwarp();
      if (k < nnz && lane == 31 - __clz(same)) cnt[s] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();
}

// What the dense chain's frames read, after the prologue.
struct DenseChainArgs {
  const float* tr_b;
  const float* sh_b;
  const float* rz_b;
  float* dz_b;  // null without dadj
  float* dem_b;
  const int2* arcs;
  float* ring;
  int S, frames, g, rounds, warps;
};

// Start copying chain frame f's ring row (traj[t - 1], rz_t, sh_t) or
// nothing, this lane's share of the side warp's; one commit either way.
__device__ __forceinline__ void fetch_dense_row(const DenseChainArgs& c, int f, int lane) {
  if (f < c.frames - 1) {
    const int t = c.frames - 1 - f, S = c.S;
    float* dst = c.ring + static_cast<long>(f % kRing) * dense_ring_row(S);
    copy_async16(dst, c.tr_b + static_cast<long>(t - 1) * S, S, lane, 32);
    copy_async16(dst + S, c.rz_b + static_cast<long>(t) * S, S, lane, 32);
    copy_async(dst + 2 * S, c.sh_b + t, 1, lane, 32);
  }
  __pipeline_commit();
}

// The dem (and dz) of state s at frame t from its g there and the frame's
// rz.
__device__ __forceinline__ void dense_dem(const DenseChainArgs& c, int t, int s, float g,
                                          float rz) {
  const float ga = rz > 0.0f ? g : 0.0f;
  c.dem_b[static_cast<long>(t) * c.S + s] = ga;
  if (c.dz_b != nullptr) c.dz_b[static_cast<long>(t) * c.S + s] = ga * rz;
}

// The chain's frames t = frames - 1 .. 1, by c.warps warps of source
// rounds and the side warp after them, which copies the ring rows; a
// source's first lane also writes its dem (and dz) at t - 1 from the next
// row's rz, and dem at frames - 1 is written first; kRegs: route
// registers.
template <bool kRegs>
__device__ __forceinline__ void dense_chain_frames(const FactPtrs& p, const DenseChainArgs& c) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int S = c.S, g = c.g, threads = 32 * (c.warps + 1);
  const bool side = warp == c.warps;
  float* g0 = p.vec;  // chain frame f reads g0 (f odd: g1) and writes the other
  float* g1 = g0 + S;
  DenseSrc q[kDenseRegRounds];
  if (kRegs && !side) {
#pragma unroll
    for (int i = 0; i < kDenseRegRounds; ++i)
      if (warp + i * c.warps < c.rounds) load_dense_src(p, c.arcs, warp + i * c.warps, lane, S, g, q[i]);
  }
  if (side) wait_ring_ahead();
  frame_sync(threads);  // the first two ring rows
  const int nf = c.frames - 1;
  for (int u = threadIdx.x; u < S && nf > 0; u += threads)
    dense_dem(c, nf, u, g0[u], c.ring[S + u]);

  for (int f = 0; f < nf; ++f) {
    const int t = c.frames - 1 - f;
    const float* gcur = (f & 1) ? g1 : g0;
    float* gnext = (f & 1) ? g0 : g1;
    const float* prev = c.ring + static_cast<long>(f % kRing) * dense_ring_row(S);
    const float* rz = prev + S;
    const float sh = prev[2 * S];
    // rz at t - 1, where the first lanes write dem (frame 0's comes after)
    const float* rz_next = f + 1 < nf
        ? c.ring + static_cast<long>((f + 1) % kRing) * dense_ring_row(S) + S : nullptr;
    if (side) {
      // the slot of row f - 1, read in frame f - 1 before its barrier
      fetch_dense_row(c, f + kRing - 1, lane);
      wait_ring_ahead();
    } else if (kRegs) {
#pragma unroll
      for (int i = 0; i < kDenseRegRounds; ++i) {
        if (warp + i * c.warps < c.rounds) {
          const DenseSrc& l = q[i];
          const float e = l.s < S ? exp_ftz(prev[l.s] - sh) : 0.0f;
          float sum = 0.0f;
#pragma unroll
          for (int k = 0; k < kCap; ++k) {
            if (k < 2 || k < l.n) {  // the first two always, so they overlap (pads add +0)
              const float dz = gcur[l.us[k]] * rz[l.us[k]];
              sum += l.av[k] * (k < l.n ? dz : 0.0f);
            }
          }
          const float gn = store_sum(l.s, sum, g, S, gnext, lane, e);
          if (rz_next != nullptr && l.s < S && (lane & (g - 1)) == 0)
            dense_dem(c, t - 1, l.s, gn, rz_next[l.s]);
        }
      }
    } else {
      for (int r = warp; r < c.rounds; r += c.warps) {
        const SrcTask st = source_task(p, r, lane, S, g);
        const float e = st.s < S ? exp_ftz(prev[st.s] - sh) : 0.0f;
        float sum = 0.0f;
        for (int k = 0; k < st.n; ++k) {
          const int2 arc = c.arcs[st.a0 + k * g];
          const int u = arc.x & 0xffff;
          sum += __int_as_float(arc.y) * (gcur[u] * rz[u]);
        }
        const float gn = store_sum(st.s, sum, g, S, gnext, lane, e);
        if (rz_next != nullptr && st.s < S && (lane & (g - 1)) == 0)
          dense_dem(c, t - 1, st.s, gn, rz_next[st.s]);
      }
    }
    frame_sync(threads);  // gnext complete, the next ring rows landed
  }
}

__global__ void __launch_bounds__(kFactThreads)
dense_chain_kernel(const float* __restrict__ traj, const float* __restrict__ adj,
                   const float* __restrict__ has_lab, const int* __restrict__ lens,
                   const float* __restrict__ g_final, const float* __restrict__ sh_s,
                   const float* __restrict__ rz_s, float* __restrict__ dz_s,
                   int* __restrict__ jslot_s, float* __restrict__ dem,
                   int* __restrict__ arcs_g, int T, int S, int smem_words) {
  extern __shared__ __align__(16) int fact_smem[];
  const FactSmem lay = fact_layout(S, 1, 1, 2 * S);
  const FactPtrs p = fact_ptrs(fact_smem, lay);
  const int b = blockIdx.x, warp = threadIdx.x >> 5;
  const float* A = adj + static_cast<long>(b) * S * S;
  compact_members(HasLabel{has_lab + static_cast<long>(b) * S}, S, 1, p);
  const int S_l = p.mem_ptr[p.misc[kNlab]];
  const int frames = live_steps(lens[b], T);
  const int arena = smem_words - lay.arena;
  const long ring_words = static_cast<long>(kRing) * dense_ring_row(S);
  // the rows' arcs where both lists fit in shared memory (the rows' beyond
  // where the sources' go, over the ring, which is filled after), else the
  // columns' in global memory
  dest_degrees(A, S, S_l, p, p.rnd);
  __syncthreads();
  offsets(p.rnd, p.arc_ptr, S_l);
  __syncthreads();
  const int nnz = p.arc_ptr[S_l];
  const bool global = 4L * nnz > arena || dense_arc_words(nnz) + ring_words > arena;
  int2* arcs = global ? reinterpret_cast<int2*>(arcs_g + 2L * b * S * S)
                      : reinterpret_cast<int2*>(p.arena);
  if (!global) {
    int2* tmp = reinterpret_cast<int2*>(p.arena) + nnz;
    fill_dest_arcs<true>(A, S, S_l, p, tmp);
    for (int s = threadIdx.x; s < S; s += blockDim.x) p.rnd[s] = 0;
    __syncthreads();
    transpose_arcs(p, tmp, nnz, S, p.rnd, p.arc_ptr, arcs);
  } else {
    source_degrees(A, S, S_l, p, p.rnd);
    __syncthreads();
    offsets(p.rnd, p.arc_ptr, S);
    __syncthreads();
    fill_source_arcs(A, S, S_l, p, arcs);
  }
  int most = 0;
  for (int s = threadIdx.x; s < S; s += blockDim.x) most = max(most, p.arc_ptr[s + 1] - p.arc_ptr[s]);
  most = __reduce_max_sync(kFull, most);
  if (threadIdx.x == 0) p.misc[kGroup] = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicMax(&p.misc[kGroup], most);
  __syncthreads();
  const int maxdeg = p.misc[kGroup];
  const int g = group_width(maxdeg);
  const int rounds = (S * g + 31) / 32;
  const int warps = min(rounds, kFactWarps - 1);  // and the side warp
  const int route = global ? kRouteGlobal
                    : ((rounds + warps - 1) / warps <= kDenseRegRounds && maxdeg <= g * kCap)
                        ? kRouteRegisters : kRouteShared;
  float* ring = reinterpret_cast<float*>(p.arena) + (global ? 0 : dense_arc_words(nnz));
  const long base = static_cast<long>(b) * T * S;
  const DenseChainArgs c{traj + base, sh_s + static_cast<long>(b) * T, rz_s + base,
                         dz_s ? dz_s + base : nullptr, dem + base, arcs, ring, S, frames,
                         g, rounds, warps};
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    p.vec[s] = g_final[static_cast<long>(b) * S + s];
    jslot_s[static_cast<long>(b) * S + s] = p.jslot[s];
  }
  for (long i = static_cast<long>(frames) * S + threadIdx.x; i < static_cast<long>(T) * S;
       i += blockDim.x)
    c.dem_b[i] = 0.0f;  // the frozen frames
  // the statistics pass's results: the launch lets this block's prologue
  // overlap that pass (programmatic dependent launch); wait for it here
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (warp == warps)
    for (int r = 0; r < kRing - 1; ++r) fetch_dense_row(c, r, threadIdx.x & 31);
  __syncthreads();  // the arcs and g; the rows' arcs are dead
  if (warp > warps) return;

  if (route == kRouteRegisters)
    dense_chain_frames<true>(p, c);
  else
    dense_chain_frames<false>(p, c);
  __pipeline_wait_prior(0);

  // frame 0, entered from the start potentials
  const float* gfin = ((frames - 1) & 1) ? p.vec + S : p.vec;
  for (int u = threadIdx.x; u < S; u += 32 * (warps + 1)) dense_dem(c, 0, u, gfin[u], c.rz_b[u]);
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

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// A statistics pass's grid (B x chunks) and shared memory: its arcs in
// shared memory up to 72 KB a block (else its dense rows from global
// memory), so that three blocks share an SM, and as many frame chunks a
// sample as the card holds at once, `per` frames each.
struct StatsGrid {
  int smem, chunks, per;
};

template <typename Kernel>
cudaError_t stats_grid(Kernel kernel, int arena, int S, int words, int B, int T,
                       StatsGrid* grid) {
  long want = arena + 2L * S * S;
  const long cap = arena + 2048 > 18432 ? arena + 2048 : 18432;
  want = want < cap ? want : cap;
  grid->smem = static_cast<int>((want < words ? want : words) * 4);
  cudaError_t err = allow_smem(kernel, grid->smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFactThreads, grid->smem);
  int chunks = sms * (per_sm < 1 ? 1 : per_sm) / B;
  chunks = chunks < 1 ? 1 : (chunks > T ? T : chunks);
  grid->per = (T + chunks - 1) / chunks;
  grid->chunks = (T + grid->per - 1) / grid->per;
  return cudaSuccess;
}

template <typename T>
struct Same {
  using type = T;
};

// Launch a chain kernel on B blocks of kFactThreads with max_smem bytes as
// the programmatic dependent of the launch before it on st (its statistics
// pass): its prologue, which reads none of that pass's results, overlaps
// the pass.
template <typename... Params>
cudaError_t launch_dependent(void (*kernel)(Params...), int B, int max_smem, cudaStream_t st,
                             typename Same<Params>::type... args) {
  cudaError_t err = allow_smem(kernel, max_smem);
  if (err != cudaSuccess) return err;
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
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

// The dadj pass (scan_dadj_kernel): grid (B, row blocks) of at most 1,024
// threads, a thread an entry.
cudaError_t launch_dadj(const float* traj, const float* wsel, const int* lab_idx,
                        const float* start, const int* lens, const int* jslot_s,
                        const float* sh_s, const float* dz_s, float* dadj, int B, int T,
                        int S, int N, int L, cudaStream_t st) {
  const int rows = S >= 1024 ? 1 : 1024 / S;
  int threads = rows * S < 1024 ? rows * S : 1024;
  threads = (threads + 31) / 32 * 32;
  const dim3 grid(B, (S + rows - 1) / rows);
  if (wsel != nullptr)
    scan_dadj_kernel<true><<<grid, threads, 0, st>>>(traj, wsel, lab_idx, start, lens, jslot_s,
                                                     sh_s, dz_s, dadj, T, S, N, L, rows);
  else
    scan_dadj_kernel<false><<<grid, threads, 0, st>>>(traj, wsel, lab_idx, start, lens, jslot_s,
                                                      sh_s, dz_s, dadj, T, S, N, L, rows);
  return cudaGetLastError();
}

// The word offset of the global arcs in a backward's scratch: even, so
// that they load as int2.
long arcs_offset(long words) { return (words + 1) & ~1L; }

}  // namespace

extern "C" {

// em [B, T, S], adj [B, S, S], start/has_lab [B, S] f32, lens [B] i32 ->
// traj [B, T, S] f32.  One block of kFactThreads a sample, with max_smem
// bytes of shared memory: the plan and the vectors, then the arcs and the
// emission rows as they fit.
int dense_scan_fwd(const float* em, const float* adj, const float* start,
                   const float* has_lab, const int* lens, float* traj, int B, int T,
                   int S, int max_smem, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  const int words = max_smem / 4;
  if (S >= 65536 || fact_layout(S, 1, 1, dense_fwd_vec(S)).arena + kRing * S > words)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(dense_scan_fwd_kernel, max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_scan_fwd_kernel<<<B, kFactThreads, max_smem, static_cast<cudaStream_t>(stream)>>>(
      em, adj, start, has_lab, lens, traj, T, S, words);
  return static_cast<int>(cudaGetLastError());
}

// traj [B, T, S], adj [B, S, S], start/has_lab/g_final [B, S] f32, lens
// [B] i32 -> dem [B, T, S] and, unless dadj is null, dadj [B, S, S] f32;
// scratch holds sh [B, T], rz [B, T, S], the slots [B, S] (int32), with
// dadj dz [B, T, S], and, where a dense adjacency's arcs (twice, to sort
// them by source) could not fit in shared memory beside the chain's ring,
// 2 S^2 words a sample from an even offset (ops/dense_scan_pallas.py
// _dense_scratch_words).  Two launches
// (statistics, chain), a third for dadj.
int dense_scan_bwd(const float* traj, const float* adj, const float* start,
                   const float* has_lab, const int* lens, const float* g_final,
                   float* dem, float* dadj, float* scratch, int B, int T, int S,
                   int max_smem, void* stream) {
  if (B == 0 || T == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int words = max_smem / 4;
  const FactSmem stats = fact_layout(S, 1, 1, (1 + kFactWarps) * S);
  const FactSmem chain = fact_layout(S, 1, 1, 2 * S);
  if (S >= 65536 || stats.arena > words || chain.arena + kRing * dense_ring_row(S) > words)
    return static_cast<int>(cudaErrorInvalidValue);
  const long BT = static_cast<long>(B) * T;
  float* sh_s = scratch;
  float* rz_s = sh_s + BT;
  int* jslot_s = reinterpret_cast<int*>(rz_s + BT * S);
  float* dz_s = reinterpret_cast<float*>(jslot_s + static_cast<long>(B) * S);
  int* arcs_g = reinterpret_cast<int*>(
      scratch + arcs_offset(BT * (S + 1) + static_cast<long>(B) * S + (dadj ? BT * S : 0)));

  StatsGrid grid;
  cudaError_t err = stats_grid(dense_stats_kernel, stats.arena, S, words, B, T, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_stats_kernel<<<dim3(B, grid.chunks), kFactThreads, grid.smem, st>>>(
      traj, adj, start, has_lab, lens, sh_s, rz_s, T, S, grid.smem / 4, grid.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(dense_chain_kernel, B, max_smem, st, traj, adj, has_lab, lens, g_final,
                         sh_s, rz_s, dadj ? dz_s : nullptr, jslot_s, dem, arcs_g, T, S, words);
  if (err != cudaSuccess || dadj == nullptr) return static_cast<int>(err);
  return static_cast<int>(launch_dadj(traj, nullptr, nullptr, start, lens, jslot_s, sh_s, dz_s,
                                      dadj, B, T, S, 1, 1, st));
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
// sample from an even offset (ops/dense_scan_pallas.py
// _bwd_scratch_words).  Two launches (statistics, chain), a third for
// dadj.
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
  const long BT = static_cast<long>(B) * T;
  int* arcs_g = reinterpret_cast<int*>(
      scratch + arcs_offset(BT * (L + S) + static_cast<long>(B) * S + (dadj ? BT * S : 0)));

  StatsGrid grid;
  cudaError_t err = stats_grid(factored_stats_kernel, stats.arena, S, words, B, T, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  factored_stats_kernel<<<dim3(B, grid.chunks), kFactThreads, grid.smem, st>>>(
      traj, adj, wsel, lab_idx, start, lens, sh_s, z_s, T, S, N, L, grid.smem / 4, grid.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_dependent(factored_chain_kernel, B, max_smem, st, traj, adj, wsel, lab_idx, lens,
                         g_final, sh_s, z_s, dadj ? dz_s : nullptr, jslot_s, dem, dwsel, dws,
                         arcs_g, T, S, N, L, words);
  if (err != cudaSuccess || dadj == nullptr) return static_cast<int>(err);
  return static_cast<int>(launch_dadj(traj, wsel, lab_idx, start, lens, jslot_s, sh_s, dz_s,
                                      dadj, B, T, S, N, L, st));
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
