// Emission gather for the lattice criteria, forward and backward.
//
// Replaces gtn_applications_tpu/ops/gathers.py: _gather_fwd_kernel (:30)
// and _gather_bwd_kernel (:44), wrapped there by gather_channels_mxu.
//
//   fwd: out[b, t, s] = x[b, t, idx[b, s]], 0 where idx[b, s] is -1
//   bwd: dx[b, t, c]  = sum over s with idx[b, s] == c of g[b, t, s]
//
// The TPU kernels build a one-hot matrix in VMEM and contract it on the MXU,
// a workaround for XLA's scalar-loop gather lowering.  On Hopper the gather
// is a plain indexed load and the transpose a sum by label, so neither does
// any arithmetic worth a tensor core: both are bound by device-memory bytes
// (x and out once each, about 5.4 MB at B=32, T=250, C=80, S=89), and at
// that size by the launch (launch_probe below: an empty kernel).
//
// Design:
//  * fwd: one thread per output element over the flat [B*T*S] output, so
//    consecutive threads store consecutive addresses and no thread idles at
//    a row's end; the x rows of C floats that a block reads from are tiny
//    and stay in L1.  The CTC pair does not call it: ctc.cu reads its
//    emissions from the log-probabilities by label.  ASG's force-aligned
//    score and the sparse tier's Viterbi oracle do.
//  * bwd: a deterministic reduction by label, no atomics.  One block for
//    each (sample, tile of F frames), F <= 32 (bwd_plan; ops/gathers.py
//    gather_bwd_plan mirrors it).  The sample's labels are copied first,
//    then the tile's g rows (one contiguous run of F S floats) by cp.async,
//    16 bytes where aligned with 4-byte heads and tails at the global
//    offset mod 4; while the rows land, the block builds the sample's plan
//    in shared memory: the states sorted by channel, stable in s (order
//    [S]; first [C + 1], channel c's states order[first[c]:first[c + 1]]).
//    Up to 8 warps rank the states, each a run of 32-state chunks:
//    __match_any_sync finds a chunk's states of one channel, the lanes
//    below a state's in that set and the warp's count so far give its
//    rank, the set's lowest lane adds the set to the count (the warps'
//    counts sit in the dx tile while it is free); the counts' scan gives
//    first, and each warp places its states.  Then a warp takes a channel
//    at a time, lane r frame t0 + r, and sums the channel's states in
//    ascending s from the staged rows (eight loads ahead of their adds):
//    every lane of the warp makes the same adds, and dx[t, c] is the same
//    bit for bit on every run.  An odd S puts the lanes' rows on distinct
//    banks; an even S shares banks.  The sums go to a shared dx tile (rows
//    of C | 1 floats, odd, so the lanes' rows fall on distinct banks)
//    stored coalesced: the tile's dx rows are one contiguous run.  A
//    channel with no state gets exact zeros.  Route "global", where not
//    one frame's g row and dx row fit beside the plan: the lanes read g
//    and write dx in global memory directly.
//  * An index outside [0, C) is treated as padding (no load, no add), so a
//    bad index cannot touch memory out of bounds; the Python wrapper can
//    check the indices on request.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kTileFrames = 32;      // a warp's lanes, one frame each
constexpr long kSmemBudget = 232448;  // shared memory a block can use on Hopper

__global__ void gather_fwd_kernel(const float* __restrict__ x,
                                  const int* __restrict__ idx,
                                  float* __restrict__ out,
                                  long n, int T, int C, int S) {
  const long i = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long row = i / S;  // b * T + t
  const int s = static_cast<int>(i - row * S);
  const long b = row / T;
  const int c = idx[b * S + s];
  out[i] = (c >= 0 && c < C) ? x[row * C + c] : 0.0f;
}

// The backward's layout at S states and C channels: the plan (labels, ranks
// and order of S ints each, first of C + 1), then on route "staged" a tile
// of `frames` g rows (frames S + 4 floats: a run starts at its global
// offset mod 4) and of as many dx rows of C | 1 floats, the most frames up
// to kTileFrames that fit in kSmemBudget; route "global" (staged false)
// where not one does: kTileFrames frames, the plan alone in shared memory.
// rank_warps: the warps that rank the states, each a run of 32-state
// chunks, their counts by channel in the dx tile while it is free (as many
// as its C | 1 rows of frames hold counts of C, at most all the block's and
// one a chunk; one on route "global").
struct BwdPlan {
  bool staged;
  int frames, rank_warps;
  long smem;
};

BwdPlan bwd_plan(int S, int C) {
  const long plan = (3L * S + C + 1) * 4;
  const long cp = C | 1;
  const long fit = (kSmemBudget - plan - 16) / ((S + cp) * 4);
  if (fit < 1) return {false, kTileFrames, 1, plan};
  const long f = fit < kTileFrames ? fit : kTileFrames;
  long w = C > 0 ? f * cp / C : 1;
  const long chunks = (S + 31) / 32;
  w = w < kThreads / 32 ? w : kThreads / 32;
  w = w < chunks ? w : chunks;
  return {true, static_cast<int>(f), static_cast<int>(w < 1 ? 1 : w),
          plan + (f * S + 4 + f * cp) * 4};
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
gather_bwd_kernel(const float* __restrict__ g, const int* __restrict__ idx,
                  float* __restrict__ dx, int T, int C, int S, int F, int Wr, int tiles) {
  extern __shared__ __align__(16) float smem[];
  const int cp = C | 1;
  float* gs = smem;                                  // [F S + 4] (staged)
  float* dxs = smem + (kStaged ? F * S + 4 : 0);     // [F][cp]  (staged)
  int* lab = reinterpret_cast<int*>(dxs + (kStaged ? F * cp : 0));  // [S]
  int* rank = lab + S;                               // [S]
  int* order = rank + S;                             // [S]
  int* first = order + S;                            // [C + 1]
  // the rank warps' counts [Wr][C]: in the dx tile (Wr > 1), else first
  int* cnt = Wr > 1 ? reinterpret_cast<int*>(dxs) : first;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = blockDim.x, W = n >> 5;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * F;
  const int nf = min(F, T - t0);
  const float* g_t = g + (static_cast<long>(b) * T + t0) * S;  // the tile's rows
  // the run's offset mod 4 in 4-byte words: its place in gs keeps it, so
  // that the 16-byte copies are aligned on both sides
  const int ph = static_cast<int>((reinterpret_cast<uintptr_t>(g_t) >> 2) & 3);

  // the sample's labels, copied ahead of the tile's rows (two commit groups)
  const int* idx_b = idx + static_cast<long>(b) * S;
  for (int s = tid; s < S; s += n) __pipeline_memcpy_async(lab + s, idx_b + s, 4);
  __pipeline_commit();
  if constexpr (kStaged) {
    const long m = static_cast<long>(nf) * S;
    const long head = ((4 - ph) & 3) < m ? ((4 - ph) & 3) : m;
    const long body = (m - head) >> 2;
    float* dst = gs + ph;
    for (long i = tid; i < head; i += n) __pipeline_memcpy_async(dst + i, g_t + i, 4);
    for (long i = tid; i < body; i += n)
      __pipeline_memcpy_async(dst + head + 4 * i, g_t + head + 4 * i, 16);
    for (long i = head + 4 * body + tid; i < m; i += n)
      __pipeline_memcpy_async(dst + i, g_t + i, 4);
  }
  __pipeline_commit();
  for (int i = tid; i < Wr * C; i += n) cnt[i] = 0;
  __pipeline_wait_prior(1);  // this thread's labels
  for (int s = tid; s < S; s += n) {
    const int c = lab[s];
    lab[s] = (c >= 0 && c < C) ? c : -1;  // outside [0, C): dropped
  }
  __syncthreads();

  // warp w < Wr ranks the states of its run of 32-state chunks among its
  // run's states of their channel (ascending s): __match_any_sync finds a
  // chunk's states of one channel, the set's lowest lane adds the set to
  // the warp's count
  const int chunks = (S + 31) / 32;
  const int k0 = warp * chunks / Wr, k1 = (warp + 1) * chunks / Wr;
  int* cnt_w = cnt + warp * C;
  if (warp < Wr) {
    for (int k = k0; k < k1; ++k) {
      const int s = 32 * k + lane;
      const int c = s < S ? lab[s] : -1;
      const unsigned same = __match_any_sync(0xffffffffu, c);
      const int below = __popc(same & ((1u << lane) - 1u));
      const int base = c >= 0 ? cnt_w[c] : 0;
      __syncwarp();
      if (c >= 0) {
        rank[s] = base + below;
        if (below == 0) cnt_w[c] = base + __popc(same);
      }
      __syncwarp();
    }
  }
  __syncthreads();
  if (Wr > 1) {
    // channel c's count, and each warp's count its offset among them
    for (int c = tid; c < C; c += n) {
      int run = 0;
      for (int w = 0; w < Wr; ++w) {
        const int v = cnt[w * C + c];
        cnt[w * C + c] = run;
        run += v;
      }
      first[c] = run;
    }
    __syncthreads();
  }
  if (warp == 0) {
    // first[c]: the states of channels below c (an exclusive scan; lane l
    // sums a run of ceil(C / 32) channels, a shuffle scan the runs)
    const int per = (C + 31) / 32;
    const int c0 = min(lane * per, C), c1 = min(c0 + per, C);
    int sum = 0;
    for (int c = c0; c < c1; ++c) sum += first[c];
    int x = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    int run = x - sum;
    for (int c = c0; c < c1; ++c) {
      const int v = first[c];
      first[c] = run;
      run += v;
    }
    if (lane == 31) first[C] = x;
  }
  __syncthreads();
  if (warp < Wr) {
    for (int s = 32 * k0 + lane; s < min(32 * k1, S); s += 32) {
      const int c = lab[s];
      if (c >= 0) order[first[c] + (Wr > 1 ? cnt_w[c] : 0) + rank[s]] = s;
    }
  }
  if constexpr (kStaged) __pipeline_wait_prior(0);
  __syncthreads();

  // lane r sums frame t0 + r (lanes past the tile's frames read frame 0 and
  // store nothing), a warp a channel at a time, in ascending s: eight
  // states' loads issued before their adds while eight remain, then one
  // at a time
  const int r = lane < nf ? lane : 0;
  const float* row = kStaged ? gs + ph + r * S : g_t + static_cast<long>(r) * S;
  float* dx_t = dx + (static_cast<long>(b) * T + t0) * C;
  for (int c = warp; c < C; c += W) {
    const int i1 = first[c + 1];
    float acc = 0.0f;
    int i = first[c];
    for (; i + 8 <= i1; i += 8) {
      float v[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = row[order[i + k]];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc += v[k];
    }
    for (; i < i1; ++i) acc += row[order[i]];
    if (lane < nf) {
      if constexpr (kStaged)
        dxs[lane * cp + c] = acc;
      else
        dx_t[static_cast<long>(lane) * C + c] = acc;
    }
  }
  if constexpr (kStaged) {
    __syncthreads();
    // the tile's dx rows, one contiguous run, a warp a row
    for (int rr = warp; rr < nf; rr += W)
      for (int c = lane; c < C; c += 32) dx_t[rr * C + c] = dxs[rr * cp + c];
  }
}

// An empty kernel: its time under the smoke's timing is the launch floor.
__global__ void launch_probe_kernel() {}

}  // namespace

extern "C" {

// x [B, T, C] f32, idx [B, S] i32, out [B, T, S] f32; all contiguous.
int gather_channels_fwd(const float* x, const int* idx, float* out,
                        int B, int T, int C, int S, void* stream) {
  const long n = static_cast<long>(B) * T * S;
  if (n == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
  gather_fwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, idx, out, n, T, C, S);
  return static_cast<int>(cudaGetLastError());
}

// g [B, T, S] f32, idx [B, S] i32, dx [B, T, C] f32; all contiguous.  One
// launch of B ceil(T / F) blocks (bwd_plan); the plan's S, C must fit in
// shared memory (the wrapper checks, with gather_bwd_plan).
int gather_channels_bwd(const float* g, const int* idx, float* dx,
                        int B, int T, int C, int S, void* stream) {
  if (static_cast<long>(B) * T == 0 || C == 0) return 0;
  const BwdPlan plan = bwd_plan(S, C);
  if (plan.smem > kSmemBudget) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = plan.staged ? gather_bwd_kernel<true> : gather_bwd_kernel<false>;
  if (plan.smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(plan.smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (T + plan.frames - 1) / plan.frames;
  kernel<<<static_cast<unsigned>(static_cast<long>(B) * tiles), kThreads,
           static_cast<size_t>(plan.smem), static_cast<cudaStream_t>(stream)>>>(
      g, idx, dx, T, C, S, plan.frames, plan.rank_warps, tiles);
  return static_cast<int>(cudaGetLastError());
}

// The backward's layout at S states and C channels (host only, no launch):
// out[0] 1 for route "staged", 0 for "global"; out[1] frames a tile; out[2]
// rank warps; out[3] shared bytes a block.
int gather_bwd_layout(int* out, int S, int C, void* stream) {
  (void)stream;
  const BwdPlan plan = bwd_plan(S, C);
  out[0] = plan.staged ? 1 : 0;
  out[1] = plan.frames;
  out[2] = plan.rank_warps;
  out[3] = static_cast<int>(plan.smem);
  return 0;
}

// One empty block of 32 threads.
int launch_probe(void* stream) {
  launch_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
