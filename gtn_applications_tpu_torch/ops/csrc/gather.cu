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
// is a plain indexed load and the transpose a scatter-add, so neither does
// any arithmetic worth a tensor core: both are bound by device-memory bytes
// (x and out once each, about 5.4 MB at B=32, T=250, C=80, S=89).
//
// Design:
//  * fwd: one thread per output element over the flat [B*T*S] output, so
//    consecutive threads store consecutive addresses and no thread idles at
//    a row's end; the x rows of C floats that a block reads from are tiny
//    and stay in L1.
//  * bwd: one block per (b, t) row, with as many threads as the row's
//    longer side (S or C) needs, up to 256.  Duplicate indices are the
//    normal case (every even CTC state maps to the blank), so the row is
//    accumulated in a shared-memory array of C floats with shared-memory
//    atomics, then stored once, coalesced.  The order of the atomics varies from run to
//    run, so dx is nondeterministic in the last bits.
//  * An index outside [0, C) is treated as padding (no load, no add), so a
//    bad index cannot touch memory out of bounds; the Python wrapper can
//    check the indices on request.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

__global__ void gather_bwd_kernel(const float* __restrict__ g,
                                  const int* __restrict__ idx,
                                  float* __restrict__ dx,
                                  int T, int C, int S) {
  extern __shared__ float acc[];
  const long row = blockIdx.x;  // b * T + t
  const int b = static_cast<int>(row / T);
  for (int c = threadIdx.x; c < C; c += blockDim.x) acc[c] = 0.0f;
  __syncthreads();
  const int* idx_b = idx + static_cast<long>(b) * S;
  const float* g_row = g + row * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int c = idx_b[s];
    if (c >= 0 && c < C) atomicAdd(&acc[c], g_row[s]);
  }
  __syncthreads();
  float* dx_row = dx + row * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) dx_row[c] = acc[c];
}

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

// g [B, T, S] f32, idx [B, S] i32, dx [B, T, C] f32; all contiguous.
// Needs C * 4 bytes of shared memory per block (the wrapper checks the
// 227 KB limit).
int gather_channels_bwd(const float* g, const int* idx, float* dx,
                        int B, int T, int C, int S, void* stream) {
  if (static_cast<long>(B) * T == 0 || C == 0) return 0;
  const size_t smem = static_cast<size_t>(C) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gather_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int need = ((S > C ? S : C) + 31) / 32 * 32;
  const int threads = need < kThreads ? need : kThreads;
  gather_bwd_kernel<<<static_cast<unsigned>(static_cast<long>(B) * T),
                      threads, smem, static_cast<cudaStream_t>(stream)>>>(
      g, idx, dx, T, C, S);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
