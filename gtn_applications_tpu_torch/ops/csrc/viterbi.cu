// Dense Viterbi backtrace: walk prev-state backpointers to a path.
//
// Replaces gtn_applications_tpu/ops/viterbi_scan_pallas.py: _dense_bt_kernel
// (:239), wrapped there by dense_backtrace (:268).
//
// bp [B, T-1, C] int32 (sample-major: one sample's table is contiguous),
// last [B] int32 -> path [B, T] int32:
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
