// Banded separable Gaussian blur with the reflect boundary, for sm_90a.
//
// Replaces the TPU kernel pixelssl_tpu/ops/blur_pallas.py::_blur_kernel
// (launched by gaussian_blur_fused, pl.pallas_call at blur_pallas.py:74),
// which computes out[n] = Bh @ X[n] @ Bw^T with dense banded matrices built
// by _blur_matrix. Here the band is indexed directly: row i of Bh holds the
// k taps g[t] at columns reflect(i - k/2 + t), so
//
//   out[n, i, j] = sum_t g[t] * V[n, i, reflect(j - k/2 + t)]
//   V[n, i, c]   = sum_t g[t] * X[n, reflect(i - k/2 + t), c]
//
// with the boundary of jnp.pad(mode='reflect'): the edge is not repeated
// (-1 -> 1, size -> size-2), applied again until the index is inside the
// map, as the while loop of _blur_matrix does when k/2 >= size.
//
// Bound on the H100: each map is read once and written once (2*N*H*W*4
// bytes) and the band form does 2*N*H*W*2k flops; at the GCT shapes
// ([8,321,321] k=21, [4,321,321] k=41/81) both bounds are one or two
// microseconds, under a launch's overhead. A 321x321 fp32 map (412 KB)
// does not fit one block's 227 KB of shared memory as it did in VMEM, so
// the design tiles the output instead: one block per 32x32 output tile of
// one map; a vertical pass reads the input rows through reflected row
// offsets (kept in shared memory) into a shared TILE x (TILE + 2*half)
// strip of V, then a horizontal pass reads the strip. The time goes to load
// instructions, not to bytes: each thread computes 4 consecutive rows, so
// one load (or one tap) feeds 4 multiply-adds. fp32 accumulation, no dense
// matrix, no tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;          // output tile is kTile x kTile
constexpr int kRowsPerIt = 8;      // blockDim.y
constexpr int kRowsPerThread = kTile / kRowsPerIt;
constexpr int kMaxHalf = 64;   // kernel_size <= 129
constexpr int kMaxTaps = 2 * kMaxHalf + 1;
constexpr int kStrip = kTile + 2 * kMaxHalf;

// jnp.pad 'reflect' applied until in range; n >= 2. The fold has period
// 2*(n-1): -1 -> 1, n -> n-2.
__device__ __forceinline__ int reflect_index(int j, int n) {
  const int period = 2 * (n - 1);
  j %= period;
  if (j < 0) j += period;
  return j < n ? j : period - j;
}

__global__ void __launch_bounds__(kTile * kRowsPerIt)
blur_band_kernel(const float* __restrict__ x, float* __restrict__ out,
                 const float* __restrict__ taps, int h, int w, int k) {
  __shared__ float s_taps[kMaxTaps];
  __shared__ int s_row[kTile + 2 * kMaxHalf];  // reflected row * w
  __shared__ int s_col[kStrip];                // reflected column
  __shared__ float s_v[kTile][kStrip];

  const int half = k / 2;
  const int strip = kTile + 2 * half;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int tid = threadIdx.y * kTile + threadIdx.x;
  const int nthreads = kTile * kRowsPerIt;

  for (int t = tid; t < k; t += nthreads) s_taps[t] = taps[t];
  for (int q = tid; q < strip; q += nthreads) {
    s_row[q] = reflect_index(r0 - half + q, h) * w;
    s_col[q] = reflect_index(c0 - half + q, w);
  }
  __syncthreads();

  // vertical pass: V rows r0..r0+kTile-1 at the strip's reflected columns.
  // A thread computes kRowsPerThread consecutive rows and slides a window
  // of input values down the column: one load feeds kRowsPerThread
  // multiply-adds. Rows past the map's edge are computed (their reflected
  // indices are valid) and never stored.
  const float* xm = x + base;
  const int rb = threadIdx.y * kRowsPerThread;
  for (int p = threadIdx.x; p < strip; p += kTile) {
    const int col = s_col[p];
    float win[kRowsPerThread];
    float acc[kRowsPerThread];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) {
      win[j] = xm[s_row[rb + j] + col];
      acc[j] = 0.f;
    }
    for (int t = 0; t < k; ++t) {
      const float g = s_taps[t];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) acc[j] += g * win[j];
#pragma unroll
      for (int j = 0; j + 1 < kRowsPerThread; ++j) win[j] = win[j + 1];
      if (t + 1 < k) win[kRowsPerThread - 1] =
          xm[s_row[rb + t + kRowsPerThread] + col];
    }
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j) s_v[rb + j][p] = acc[j];
  }
  __syncthreads();

  // horizontal pass from the strip; each tap is read once for the rows
  float acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.f;
  for (int t = 0; t < k; ++t) {
    const float g = s_taps[t];
#pragma unroll
    for (int j = 0; j < kRowsPerThread; ++j)
      acc[j] += g * s_v[rb + j][threadIdx.x + t];
  }
  const int c = c0 + threadIdx.x;
  if (c >= w) return;
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) {
    const int r = r0 + rb + j;
    if (r < h) out[base + static_cast<size_t>(r) * w + c] = acc[j];
  }
}

}  // namespace

extern "C" {

// x, out: [n, h, w] contiguous fp32 on the device; taps: [k] fp32 on the
// device. Needs h, w >= 2 and an odd k <= 129 (the wrapper checks). Launches
// on `stream` and returns cudaGetLastError() as an int (0 = success).
int pixelssl_blur_band(const float* x, float* out, const float* taps, int n,
                       int h, int w, int k, void* stream) {
  if (n <= 0) return 0;
  const dim3 block(kTile, kRowsPerIt);
  const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, n);
  blur_band_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x, out, taps, h, w, k);
  return static_cast<int>(cudaGetLastError());
}

const char* pixelssl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
