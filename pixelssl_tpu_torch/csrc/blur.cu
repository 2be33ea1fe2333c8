// Banded separable Gaussian blur with the reflect boundary, for sm_90a.
//
// Replaces the TPU kernel pixelssl_tpu/ops/blur_pallas.py::_blur_kernel
// (launched by gaussian_blur_fused, pl.pallas_call at blur_pallas.py:74),
// which computes out[n] = Bh @ X[n] @ Bw^T with dense banded matrices built
// by _blur_matrix. Here the band is indexed directly: row i of Bh holds the
// k taps g[t] at columns reflect(i - k/2 + t), so
//
//   V[n, i, c]   = sum_t g[t] * X[n, reflect(i - k/2 + t), c]
//   out[n, i, j] = sum_t g[t] * V[n, i, reflect(j - k/2 + t)]
//
// with the boundary of jnp.pad(mode='reflect'): the edge is not repeated
// (-1 -> 1, size -> size-2), applied again until the index is inside the
// map, as the while loop of _blur_matrix does when k/2 >= size.
//
// Bound on the H100: each map is read once and written once (2*N*H*W*4
// bytes) and the band form does 2*N*H*W*2k flops; at the GCT shapes
// ([8,321,321] k=21, [4,321,321] k=41/81) both are one or two microseconds,
// near the cost of a launch. The design computes each of V and out exactly
// once, in two launches of one-dimensional reflected convolutions:
//
// * pass V: a block owns kLines columns by kSeg output rows of one map. It
//   copies the (kSeg + k - 1) reflected input rows of its columns into a
//   shared strip with cp.async (reflection is applied to the row index
//   while loading, so the strip is contiguous), and each thread computes
//   kRun consecutive rows of one column;
// * pass H: a block owns kLines rows by kSeg output columns of V and copies
//   the (kSeg + k - 1) reflected columns of its rows into a strip whose row
//   pitch is odd, so the 32 rows a warp reads lie in 32 banks; each thread
//   computes kRun consecutive columns of one row, and the block's results
//   go back through the strip so that they leave in coalesced row segments.
//
// In both passes a thread slides a kRun-value register window along its
// line: one shared-memory load of the strip and one broadcast tap load feed
// kRun fp32 multiply-adds, and the halo costs loads, never arithmetic. V
// goes through device memory between the passes (1.6-3.3 MB at the GCT
// shapes, resident in the 50 MB L2). fp32 throughout, no tensor cores.
// What is left of the time is moving the strips and the launches, not the
// arithmetic: a copy of this kernel that skips the multiply-adds takes most
// of its time (PERF.md). Rows of 321 floats are not 16-byte aligned, so the
// copies go 4 bytes a thread.
//
// Any odd k: the strip holds kSeg + c - 1 lines for a chunk of c <=
// kMaxChunk taps, sized at launch from k (above 48 KB of shared memory the
// launch opts in with cudaFuncSetAttribute; kMaxChunk taps take 74 KB).
// A larger k loops over its taps in chunks, each reloading the strip at
// the chunk's offset and adding to the same register sums. The reflection
// is applied to every line index as it is loaded, however many times the
// window folds over a small map.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChunk = 512;  // taps whose strip one load holds
constexpr int kRun = 8;       // outputs a thread computes along its line
constexpr int kLines = 32;    // threadIdx.x: one column (V) or row (H)
constexpr int kGroups = 8;    // threadIdx.y: runs along the line
constexpr int kSeg = kRun * kGroups;  // outputs a block computes per line
constexpr int kThreads = kLines * kGroups;

// jnp.pad 'reflect' applied until in range; n >= 2. The fold has period
// 2*(n-1): -1 -> 1, n -> n-2.
__device__ __forceinline__ int reflect_index(int j, int n) {
  if (j >= 0 && j < n) return j;
  const int period = 2 * (n - 1);
  j %= period;
  if (j < 0) j += period;
  return j < n ? j : period - j;
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// acc[j] += sum_t taps[t] * line[(j + t) * stride], j < kRun, t < k. The
// window is a ring of registers whose slots the unrolled loop names
// statically, so sliding it moves no data.
__device__ __forceinline__ void slide(const float* line, int stride,
                                      const float* taps, int k,
                                      float (&acc)[kRun]) {
  float win[kRun];
#pragma unroll
  for (int q = 0; q + 1 < kRun; ++q) win[q] = line[q * stride];
  int t0 = 0;
  for (; t0 + kRun <= k; t0 += kRun) {
#pragma unroll
    for (int u = 0; u < kRun; ++u) {
      win[(u + kRun - 1) % kRun] = line[(t0 + u + kRun - 1) * stride];
      const float g = taps[t0 + u];
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        acc[j] = fmaf(g, win[(u + j) % kRun], acc[j]);
    }
  }
#pragma unroll
  for (int u = 0; u < kRun; ++u) {
    if (t0 + u < k) {
      win[(u + kRun - 1) % kRun] = line[(t0 + u + kRun - 1) * stride];
      const float g = taps[t0 + u];
#pragma unroll
      for (int j = 0; j < kRun; ++j)
        acc[j] = fmaf(g, win[(u + j) % kRun], acc[j]);
    }
  }
}

// Pass V. Grid (ceil(w / kLines), ceil(h / kSeg), n); dynamic shared
// memory: chunk + (kSeg + chunk - 1) * kLines floats.
__global__ void __launch_bounds__(kThreads)
blur_pass_v_kernel(const float* __restrict__ x, float* __restrict__ v,
                 const float* __restrict__ taps, int h, int w, int k,
                 int chunk) {
  extern __shared__ float smem[];
  float* s_taps = smem;
  float* s_x = smem + chunk;  // [kSeg + chunk - 1][kLines]

  const int half = k / 2;
  const int r0 = blockIdx.y * kSeg;
  const int c = blockIdx.x * kLines + threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int tid = threadIdx.y * kLines + threadIdx.x;
  const int rb = threadIdx.y * kRun;
  const bool active = c < w && r0 + rb < h;
  // columns past the edge load the last column and are never stored
  const float* xc = x + base + min(c, w - 1);

  float acc[kRun] = {};
  for (int t0 = 0; t0 < k; t0 += chunk) {
    const int tc = min(chunk, k - t0);
    const int rows = kSeg + tc - 1;
    if (t0 > 0) __syncthreads();  // the last chunk's strip is read
    for (int t = tid; t < tc; t += kThreads)
      cp_async_f32(s_taps + t, taps + t0 + t);
    for (int q = threadIdx.y; q < rows; q += kGroups)
      cp_async_f32(s_x + q * kLines + threadIdx.x,
                   xc + static_cast<size_t>(
                            reflect_index(r0 - half + t0 + q, h)) * w);
    cp_async_wait_all();
    __syncthreads();
    if (active) slide(s_x + rb * kLines + threadIdx.x, kLines, s_taps, tc, acc);
  }
  if (!active) return;
  float* vc = v + base + c;
#pragma unroll
  for (int j = 0; j < kRun; ++j) {
    const int r = r0 + rb + j;
    if (r < h) vc[static_cast<size_t>(r) * w] = acc[j];
  }
}

// Pass H. Grid (ceil(w / kSeg), ceil(h / kLines), n); dynamic shared
// memory: chunk + kLines * pitch floats, pitch = (kSeg + chunk - 1) | 1.
__global__ void __launch_bounds__(kThreads)
blur_pass_h_kernel(const float* __restrict__ v, float* __restrict__ out,
                 const float* __restrict__ taps, int h, int w, int k,
                 int chunk) {
  extern __shared__ float smem[];
  float* s_taps = smem;
  float* s_v = smem + chunk;  // [kLines][pitch]

  const int half = k / 2;
  const int pitch = (kSeg + chunk - 1) | 1;  // odd: a warp's 32 rows hit 32 banks
  const int r0 = blockIdx.y * kLines;
  const int c0 = blockIdx.x * kSeg;
  const size_t base = static_cast<size_t>(blockIdx.z) * h * w;
  const int tid = threadIdx.y * kLines + threadIdx.x;
  const int cb = threadIdx.y * kRun;
  const bool active = r0 + static_cast<int>(threadIdx.x) < h && c0 + cb < w;

  float acc[kRun] = {};
  for (int t0 = 0; t0 < k; t0 += chunk) {
    const int tc = min(chunk, k - t0);
    const int cols = kSeg + tc - 1;
    if (t0 > 0) __syncthreads();  // the last chunk's strip is read
    for (int t = tid; t < tc; t += kThreads)
      cp_async_f32(s_taps + t, taps + t0 + t);
    // a warp copies 32 neighbouring columns of one row; rows past the edge
    // load the last row and are never stored
    for (int q = threadIdx.x; q < cols; q += kLines) {
      const float* vq = v + base + reflect_index(c0 - half + t0 + q, w);
      for (int i = threadIdx.y; i < kLines; i += kGroups)
        cp_async_f32(s_v + i * pitch + q,
                     vq + static_cast<size_t>(min(r0 + i, h - 1)) * w);
    }
    cp_async_wait_all();
    __syncthreads();
    if (active) slide(s_v + threadIdx.x * pitch + cb, 1, s_taps, tc, acc);
  }
  // a warp's threads lie in 32 rows, so its results go back through the
  // strip (same odd pitch) and leave the block in coalesced row segments
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRun; ++j) s_v[threadIdx.x * pitch + cb + j] = acc[j];
  __syncthreads();
  for (int i = threadIdx.y; i < kLines && r0 + i < h; i += kGroups) {
    float* orow = out + base + static_cast<size_t>(r0 + i) * w;
    for (int q = threadIdx.x; q < kSeg && c0 + q < w; q += kLines)
      orow[c0 + q] = s_v[i * pitch + q];
  }
}

// Dynamic shared memory above the default 48 KB needs the kernel's
// opt-in; each kernel keeps the largest size it was given.
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return 0;
  const int code = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
  if (code == 0) *allowed = bytes;
  return code;
}

}  // namespace

extern "C" {

// x, out, scratch: [n, h, w] contiguous fp32 on the device (scratch holds
// V between the passes); taps: [k] fp32 on the device. Needs h, w >= 2 and
// an odd k (the wrapper checks). Launches both passes on `stream` and
// returns cudaGetLastError() as an int (0 = success).
int pixelssl_blur_band(const float* x, float* out, float* scratch,
                       const float* taps, int n, int h, int w, int k,
                       void* stream) {
  if (n <= 0) return 0;
  static size_t allowed_v = 0, allowed_h = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(kLines, kGroups);
  const int chunk = k < kMaxChunk ? k : kMaxChunk;
  const size_t smem_v = sizeof(float) * (chunk + (kSeg + chunk - 1) * kLines);
  int code = allow_smem(blur_pass_v_kernel, smem_v, &allowed_v);
  if (code != 0) return code;
  const dim3 grid_v((w + kLines - 1) / kLines, (h + kSeg - 1) / kSeg, n);
  blur_pass_v_kernel<<<grid_v, block, smem_v, s>>>(x, scratch, taps, h, w,
                                                   k, chunk);
  code = static_cast<int>(cudaGetLastError());
  if (code != 0) return code;
  const size_t smem_h =
      sizeof(float) * (chunk + kLines * ((kSeg + chunk - 1) | 1));
  code = allow_smem(blur_pass_h_kernel, smem_h, &allowed_h);
  if (code != 0) return code;
  const dim3 grid_h((w + kSeg - 1) / kSeg, (h + kLines - 1) / kLines, n);
  blur_pass_h_kernel<<<grid_h, block, smem_h, s>>>(scratch, out, taps, h,
                                                   w, k, chunk);
  return static_cast<int>(cudaGetLastError());
}

const char* pixelssl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
