// Stride-1 dilated 3x3 convolution for Hopper (sm_90a), f32 on the CUDA cores:
//   y[b, o, h, w] = sum_{c, i, j} x[b, c, h + i*d - p, w + j*d - p] * w[i, j, c, o]
// with zeros outside the image. The data gradient of such a conv is the same conv of dy
// with the spatially flipped, IO-swapped kernel and padding d*(k-1) - p, so this one
// kernel serves the forward and the dgrad (the wrapper flips the weights).
//
// Replaces the TPU kernel tdnet_tpu/kernels/dilated_conv.py: _dil_kernel, reached through
// conv2d_pallas_dil (the residual blocks' 3x3 convs with dilation >= 4 in training,
// conv_wgrad="pallas").
//
// Bound by arithmetic: at the TD4-PSP18 recipe's layer4 (97 x 193 grid, 512 -> 512)
// one conv is 2 * 18,721 * 9 * 512 * 512 = 88.3 GFLOP against 38 + 38 + 9 MB of x, y
// and weights: 1.32 ms at 67 TFLOP/s f32, 0.025 ms of memory traffic at 3.35 TB/s.
//
// Design. The TPU kernel holds one row block with its 2d-row halo in VMEM and reads the
// 9 taps as shifted slices. On Hopper a 16-row halo of 193 columns x 512 channels does
// not fit beside a useful output tile, so this is an implicit GEMM instead:
// M = output pixels, N = output channels, K = 9 taps x input channels. A block owns
// 128 pixels x 128 channels (8 x 8 per thread) and walks K in chunks of 8 input
// channels of one tap, double-buffered in shared memory: the x chunk is gathered from
// the NCHW input with the tap's offset and zero padding by masking; the weight chunk is
// a row slice of the [9, ci, co] weights. Training runs in f32 with TF32 off, so the
// products are f32 FMAs on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;     // output pixels per block
constexpr int BN = 128;     // output channels per block
constexpr int BK = 8;       // input channels per K step
constexpr int THREADS = 256;
constexpr int FAR = -(1 << 28);  // a row index that every tap offset keeps outside the image

__global__ void __launch_bounds__(THREADS)
dil_conv_f32(const float* __restrict__ x, const float* __restrict__ w9, float* __restrict__ y,
             int ci, int co, int H, int W, int Ho, int Wo, int pad, int dil) {
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BN];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int L = Ho * Wo;
  x += (size_t)blockIdx.z * ci * H * W;
  y += (size_t)blockIdx.z * co * L;

  // loads: x rows k = tid / 32 of the chunk, pixels tid % 32 + 32 j (coalesced along w);
  // weight row k = tid / 32, channels 4 (tid % 32) .. + 3 (one 16-byte vector)
  const int lk = tid / 32, lm = tid % 32, ln = (tid % 32) * 4;
  int oh[4], ow[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int m = m0 + lm + 32 * j;
    oh[j] = m < L ? m / Wo : FAR;
    ow[j] = m < L ? m % Wo : 0;
  }
  const bool n_ok = n0 + ln < co;   // co % 4 == 0
  const int chunks = ci / BK, steps = 9 * chunks;
  const size_t plane = (size_t)H * W;

  float ra[4];
  float4 rb;
  auto load = [&](int s) {
    const int tap = s / chunks, c = (s % chunks) * BK + lk;
    const int dy = (tap / 3) * dil - pad, dx = (tap % 3) * dil - pad;
    const float* xc = x + c * plane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ih = oh[j] + dy, iw = ow[j] + dx;
      ra[j] = (ih >= 0 && ih < H && iw >= 0 && iw < W) ? __ldg(xc + (size_t)ih * W + iw) : 0.f;
    }
    rb = n_ok ? __ldg(reinterpret_cast<const float4*>(w9 + ((size_t)tap * ci + c) * co + n0 + ln))
              : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][lk][lm + 32 * j] = ra[j];
    *reinterpret_cast<float4*>(&Bs[buf][lk][ln]) = rb;
  };

  // compute: pixels 4 tx .. + 3 and 64 + 4 tx .. + 3, channels 4 ty .. + 3 and 64 + 4 ty ..
  const int tx = tid % 16, ty = tid / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  store(0);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) load(s + 1);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][tx * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][64 + tx * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[buf][k][ty * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[buf][k][64 + ty * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    // the other buffer was last read in step s - 1, which every thread has finished
    if (s + 1 < steps) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i < 4 ? tx * 4 + i : 64 + tx * 4 + i - 4);
    if (m >= L) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? ty * 4 + j : 64 + ty * 4 + j - 4);
      if (n < co) y[(size_t)n * L + m] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// x [n, ci, H, W], w9 [9, ci, co] (tap-major: w9[i*3 + j, c, o] = w[o, c, i, j]),
// y [n, co, Ho, Wo] with Ho = H + 2 pad - 2 dil and Wo = W + 2 pad - 2 dil; f32,
// contiguous, w9 16-byte aligned. ci % 8 == 0, co % 4 == 0. Returns the launch's CUDA
// error, 0 if none.
int tdnet_dilated_conv(const void* x, const void* w9, void* y, int n, int ci, int co, int H,
                       int W, int pad, int dil, void* stream) {
  const int Ho = H + 2 * pad - 2 * dil, Wo = W + 2 * pad - 2 * dil;
  if (ci % BK || co % 4 || Ho < 1 || Wo < 1 || n < 1 || (uintptr_t)w9 % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Ho * Wo + BM - 1) / BM, (co + BN - 1) / BN, n);
  dil_conv_f32<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w9, (float*)y, ci, co, H, W, Ho, Wo, pad, dil);
  return (int)cudaGetLastError();
}

const char* tdnet_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
