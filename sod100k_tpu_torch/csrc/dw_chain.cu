// Fused ILBlock depthwise tail for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel sod100k_tpu/ops/pallas/dw_chain.py::fused_dw_chain.
// Per octave branch, two stages in one pass over NCHW planes:
//
//   x -> dw3x3 (zero pad 1) -> *scale + shift (eval BN folded) -> PReLU
//     -> round to the input dtype
//     -> dw3x3 (zero pad 1) -> *scale + shift -> PReLU -> y (input dtype)
//
// Sums are taken in f32; the taps (x100 already applied), scale, shift and
// alpha are f32 per channel.
//
// Bound: device-memory bytes. Each element needs 2 x 9 multiply-adds and a
// few flops, against 2 bytes read and 2 written in bf16: about 5 flops per
// byte, far under the H100's ratio. Unfused, the two stages move the
// activation 4 times (read x, write t, read t, write y); CSNet-L at 224^2
// runs the tail on about 10.3 M elements per image, so fusing saves
// 2 x 2 B x 10.3 M per image in bf16.
//
// Design: one block per (spatial tile, channel, image). The block loads its
// TILE_H x TILE_W tile plus a 2-pixel halo into shared memory as f32,
// computes stage 1 on the tile plus a 1-pixel ring into shared memory
// (positions outside the image are the second conv's zero padding), rounds
// it to the input dtype, then computes stage 2 on the tile and writes it.
// The intermediate never touches device memory. The halo re-reads
// (36^2 / 32^2 = 1.27x on input) and the idle threads of small planes are
// left for later work (vectorized loads, several channels per block, TMA).
//
// The kernel launches on the caller's stream, never synchronizes and
// allocates nothing; the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 32;
constexpr int IN_H = TILE_H + 4;   // tile + 2-pixel halo
constexpr int IN_W = TILE_W + 4;
constexpr int MID_H = TILE_H + 2;  // tile + 1-pixel ring
constexpr int MID_W = TILE_W + 2;
constexpr int THREADS = 256;
// per-channel parameter row: w1[9] s1 b1 a1 w2[9] s2 b2 a2
constexpr int NPARAM = 24;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dw_chain_kernel(const T* __restrict__ x, T* __restrict__ y,
                const float* __restrict__ params, int C, int H, int W,
                int tiles_w) {
  __shared__ float xin[IN_H][IN_W];
  __shared__ float mid[MID_H][MID_W];

  const int c = blockIdx.y;
  const size_t plane = ((size_t)blockIdx.z * C + c) * (size_t)H * (size_t)W;
  const int ty0 = (blockIdx.x / tiles_w) * TILE_H;
  const int tx0 = (blockIdx.x % tiles_w) * TILE_W;

  const float* p = params + (size_t)c * NPARAM;
  float w1[9], w2[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    w1[k] = p[k];
    w2[k] = p[12 + k];
  }
  const float s1 = p[9], b1 = p[10], a1 = p[11];
  const float s2 = p[21], b2 = p[22], a2 = p[23];

  const T* xp = x + plane;
  for (int i = threadIdx.x; i < IN_H * IN_W; i += THREADS) {
    const int r = i / IN_W, q = i % IN_W;
    const int gy = ty0 - 2 + r, gx = tx0 - 2 + q;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) v = to_f32(xp[(size_t)gy * W + gx]);
    xin[r][q] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < MID_H * MID_W; i += THREADS) {
    const int r = i / MID_W, q = i % MID_W;
    const int gy = ty0 - 1 + r, gx = tx0 - 1 + q;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc += xin[r + dy][q + dx] * w1[dy * 3 + dx];
      v = acc * s1 + b1;
      v = v >= 0.f ? v : v * a1;
      v = to_f32(from_f32<T>(v));  // the intermediate is held in the input dtype
    }
    mid[r][q] = v;
  }
  __syncthreads();

  T* yp = y + plane;
  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, q = i % TILE_W;
    const int gy = ty0 + r, gx = tx0 + q;
    if (gy < H && gx < W) {
      float acc = 0.f;
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) acc += mid[r + dy][q + dx] * w2[dy * 3 + dx];
      float v = acc * s2 + b2;
      v = v >= 0.f ? v : v * a2;
      yp[(size_t)gy * W + gx] = from_f32<T>(v);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y: (N, C, H, W) contiguous;
// params: (C, 24) float32 contiguous. Returns a cudaError_t.
extern "C" int sod_dw_chain(const void* x, void* y, const void* params, int n,
                            int c, int h, int w, int dtype, void* stream) {
  const int tiles_h = (h + TILE_H - 1) / TILE_H;
  const int tiles_w = (w + TILE_W - 1) / TILE_W;
  const dim3 grid(tiles_h * tiles_w, c, n);
  const dim3 block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dw_chain_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(y),
        static_cast<const float*>(params), c, h, w, tiles_w);
  } else if (dtype == 1) {
    dw_chain_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y),
        static_cast<const float*>(params), c, h, w, tiles_w);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
