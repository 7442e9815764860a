// Bilinear resize (align_corners=False, no antialias) for Hopper (sm_90a), plain C interface.
//
// Replaces no TPU kernel: the JAX package resizes with jax.image.resize, which XLA fuses
// into its neighbours. The port resized through ATen's F.interpolate, whose NCHW forward
// (upsample_bilinear2d_out_frame) gives one thread to each output pixel (h, w) and walks
// every (n, c) plane inside it: at CSF+Res2Net's 84^2 head that is 7,056 threads for
// 11,264 planes at bucket 8, and the card ran it at 2% of its bytes roofline.
//
// What bounds it. An output costs three multiply-adds and three multiplies against four
// reads (mostly from L1/L2: neighbouring outputs share their sources) and one write, so
// the bound is device-memory bytes: the input read once and the output written once at
// 3.35 TB/s. The design is about keeping enough stores in flight and the arithmetic per
// output small.
//
// Design.
// - Every output has a thread. A thread owns a run of V outputs of one row that are
//   adjacent along W (16 bytes: V = 4 in f32, 8 in bf16 and f16, 2 in f64, where W_out,
//   the output's strides and its alignment allow; else V = 1) and stores them at once. A
//   block's threads take consecutive runs of consecutive rows, so a warp stores one
//   contiguous range of a contiguous output.
// - The grid's z axis splits the N*C planes: the card fills first, and past that a
//   thread takes a few planes. It computes the source rows, columns and weights of its
//   run once, in registers, and reuses them for each of its planes, walking (n, c)
//   without a division.
// - The input is read through the strides it is given (a row band sliced out of an NCHW
//   map, a channels-last map: no copy), the output written through its own. Offsets
//   inside a plane are 32-bit, across planes 64-bit.
//
// Numbers: ATen's, bit for bit (torch/include/ATen/native/cuda/UpSample.cuh and
// upsample_bilinear2d_out_frame, as nvcc compiled them for the card). The scale is computed by the caller
// in the accumulate type A (float for float, bf16 and f16; double for double):
// (A)(1.0 / factor) for a scale factor, (A)in / out for a size. The source index is
// max(scale * (dst + 0.5) - 0.5, 0), i0 its truncation, i1 = i0 + (i0 < in - 1),
// l1 = src - i0, l0 = 1 - l1; the value h0 * (w0 * v00 + w1 * v01) + h1 * (w0 * v10 +
// w1 * v11) in A, then rounded to the output type. nvcc contracts a * b + c * d into
// fma(a, b, c * d) and scale * t - 0.5 into fma(scale, t, -0.5); the kernel spells
// those roundings out with intrinsics, so its numbers do not depend on how its own
// build contracts. ATen's channels-last kernel (a channels-last map of 16 or more
// channels) was contracted otherwise in one place for float and double: its top row is
// fma(w1, v01, w0 * v00). The caller says which rounding to follow (`nhwc_rounding`);
// the two differ by one rounding in about a fifth of the outputs of a resize at a ratio
// that is not a power of two.
//
// The kernel launches on the caller's stream, never synchronizes and allocates nothing;
// the entry point returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<double> { using type = double; };

__device__ __forceinline__ float to_acc(float v) { return v; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_acc(__half v) { return __half2float(v); }
__device__ __forceinline__ double to_acc(double v) { return v; }

template <typename T> __device__ __forceinline__ T from_acc(typename Acc<T>::type v);
template <> __device__ __forceinline__ float from_acc<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_acc<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ double from_acc<double>(double v) { return v; }

// a * u + b * v, rounded as ATen's build rounds it: fma(a, u, b * v)
__device__ __forceinline__ float blend(float a, float u, float b, float v) {
  return __fmaf_rn(a, u, __fmul_rn(b, v));
}
__device__ __forceinline__ double blend(double a, double u, double b, double v) {
  return __fma_rn(a, u, __dmul_rn(b, v));
}

// scale * t - 0.5 as one fma
__device__ __forceinline__ float src_index(float scale, float t) { return __fmaf_rn(scale, t, -0.5f); }
__device__ __forceinline__ double src_index(double scale, double t) { return __fma_rn(scale, t, -0.5); }

// Source index i0, the step to i1 (0 or 1) and the weights l0, l1 of output index `dst`
// along an axis of `in` source elements.
template <typename A>
__device__ __forceinline__ void source(A scale, int dst, int in, int& i0, int& step, A& l0,
                                       A& l1) {
  A src = src_index(scale, static_cast<A>(dst) + static_cast<A>(0.5));
  src = src < static_cast<A>(0) ? static_cast<A>(0) : src;
  i0 = static_cast<int>(src);
  step = i0 < in - 1 ? 1 : 0;
  l1 = src - static_cast<A>(i0);
  l0 = static_cast<A>(1) - l1;
}

template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

struct Geometry {
  int c, planes;              // C and N * C
  int h_in, w_in, h_out, w_out;
  int runs;                   // w_out / V
  int sx_h, sx_w;             // input strides inside a plane (elements)
  long long sx_n, sx_c;       // input strides across planes
  long long sy_n, sy_c, sy_h, sy_w;  // output strides
  double scale_h, scale_w;    // already rounded to the accumulate type
  int nhwc_rounding;          // round as ATen's channels-last kernel does
};

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    resize_bilinear_nchw(const T* __restrict__ x, T* __restrict__ y, const Geometry g) {
  using A = typename Acc<T>::type;
  const int run = blockIdx.x * blockDim.x + threadIdx.x;
  const int oh = blockIdx.y * blockDim.y + threadIdx.y;
  if (run >= g.runs || oh >= g.h_out) return;

  int i0, di;
  A h0, h1;
  source<A>(static_cast<A>(g.scale_h), oh, g.h_in, i0, di, h0, h1);
  const int row0 = i0 * g.sx_h, row1 = (i0 + di) * g.sx_h;
  int col0[V], col1[V];
  A w0[V], w1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    int j0, dj;
    source<A>(static_cast<A>(g.scale_w), run * V + k, g.w_in, j0, dj, w0[k], w1[k]);
    col0[k] = j0 * g.sx_w;
    col1[k] = (j0 + dj) * g.sx_w;
  }
  const long long out_off = oh * g.sy_h + static_cast<long long>(run) * V * g.sy_w;

  // planes blockIdx.z, + gridDim.z, ...; (n, c) advance by (dn, dc) with a carry
  int p = blockIdx.z;
  int n = p / g.c, c = p - n * g.c;
  const int dn = gridDim.z / g.c, dc = gridDim.z - dn * g.c;
  for (; p < g.planes; p += gridDim.z) {
    const T* xp = x + n * g.sx_n + c * g.sx_c;
    Vec<T, V> out;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const A v00 = to_acc(xp[row0 + col0[k]]), v01 = to_acc(xp[row0 + col1[k]]);
      const A top = g.nhwc_rounding ? blend(w1[k], v01, w0[k], v00) : blend(w0[k], v00, w1[k], v01);
      const A bot = blend(w0[k], to_acc(xp[row1 + col0[k]]), w1[k], to_acc(xp[row1 + col1[k]]));
      out.v[k] = from_acc<T>(blend(h0, top, h1, bot));
    }
    *reinterpret_cast<Vec<T, V>*>(y + n * g.sy_n + c * g.sy_c + out_off) = out;
    n += dn;
    c += dc;
    if (c >= g.c) {
      c -= g.c;
      ++n;
    }
  }
}

template <typename T, int V>
int launch(const void* x, void* y, const Geometry& g, int bx, int by, int gz,
           cudaStream_t stream) {
  const dim3 grid((g.runs + bx - 1) / bx, (g.h_out + by - 1) / by, gz);
  resize_bilinear_nchw<T, V><<<grid, dim3(bx, by), 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), g);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, void* y, const Geometry& g, int bx, int by, int gz,
               cudaStream_t st) {
  switch (vec) {
    case 1: return launch<T, 1>(x, y, g, bx, by, gz, st);
    case 2: return launch<T, 2>(x, y, g, bx, by, gz, st);
    case 4:
      if constexpr (sizeof(T) <= 4) return launch<T, 4>(x, y, g, bx, by, gz, st);
      break;
    case 8:
      if constexpr (sizeof(T) == 2) return launch<T, 8>(x, y, g, bx, by, gz, st);
      break;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: device pointers to (N, C, H, W) tensors of one dtype, laid out by their strides.
// a: 20 int64 values: n, c, h_in, w_in, h_out, w_out; the input's strides n, c, h, w;
// the output's strides n, c, h, w (elements); dtype (0 float32, 1 bfloat16, 2 float16,
// 3 float64); vec V; block bx x by; grid z; ATen's channels-last rounding (0 or 1).
// scale_h, scale_w: the source scales, already rounded to the accumulate type. The
// launch is checked here. Returns a cudaError_t.
extern "C" int sod_resize_bilinear(const void* x, void* y, const long long* a, double scale_h,
                                   double scale_w, void* stream) {
  const long long n = a[0], c = a[1], h_in = a[2], w_in = a[3], h_out = a[4], w_out = a[5];
  const long long* sx = a + 6;
  const long long* sy = a + 10;
  const long long dtype = a[14], vec = a[15], bx = a[16], by = a[17], gz = a[18];
  const long long nhwc_rounding = a[19];
  static const int elt[4] = {4, 2, 2, 8};
  if (dtype < 0 || dtype > 3 || (nhwc_rounding != 0 && nhwc_rounding != 1))
    return (int)cudaErrorInvalidValue;
  if (n < 1 || c < 1 || h_in < 1 || w_in < 1 || h_out < 1 || w_out < 1 || n * c > INT32_MAX ||
      h_in > INT32_MAX || w_in > INT32_MAX || h_out > INT32_MAX || w_out > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 4; ++i)
    if (sx[i] < 0 || sy[i] < 0) return (int)cudaErrorInvalidValue;
  if ((h_in - 1) * sx[2] + (w_in - 1) * sx[3] > INT32_MAX) return (int)cudaErrorInvalidValue;
  if (vec < 1 || vec * elt[dtype] > 16 || (vec & (vec - 1)) || w_out % vec ||
      (vec > 1 && sy[3] != 1))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(y) % (vec * elt[dtype])) return (int)cudaErrorMisalignedAddress;
  const long long runs = w_out / vec;
  if (bx < 1 || by < 1 || bx * by > MAX_THREADS || gz < 1 || gz > 65535 ||
      (h_out + by - 1) / by > 65535 || (runs + bx - 1) / bx > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.c = (int)c;
  g.planes = (int)(n * c);
  g.h_in = (int)h_in;
  g.w_in = (int)w_in;
  g.h_out = (int)h_out;
  g.w_out = (int)w_out;
  g.runs = (int)runs;
  g.sx_n = sx[0];
  g.sx_c = sx[1];
  g.sx_h = (int)sx[2];
  g.sx_w = (int)sx[3];
  g.sy_n = sy[0];
  g.sy_c = sy[1];
  g.sy_h = sy[2];
  g.sy_w = sy[3];
  g.scale_h = scale_h;
  g.scale_w = scale_w;
  g.nhwc_rounding = (int)nhwc_rounding;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_vec<float>((int)vec, x, y, g, (int)bx, (int)by, (int)gz, st);
    case 1: return launch_vec<__nv_bfloat16>((int)vec, x, y, g, (int)bx, (int)by, (int)gz, st);
    case 2: return launch_vec<__half>((int)vec, x, y, g, (int)bx, (int)by, (int)gz, st);
    default: return launch_vec<double>((int)vec, x, y, g, (int)bx, (int)by, (int)gz, st);
  }
}
