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
// alpha are f32 per channel, packed as one (C, 24) row per channel:
// w1[9] s1 b1 a1 w2[9] s2 b2 a2.
//
// What bounds it. A depthwise 3x3 has no reduction over channels, so there
// is no matrix product for the tensor cores (wgmma). Each element needs
// 2 x 9 multiply-adds and a few more flops against 2 bytes read and 2
// written in bf16: about 5 flops per byte, far under the H100's ~295 flops
// per byte ridge. The least time is therefore the bytes: read x once and
// write y once over 3.35 TB/s. For CSNet-L at 224^2 and B=32 in bf16 that
// is 1.323 GB, 0.395 ms per forward (33 calls). The only gains are wide
// aligned transfers, copies in flight while the block computes, few halo
// re-reads and no idle lanes; the design below is about those.
//
// Design.
// - Work items. An item is either a band of R full-width output rows of one
//   (n, c) plane ("band" plans: planes above 32 KB, 224^2 on the main
//   path), or P consecutive whole planes ("planes" plans: R = H; 112^2 and
//   below on the main path). Because an item spans full rows, its input
//   rows [y0-2, y0+R+2) clipped to [0, H), or its P planes, are one
//   contiguous byte range of the NCHW tensor.
// - Copies. One thread brings that range into shared memory with one 1-D
//   bulk async copy (cp.async.bulk, the non-tensor-map TMA) completing on an
//   mbarrier, when the plan allows it and the range is 16-byte aligned and
//   sized. Otherwise (rows that are not 16-byte aligned, a short last group
//   of planes) all threads copy it element by element. A bulk copy has no
//   out-of-bounds fill: rows off the plane are never copied (a band never
//   takes a neighbouring plane's rows as its halo) and read as a row of
//   zeros kept in shared memory, and the padding columns x = -1 and x = W
//   are 0 in registers.
// - Persistent blocks walk over items (block b takes b, b + grid, ...) with
//   a ring of one or two slots: the copy of the item that next takes a
//   slot is issued as soon as the current item's stage 1 has read it, so a
//   copy is in flight while the block computes (with one slot, during
//   stage 2; with two, during a whole item). One slot leaves room for more
//   blocks on an SM; the plan chooses.
// - Compute. Threads map in 2-D: x over column groups of V adjacent columns
//   (one 4-16 byte shared-memory vector read per row), y over runs of rows.
//   A thread walks down its run with a 3-row window in registers, so each
//   staged value is read about once per stage instead of 9 times. Stage 1
//   covers the band plus a 1-row ring (rows off the image stay out of the
//   intermediate, which the second conv then reads as its zero padding)
//   and writes the rounded intermediate to shared memory; stage 2 writes y
//   with V-element vector stores. No division or modulo runs per element.
// - What bounds it now. With the staging copies, or the stores of y, taken
//   out the time drops by a tenth or less; with the arithmetic taken out it
//   drops by a third: the 2 x 9 f32 FMAs, BN and PReLU per element bound
//   the large shapes, not the bytes. PERF.md keeps
//   the numbers and the variants tried (python3 chip_smoke.py --variants).
//
// The kernel launches on the caller's stream, never synchronizes and
// allocates nothing; the entry points return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int NPARAM = 24;
constexpr int MAX_THREADS = 256;
constexpr int MAX_SMEM = 232448;  // a block's dynamic shared memory on sm_90
constexpr int SLOT_ALIGN = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V> struct alignas(sizeof(T) * V) Vec { T v[V]; };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One thread: expect `bytes` on `bar`, then copy them global -> shared.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Shape {
  int C, H, W;
  int planes_total;  // N * C
  int P, R;          // planes per item, output rows per item
  int nbands;        // ceil(H / R)
  int items;
  int nslots;        // ring slots: 1 or 2
  bool bulk;
};

// Item k of the walk: planes [p0, p0 + np), output rows [y0, y0 + rows),
// staged input rows [in_lo, in_hi), intermediate rows [m_lo, m_hi).
struct Item {
  int p0, np, y0, rows, in_lo, in_hi, m_lo, m_hi;
  size_t src_off;  // element offset of the staged range in x
  int count;       // elements staged
  bool bulk;
};

template <typename T>
__device__ __forceinline__ Item make_item(const Shape& s, int k, const T* x) {
  Item it;
  const int g = k / s.nbands;  // once per item, not per element
  const int band = k - g * s.nbands;
  it.p0 = g * s.P;
  it.np = min(s.P, s.planes_total - it.p0);
  it.y0 = band * s.R;
  it.rows = min(s.R, s.H - it.y0);
  it.in_lo = max(it.y0 - 2, 0);
  it.in_hi = min(it.y0 + it.rows + 2, s.H);
  it.m_lo = max(it.y0 - 1, 0);
  it.m_hi = min(it.y0 + it.rows + 1, s.H);
  // np > 1 only for whole planes (R = H), where in rows are [0, H)
  it.src_off = ((size_t)it.p0 * s.H + it.in_lo) * (size_t)s.W;
  it.count = ((it.np - 1) * s.H + (it.in_hi - it.in_lo)) * s.W;
  const size_t bytes = (size_t)it.count * sizeof(T);
  it.bulk = s.bulk && ((reinterpret_cast<uintptr_t>(x + it.src_off) | bytes) & 15) == 0;
  return it;
}

// Columns [x0 - 1, x0 + V] of row gy of one staged plane (rows [lo, hi) at
// `base`, W elements each), as f32; rows off the plane read the zero row.
template <typename T, int V>
__device__ __forceinline__ void load_row(float (&r)[V + 2], const T* base, const T* zero,
                                         int lo, int hi, int gy, int x0, int W) {
  const T* p = (gy >= lo && gy < hi ? base + (gy - lo) * W : zero) + x0;
  const Vec<T, V> v = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) r[i + 1] = to_f32(v.v[i]);
  r[0] = x0 > 0 ? to_f32(p[-1]) : 0.f;
  r[V + 1] = x0 + V < W ? to_f32(p[V]) : 0.f;
}

template <typename T, int V>
__device__ __forceinline__ void emit_row(const float (&a)[V + 2], const float (&b)[V + 2],
                                         const float (&c)[V + 2], const float (&w)[9], float s,
                                         float sh, float al, T* out) {
  Vec<T, V> o;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) acc += a[i + dx] * w[dx];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) acc += b[i + dx] * w[3 + dx];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) acc += c[i + dx] * w[6 + dx];
    float v = acc * s + sh;
    v = v >= 0.f ? v : v * al;
    o.v[i] = from_f32<T>(v);
  }
  *reinterpret_cast<Vec<T, V>*>(out) = o;
}

// One stage over the item's np planes: output rows [olo, ohi) of each plane
// from source rows [slo, shi) (stride src_plane elements between planes),
// to dst (row olo of plane p at dst + p * dst_plane).
template <typename T, int V>
__device__ __forceinline__ void conv_stage(const T* src, int slo, int shi, size_t src_plane,
                                           T* dst, size_t dst_plane, int olo, int ohi, int np,
                                           int W, int c0, int C, const T* zero,
                                           const float* __restrict__ params) {
  const int G = W / V;
  const int rpp = max(1, (int)blockDim.y / np);  // runs per plane
  const int K = (ohi - olo + rpp - 1) / rpp;     // rows per run
  for (int j = threadIdx.y; j < np * rpp; j += blockDim.y) {
    const int p = j / rpp;  // once per run of K rows
    const int ra = olo + (j - p * rpp) * K;
    const int rb = min(ra + K, ohi);
    if (ra >= rb) continue;
    int c = c0 + p;
    while (c >= C) c -= C;
    const float* q = params + (size_t)c * NPARAM;
    float w[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) w[i] = __ldg(q + i);
    const float s = __ldg(q + 9), sh = __ldg(q + 10), al = __ldg(q + 11);
    const T* sp = src + p * src_plane;
    T* dp = dst + p * dst_plane + (size_t)(ra - olo) * W;
    for (int cg = threadIdx.x; cg < G; cg += blockDim.x) {
      const int x0 = cg * V;
      float r0[V + 2], r1[V + 2], r2[V + 2];
      load_row<T, V>(r0, sp, zero, slo, shi, ra - 1, x0, W);
      load_row<T, V>(r1, sp, zero, slo, shi, ra, x0, W);
      T* o = dp + x0;
      // the window rotates by renaming, three rows per trip
      for (int gy = ra;;) {
        if (gy >= rb) break;
        load_row<T, V>(r2, sp, zero, slo, shi, gy + 1, x0, W);
        emit_row<T, V>(r0, r1, r2, w, s, sh, al, o);
        ++gy;
        o += W;
        if (gy >= rb) break;
        load_row<T, V>(r0, sp, zero, slo, shi, gy + 1, x0, W);
        emit_row<T, V>(r1, r2, r0, w, s, sh, al, o);
        ++gy;
        o += W;
        if (gy >= rb) break;
        load_row<T, V>(r1, sp, zero, slo, shi, gy + 1, x0, W);
        emit_row<T, V>(r2, r0, r1, w, s, sh, al, o);
        ++gy;
        o += W;
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
dw_chain_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ params,
                Shape s, int slot_elems, int zero_offset, int zero_bytes) {
  // dynamic shared memory only (the whole 227 KB stays available to it):
  // nslots ring slots of slot_elems, the intermediate, a row of W zeros
  // (read for rows off the plane), then the mbarriers
  extern __shared__ __align__(SLOT_ALIGN) unsigned char smem[];
  T* const ring = reinterpret_cast<T*>(smem);
  T* const mid = ring + s.nslots * (size_t)slot_elems;
  T* const zero = reinterpret_cast<T*>(smem + zero_offset);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(smem + zero_offset + zero_bytes);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  const size_t HW = (size_t)s.H * s.W;

  for (int i = tid; i < s.W; i += nthreads) zero[i] = from_f32<T>(0.f);
  if (tid == 0) {
    for (int i = 0; i < s.nslots; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int k0 = blockIdx.x, step = gridDim.x;
  if (tid == 0) {
    for (int i = 0; i < s.nslots && k0 + i * step < s.items; ++i) {
      const Item it = make_item(s, k0 + i * step, x);
      if (it.bulk)
        bulk_load(ring + i * (size_t)slot_elems, x + it.src_off,
                  (uint32_t)(it.count * sizeof(T)), &bars[i]);
    }
  }
  uint32_t parity = 0;  // bit i: the phase slot i waits for next
  int slot = 0;
  for (int k = k0; k < s.items; k += step, slot = s.nslots == 2 ? slot ^ 1 : 0) {
    const Item it = make_item(s, k, x);
    T* in = ring + slot * (size_t)slot_elems;
    if (it.bulk) {
      mbar_wait(&bars[slot], (parity >> slot) & 1u);
      parity ^= 1u << slot;
    } else {
      const T* src = x + it.src_off;
      for (int i = tid; i < it.count; i += nthreads) in[i] = src[i];
      __syncthreads();
    }
    const int c0 = it.p0 % s.C;  // once per item
    const size_t in_plane = (size_t)(it.in_hi - it.in_lo) * s.W;
    const size_t m_plane = (size_t)(it.m_hi - it.m_lo) * s.W;
    conv_stage<T, V>(in, it.in_lo, it.in_hi, in_plane, mid, m_plane, it.m_lo, it.m_hi, it.np,
                     s.W, c0, s.C, zero, params);
    __syncthreads();  // the intermediate is whole; this slot is free
    const int kn = k + s.nslots * step;
    if (tid == 0 && kn < s.items) {
      const Item nx = make_item(s, kn, x);
      if (nx.bulk)
        bulk_load(in, x + nx.src_off, (uint32_t)(nx.count * sizeof(T)), &bars[slot]);
    }
    conv_stage<T, V>(mid, it.m_lo, it.m_hi, m_plane, y + it.p0 * HW + (size_t)it.y0 * s.W, HW,
                     it.y0, it.y0 + it.rows, it.np, s.W, c0, s.C, zero, params + 12);
    __syncthreads();  // the intermediate may be overwritten
  }
}

size_t round_up(size_t v, size_t a) { return (v + a - 1) / a * a; }

// Elements of one ring slot and of the intermediate for a plan.
void buffer_elems(int P, int R, int H, int W, size_t* slot, size_t* mid) {
  *slot = (size_t)P * (size_t)(R + 4 < H ? R + 4 : H) * W;
  *mid = (size_t)P * (size_t)(R + 2 < H ? R + 2 : H) * W;
}

template <typename T, int V>
int launch(const void* x, void* y, const void* params, const Shape& s, int bx, int by, int grid,
           int smem, cudaStream_t stream) {
  size_t slot, mid;
  buffer_elems(s.P, s.R, s.H, s.W, &slot, &mid);
  const size_t slot_al = round_up(slot * sizeof(T), SLOT_ALIGN) / sizeof(T);
  const size_t zero_offset = round_up((s.nslots * slot_al + mid) * sizeof(T), 16);
  const size_t zero_bytes = round_up((size_t)s.W * sizeof(T), 16);
  if (zero_offset + zero_bytes + s.nslots * sizeof(uint64_t) > (size_t)smem)
    return (int)cudaErrorInvalidValue;
  auto kernel = dw_chain_kernel<T, V>;
  static bool attr_set = false;  // the attribute is per kernel; setting it twice is harmless
  if (!attr_set) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kernel<<<grid, dim3(bx, by), smem, stream>>>(static_cast<const T*>(x), static_cast<T*>(y),
                                               static_cast<const float*>(params), s,
                                               (int)slot_al, (int)zero_offset,
                                               (int)zero_bytes);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int occupancy(int threads, int smem, int* blocks) {
  auto kernel = dw_chain_kernel<T, V>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
}

// Runs f<T, V>(...) for dtype (0 = float32, 1 = bfloat16) and vec.
template <template <typename, int> class F, typename... A>
int dispatch(int dtype, int vec, A... a) {
  if (dtype == 0) {
    switch (vec) {
      case 1: return F<float, 1>::run(a...);
      case 2: return F<float, 2>::run(a...);
      case 4: return F<float, 4>::run(a...);
    }
  } else if (dtype == 1) {
    switch (vec) {
      case 1: return F<__nv_bfloat16, 1>::run(a...);
      case 2: return F<__nv_bfloat16, 2>::run(a...);
      case 4: return F<__nv_bfloat16, 4>::run(a...);
      case 8: return F<__nv_bfloat16, 8>::run(a...);
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, int V> struct Launch {
  static int run(const void* x, void* y, const void* p, Shape s, int bx, int by, int grid,
                 int smem, cudaStream_t st) {
    return launch<T, V>(x, y, p, s, bx, by, grid, smem, st);
  }
};

template <typename T, int V> struct Occupancy {
  static int run(int threads, int smem, int* blocks) { return occupancy<T, V>(threads, smem, blocks); }
};

}  // namespace

// Blocks of the kernel for (dtype, vec) that fit on one SM at `threads`
// threads and `smem` bytes of dynamic shared memory. Returns a cudaError_t.
extern "C" int sod_dw_chain_occupancy(int dtype, int vec, int threads, int smem, int* blocks) {
  if (threads < 1 || threads > MAX_THREADS || smem < 0 || smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  return dispatch<Occupancy>(dtype, vec, threads, smem, blocks);
}

// x, y: (N, C, H, W) contiguous; params: (C, 24) float32 contiguous.
// plan: 14 ints, the shape and the launch plan: n, c, h, w, dtype (0 =
// float32, 1 = bfloat16), planes per item P, rows per item R, vector width
// vec, bulk copies on or off, ring slots, block bx x by, grid, dynamic
// shared memory bytes. The plan comes from the caller and is checked here.
// Returns a cudaError_t.
extern "C" int sod_dw_chain(const void* x, void* y, const void* params, const int* plan,
                            void* stream) {
  const int n = plan[0], c = plan[1], h = plan[2], w = plan[3], dtype = plan[4];
  const int planes = plan[5], rows = plan[6], vec = plan[7], bulk = plan[8];
  const int nslots = plan[9], bx = plan[10], by = plan[11], grid = plan[12], smem = plan[13];
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int elt = dtype == 0 ? 4 : 2;
  if (n < 1 || c < 1 || h < 1 || w < 1 || planes < 1 || rows < 1 || rows > h ||
      (planes > 1 && rows != h) || vec < 1 || w % vec != 0 || vec * elt > 16 || bx < 1 ||
      by < 1 || bx * by > MAX_THREADS || smem < 0 || smem > MAX_SMEM || grid < 1 ||
      (nslots != 1 && nslots != 2))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.C = c;
  s.H = h;
  s.W = w;
  const long long total = (long long)n * c;
  const long long groups = (total + planes - 1) / planes;
  const long long nbands = (h + rows - 1) / rows;
  if (total > INT32_MAX || groups * nbands > INT32_MAX || (long long)h * w > INT32_MAX / 8 ||
      grid > groups * nbands)
    return (int)cudaErrorInvalidValue;
  s.planes_total = (int)total;
  s.P = planes;
  s.R = rows;
  s.nbands = (int)nbands;
  s.items = (int)(groups * nbands);
  s.nslots = nslots;
  s.bulk = bulk != 0;
  return dispatch<Launch>(dtype, vec, x, y, params, s, bx, by, grid, smem,
                          static_cast<cudaStream_t>(stream));
}
