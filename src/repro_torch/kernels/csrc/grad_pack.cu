// Fused error-feedback add + per-leaf int8 quantize + pack for Hopper
// (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_pack_kernel`, launched by `_pallas_pack`
// in src/repro/kernels/grad_pack.py.  Same function, on the flat f32 buffers
// that the wrapper builds (every leaf zero-padded to TILE = 1024 elements,
// `seg[t]` the leaf of tile t):
//   x      = g + ef
//   maxabs = max |x| over each leaf's tiles
//   scale  = max(maxabs, f32(1e-12)) * f32(1/127)
//   r      = x / scale
//   q      = clip(round_half_even(r), -127, 127) as int8
//   ef_new = (r - q) * scale
// with q written straight into the KIND_Q8 wire body (behind the u32 offset
// table that the wrapper copies in) and the per-leaf scales in front of it.
//
// The contract is bit-identical bytes with the numpy host reference
// `pack_grads_q8` (src/repro_torch/train/grad_sync.py).  Every rounding step
// is spelled out: __fadd_rn, __fdiv_rn, __fsub_rn, __fmul_rn cannot be
// contracted into an FMA or replaced by an approximate division whatever the
// compiler flags (the build uses -O3 and no fast-math), and rintf rounds half
// to even as numpy's round does.  The max is exact in any order.
//
// What bounds it on an H100: a pass over memory.  Each element is read as g
// and ef (8 bytes) and written as q and the new ef (5 bytes): 13 bytes, so a
// 1.1 B-element tree (tinyllama-1.1b) moves 14.3 GB, 4.3 ms at 3.35 TB/s.
// The design does not meet that yet: it makes two passes (below), reading g
// and ef twice, 21 bytes an element.
//
// The TPU runs a sequential grid (phase 0 over all tiles, then phase 1) and
// keeps the per-leaf max in scratch between grid steps.  Blocks on Hopper
// share nothing and run in no order, so the cross-block max is its own
// launch:
//   1. max_kernel: each block walks a contiguous range of tiles, 4 elements a
//      thread per tile (one float4 load each of g and ef, neighbouring
//      threads on neighbouring 16 bytes), keeping a running max.  Where the
//      leaf changes (the same tile for every thread, so the branch is
//      uniform) and at the end, each warp reduces its max with shuffles and
//      lane 0 folds it into maxabs[leaf] with atomicMax on the unsigned bit
//      pattern: for non-negative floats that order is the float order, so
//      the result is exact and independent of the order of the atomics.
//      maxabs is zeroed first (cudaMemsetAsync).
//   2. quant_kernel: one block per tile, 4 elements a thread; reads its
//      leaf's maxabs, computes the scale, quantizes, writes 4 int8 (one
//      char4) and 4 f32 of ef.  Threads of the grid also write the scales.
//
// Non-finite inputs (bit parity is held on finite gradients only): the
// running max uses fmaxf, which skips NaN, so a NaN element does not reach
// its leaf's scale, while the host's np.max propagates it; a NaN r clamps to
// -127 here, and on the host becomes whatever numpy's NaN-to-int8 cast
// gives.  An infinite element makes its leaf's scale infinite in both, and
// then every element's new ef is NaN (0 * inf) in both.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 1024;
constexpr int THREADS = 256;  // TILE / 4: one float4 of a tile a thread
static_assert(TILE == 4 * THREADS, "a block covers one tile, 4 elements a thread");
constexpr int MAX_BLOCKS = 132 * 8;  // launch 1: 8 blocks an SM
constexpr float RECIP127 = 0x1.020408p-7f;  // f32(1) / f32(127), as grad_sync._F32_RECIP127
constexpr float EPS = 0x1.197998p-40f;      // f32(1e-12)

__device__ __forceinline__ float absadd(float a, float b) { return fabsf(__fadd_rn(a, b)); }

__device__ __forceinline__ void flush_max(float m, int leaf, unsigned* maxabs) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) atomicMax(maxabs + leaf, __float_as_uint(m));
}

__global__ void __launch_bounds__(THREADS) max_kernel(
    const float4* __restrict__ g, const float4* __restrict__ ef, const int* __restrict__ seg,
    unsigned* __restrict__ maxabs, long long n_tiles, long long tiles_per_block) {
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  const long long t1 = t0 + tiles_per_block < n_tiles ? t0 + tiles_per_block : n_tiles;
  if (t0 >= t1) return;
  int leaf = seg[t0];
  float m = 0.f;
  for (long long t = t0; t < t1; ++t) {
    const int s = seg[t];
    if (s != leaf) {  // uniform across the block
      flush_max(m, leaf, maxabs);
      m = 0.f;
      leaf = s;
    }
    const long long i = t * THREADS + threadIdx.x;
    const float4 a = g[i], b = ef[i];
    m = fmaxf(m, fmaxf(fmaxf(absadd(a.x, b.x), absadd(a.y, b.y)), fmaxf(absadd(a.z, b.z), absadd(a.w, b.w))));
  }
  flush_max(m, leaf, maxabs);
}

__device__ __forceinline__ float scale_of(unsigned bits) {
  return __fmul_rn(fmaxf(__uint_as_float(bits), EPS), RECIP127);
}

__device__ __forceinline__ signed char quant(float x, float scale, float& ef_new) {
  const float r = __fdiv_rn(x, scale);
  const float q = fminf(fmaxf(rintf(r), -127.f), 127.f);
  ef_new = __fmul_rn(__fsub_rn(r, q), scale);
  return (signed char)(int)q;
}

__global__ void __launch_bounds__(THREADS) quant_kernel(
    const float4* __restrict__ g, const float4* __restrict__ ef, const int* __restrict__ seg,
    const unsigned* __restrict__ maxabs, float* __restrict__ scales, char4* __restrict__ payload,
    float4* __restrict__ ef_out, int n_leaves) {
  const long long t = blockIdx.x;
  const long long gid = t * THREADS + threadIdx.x;
  for (long long j = gid; j < n_leaves; j += (long long)gridDim.x * THREADS) scales[j] = scale_of(maxabs[j]);
  const float scale = scale_of(maxabs[seg[t]]);
  const float4 a = g[gid], b = ef[gid];
  float4 e;
  char4 q;
  q.x = quant(__fadd_rn(a.x, b.x), scale, e.x);
  q.y = quant(__fadd_rn(a.y, b.y), scale, e.y);
  q.z = quant(__fadd_rn(a.z, b.z), scale, e.z);
  q.w = quant(__fadd_rn(a.w, b.w), scale, e.w);
  payload[gid] = q;
  ef_out[gid] = e;
}

}  // namespace

// g, ef, ef_out: (n_tiles, 1024) f32, contiguous, 16-byte aligned.  seg:
// (n_tiles,) int32 leaf of each tile.  maxabs: n_leaves u32 of scratch.
// body: the wire body behind the header, 8 * n_leaves + 1024 * n_tiles bytes,
// 4-byte aligned; the kernel writes the scales at body + 4 * n_leaves and the
// payload at body + 8 * n_leaves (the offset table before them is the
// caller's).  Returns 0 or the first CUDA error of the memset and the two
// launches.
extern "C" int repro_grad_pack(
    const void* g, const void* ef, const int* seg, void* maxabs, void* body, void* ef_out,
    long long n_tiles, int n_leaves, void* stream) {
  if (n_tiles <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = (int)cudaMemsetAsync(maxabs, 0, sizeof(unsigned) * (size_t)n_leaves, st);
  if (rc != 0) return rc;
  const long long blocks1 = n_tiles < MAX_BLOCKS ? n_tiles : MAX_BLOCKS;
  const long long per_block = (n_tiles + blocks1 - 1) / blocks1;
  max_kernel<<<(unsigned)blocks1, THREADS, 0, st>>>(
      static_cast<const float4*>(g), static_cast<const float4*>(ef), seg, static_cast<unsigned*>(maxabs),
      n_tiles, per_block);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  unsigned char* b = static_cast<unsigned char*>(body);
  quant_kernel<<<(unsigned)n_tiles, THREADS, 0, st>>>(
      static_cast<const float4*>(g), static_cast<const float4*>(ef), seg, static_cast<const unsigned*>(maxabs),
      reinterpret_cast<float*>(b + 4LL * n_leaves), reinterpret_cast<char4*>(b + 8LL * n_leaves),
      static_cast<float4*>(ef_out), n_leaves);
  return (int)cudaGetLastError();
}
