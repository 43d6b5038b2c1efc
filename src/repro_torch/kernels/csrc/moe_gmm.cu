// Grouped (per-expert) matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_gmm_kernel`, launched by `grouped_matmul`
// in src/repro/kernels/moe_gmm.py.  Same function: every expert's token
// queue against its own weight matrix,
//   out[e] = x[e] . w[e]        x (E, C, D), w (E, D, F) -> out (E, C, F),
// accumulated in f32 and cast once to x's dtype.
//
// What bounds it on an H100: at deepseek-moe-16b's shapes (E=64 experts,
// D=2048, F=1408, C=120 tokens a queue in a 1024-token prefill, C=32 in a
// decode step of 8 slots) each call reads all E weight matrices once
// (369 MB in bf16) and does 2.2 to 44 GFLOP, so a fast kernel is bound by
// bytes (~0.11-0.13 ms at 3.35 TB/s); the FLOPs would take ~0.045 ms on the
// bf16 tensor cores at C=120.  This first version is right and simple, not
// fast: it uses no tensor cores and no TMA.  The TPU grid (E, C/bc, F/bf,
// D/bd), whose innermost axis carries an accumulator in VMEM, becomes one
// block of 256 threads per (F tile, C tile, expert) with a loop over D
// tiles inside it, so nothing carries between blocks.  Each D step stages a
// 64 x 32 tile of x (transposed, so a thread's four rows are one 16-byte
// read) and a 32 x 64 tile of w in shared memory as f32; each thread keeps
// a 4 x 4 tile of the 64 x 64 output tile in f32 registers and writes it
// once, cast to the output dtype.  No atomics: every output element has one
// writer, and its sum runs over d in order, so a row's result does not
// depend on C or on the other rows.  Any C, D and F: the staging loads zero
// past each edge and the write is masked (the TPU kernel asks that its
// blocks divide the shapes).  Threads whose rows all lie past C skip the
// products (a decode queue of 32 rows leaves half the warps idle).  Inputs
// are read through their strides (element strides of all three dims);
// the output is contiguous.  No fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BC = 64;  // output rows (tokens) per block
constexpr int BF = 64;  // output columns per block
constexpr int BD = 32;  // contraction depth per staged tile
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 output tile each
constexpr int PAD = 4;  // keeps shared rows 16-byte aligned, spreads banks

struct Args {
  const void* x;  // (E, C, D)
  const void* w;  // (E, D, F)
  void* out;      // (E, C, F) contiguous, x's dtype
  int C, D, F;
  long long x_se, x_sc, x_sd;
  long long w_se, w_sd, w_sf;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) gmm_kernel(Args a) {
  __shared__ __align__(16) float xs[BD][BC + PAD];  // x tile transposed: xs[d][c]
  __shared__ __align__(16) float ws[BD][BF + PAD];  // w tile: ws[d][f]

  const int tid = threadIdx.x;
  const int f_base = blockIdx.x * BF, c_base = blockIdx.y * BC;
  const long long e = blockIdx.z;
  const T* xp = static_cast<const T*>(a.x) + e * a.x_se;
  const T* wp = static_cast<const T*>(a.w) + e * a.w_se;
  const int c0 = (tid / 16) * 4, f0 = (tid % 16) * 4;
  const bool live = c_base + c0 < a.C && f_base + f0 < a.F;

  float acc[4][4] = {};
  for (int d_base = 0; d_base < a.D; d_base += BD) {
    // stage the tiles, zero past the edges: consecutive threads read
    // consecutive d of x and consecutive f of w
    for (int i = tid; i < BC * BD; i += THREADS) {
      const int c = i / BD, d = i % BD;
      const int gc = c_base + c, gd = d_base + d;
      xs[d][c] = (gc < a.C && gd < a.D) ? to_f32(xp[gc * a.x_sc + gd * a.x_sd]) : 0.f;
    }
    for (int i = tid; i < BD * BF; i += THREADS) {
      const int d = i / BF, f = i % BF;
      const int gd = d_base + d, gf = f_base + f;
      ws[d][f] = (gd < a.D && gf < a.F) ? to_f32(wp[gd * a.w_sd + gf * a.w_sf]) : 0.f;
    }
    __syncthreads();
    if (live) {
#pragma unroll 8
      for (int d = 0; d < BD; ++d) {
        const float4 xv = *reinterpret_cast<const float4*>(&xs[d][c0]);
        const float4 wv = *reinterpret_cast<const float4*>(&ws[d][f0]);
        const float xr[4] = {xv.x, xv.y, xv.z, xv.w};
        const float wc[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(xr[r], wc[s], acc[r][s]);
      }
    }
    __syncthreads();
  }

  if (!live) return;
  T* op = static_cast<T*>(a.out) + e * a.C * a.F;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gc = c_base + c0 + r;
    if (gc >= a.C) break;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gf = f_base + f0 + s;
      if (gf < a.F) op[(long long)gc * a.F + gf] = from_f32<T>(acc[r][s]);
    }
  }
}

template <typename T>
int launch(const Args& a, int E, cudaStream_t stream) {
  dim3 grid((a.F + BF - 1) / BF, (a.C + BC - 1) / BC, E);
  gmm_kernel<T><<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, w and out): 0 = float32, 1 = bfloat16.  Strides are in
// elements.  Returns 0, cudaGetLastError() of the launch, or -1 for an
// unknown dtype.
extern "C" int repro_gmm_fwd(
    const void* x, const void* w, void* out, int dtype, int E, int C, int D, int F,
    long long x_se, long long x_sc, long long x_sd,
    long long w_se, long long w_sd, long long w_sf, void* stream) {
  Args a{x, w, out, C, D, F, x_se, x_sc, x_sd, w_se, w_sd, w_sf};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, E, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, E, st);
  return -1;
}
