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
// (369 MB in bf16) and does 2.2 to 44 GFLOP, so it is bound by bytes
// (~0.11-0.13 ms at 3.35 TB/s); the FLOPs would take ~0.045 ms on the bf16
// tensor cores at C=120.  The TPU grid (E, C/bc, F/bf, D/bd), whose
// innermost axis carries an accumulator in VMEM, becomes one block per
// output tile with a loop over D inside it, so nothing carries between
// blocks and every output element has one writer (no atomics).
//
// Two routes, chosen by dtype in the C entry point (a route by dtype, not a
// fallback: every bf16 call takes the first, every f32 call the second):
//
// bf16: tensor cores fed by asynchronous copies.  One block of 8 warps per
//   (128-column F tile, expert) covers up to 128 rows of C, so each weight
//   byte is read from HBM once a call while C <= 128 (a loop over 128-row C
//   tiles takes over past that).  Each 64-deep D step stages a 128 x 64
//   tile of x and a 64 x 128 tile of w in a ring of 3 stages in shared
//   memory by 16-byte `cp.async`, two steps in flight while one computes
//   (half the barriers of 32-deep steps, and 2 blocks of 8 warps still fit
//   an SM); rows are padded by 16 bytes so that `ldmatrix` reads are free
//   of bank conflicts.  The warps tile the output 2 x 4, 64 x 32 each, with
//   `mma.sync` m16n8k16 (bf16 in, f32 sums); x's fragments come through
//   `ldmatrix`, w's (D, F) row-major tile through `ldmatrix.trans`.  A warp
//   skips the 16-row groups that lie wholly past C (a decode queue of 32
//   rows runs 2 of 8).  Ragged edges: copies past D, F or C are zero-filled
//   (a 16-byte copy reads only its valid bytes); an input whose rows do not
//   start on 16 bytes is staged by scalar loads into the same tiles.
//
// f32: the first, SIMT version, kept as it was: TF32 tensor cores (a 10-bit
//   mantissa) would break the f32 tolerance of 1e-4 that the tests hold.
//   One block of 256 threads per (64-column F tile, 64-row C tile, expert);
//   each D step stages a 64 x 32 tile of x (transposed) and a 32 x 64 tile
//   of w as f32, and each thread keeps a 4 x 4 register tile.
//
// In both, a row's result does not depend on C or on the other rows, bit
// for bit: one tile configuration for every shape, no split of D, and
// every output element summed over D in the same order.  Inputs are read
// through their strides (the bf16 route wants D and F contiguous: the
// wrapper makes a contiguous copy otherwise); the output is contiguous.
// No fast-math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

struct Args {
  const void* x;  // (E, C, D)
  const void* w;  // (E, D, F)
  void* out;      // (E, C, F) contiguous, x's dtype
  int C, D, F;
  long long x_se, x_sc, x_sd;
  long long w_se, w_sd, w_sf;
};

// ---------------------------------------------------------------- f32, SIMT
constexpr int BC = 64;  // output rows (tokens) per block
constexpr int BF = 64;  // output columns per block
constexpr int BD = 32;  // contraction depth per staged tile
constexpr int THREADS = 256;  // 16 x 16 threads, a 4 x 4 output tile each
constexpr int PAD = 4;  // keeps shared rows 16-byte aligned, spreads banks

__global__ void __launch_bounds__(THREADS) gmm_kernel(Args a) {
  __shared__ __align__(16) float xs[BD][BC + PAD];  // x tile transposed: xs[d][c]
  __shared__ __align__(16) float ws[BD][BF + PAD];  // w tile: ws[d][f]

  const int tid = threadIdx.x;
  const int f_base = blockIdx.x * BF, c_base = blockIdx.y * BC;
  const long long e = blockIdx.z;
  const float* xp = static_cast<const float*>(a.x) + e * a.x_se;
  const float* wp = static_cast<const float*>(a.w) + e * a.w_se;
  const int c0 = (tid / 16) * 4, f0 = (tid % 16) * 4;
  const bool live = c_base + c0 < a.C && f_base + f0 < a.F;

  float acc[4][4] = {};
  for (int d_base = 0; d_base < a.D; d_base += BD) {
    // stage the tiles, zero past the edges: consecutive threads read
    // consecutive d of x and consecutive f of w
    for (int i = tid; i < BC * BD; i += THREADS) {
      const int c = i / BD, d = i % BD;
      const int gc = c_base + c, gd = d_base + d;
      xs[d][c] = (gc < a.C && gd < a.D) ? xp[gc * a.x_sc + gd * a.x_sd] : 0.f;
    }
    for (int i = tid; i < BD * BF; i += THREADS) {
      const int d = i / BF, f = i % BF;
      const int gd = d_base + d, gf = f_base + f;
      ws[d][f] = (gd < a.D && gf < a.F) ? wp[gd * a.w_sd + gf * a.w_sf] : 0.f;
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
  float* op = static_cast<float*>(a.out) + e * a.C * a.F;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int gc = c_base + c0 + r;
    if (gc >= a.C) break;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int gf = f_base + f0 + s;
      if (gf < a.F) op[(long long)gc * a.F + gf] = acc[r][s];
    }
  }
}

// ------------------------------------------------------ bf16, tensor cores
constexpr int TC_BC = 128;  // output rows per C tile
constexpr int TC_BF = 128;  // output columns per block
constexpr int TC_BD = 64;   // contraction depth per stage
constexpr int TC_STAGES = 3;
constexpr int TC_THREADS = 256;  // 8 warps: 2 (C) x 4 (F), a 64 x 32 tile each
constexpr int XLD = TC_BD + 8;   // padded row of the x tile, bf16 elements
constexpr int WLD = TC_BF + 8;   // padded row of the w tile
constexpr int X_STAGE = TC_BC * XLD;
constexpr int W_STAGE = TC_BD * WLD;
constexpr int TC_SMEM = TC_STAGES * (X_STAGE + W_STAGE) * 2;  // 107,520 bytes: 2 blocks an SM

// One 16-byte piece (8 elements along the contiguous dim) of a tile, of
// which the first `n` (0..8) lie inside the matrix; the rest are zero.
// Aligned inputs take a zero-filling `cp.async` (`base` stands in for the
// source when n is 0); others scalar loads.
__device__ __forceinline__ void stage_piece(__nv_bfloat16* dst, const __nv_bfloat16* src, int n, bool aligned,
                                            const __nv_bfloat16* base) {
  if (aligned) {
    tc::cp_async_16(dst, n > 0 ? src : base, 2 * n);
    return;
  }
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = j < n ? src[j] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

__global__ void __launch_bounds__(TC_THREADS, 2) gmm_kernel_tc(Args a, bool aligned) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // TC_STAGES x [TC_BC][XLD]
  __nv_bfloat16* ws = xs + TC_STAGES * X_STAGE;                      // TC_STAGES x [TC_BD][WLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // this warp's 64 x 32 tile: rows wm * 64, cols wn * 32
  const int f_base = blockIdx.x * TC_BF;
  const long long e = blockIdx.y;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(a.x) + e * a.x_se;
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(a.w) + e * a.w_se;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.out) + e * a.C * a.F;
  const int n_k = (a.D + TC_BD - 1) / TC_BD;

  for (int c_base = 0; c_base < a.C; c_base += TC_BC) {
    const int rows = min(TC_BC, a.C - c_base);
    const int rows16 = (rows + 15) / 16 * 16;  // rows of x any warp reads

    auto load_stage = [&](int stage, int kt) {
      const int d0 = kt * TC_BD;
      __nv_bfloat16* xd = xs + stage * X_STAGE;
      __nv_bfloat16* wd = ws + stage * W_STAGE;
      for (int i = tid; i < TC_BC * (TC_BD / 8); i += TC_THREADS) {
        const int r = i / (TC_BD / 8), c = (i % (TC_BD / 8)) * 8;
        if (r >= rows16) break;
        const int n = r < rows ? min(max(a.D - d0 - c, 0), 8) : 0;
        stage_piece(xd + r * XLD + c, xp + (c_base + r) * a.x_sc + d0 + c, n, aligned, xp);
      }
      for (int i = tid; i < TC_BD * (TC_BF / 8); i += TC_THREADS) {
        const int r = i / (TC_BF / 8), c = (i % (TC_BF / 8)) * 8;
        const int n = d0 + r < a.D ? min(max(a.F - f_base - c, 0), 8) : 0;
        stage_piece(wd + r * WLD + c, wp + (d0 + r) * a.w_sd + f_base + c, n, aligned, wp);
      }
    };

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) acc[mi][nj][0] = acc[mi][nj][1] = acc[mi][nj][2] = acc[mi][nj][3] = 0.f;

#pragma unroll
    for (int st = 0; st < TC_STAGES - 1; ++st) {
      if (st < n_k) load_stage(st, st);
      tc::cp_async_commit();
    }
    for (int kt = 0; kt < n_k; ++kt) {
      tc::cp_async_wait<TC_STAGES - 2>();  // step kt has landed
      __syncthreads();  // ... for every thread, and step kt - 1's stage is consumed
      if (kt + TC_STAGES - 1 < n_k) load_stage((kt + TC_STAGES - 1) % TC_STAGES, kt + TC_STAGES - 1);
      tc::cp_async_commit();
      if (wm * 64 >= rows) continue;
      const __nv_bfloat16* xt = xs + (kt % TC_STAGES) * X_STAGE;
      const __nv_bfloat16* wt = ws + (kt % TC_STAGES) * W_STAGE;
#pragma unroll
      for (int kk = 0; kk < TC_BD / 16; ++kk) {
        uint32_t bfr[2][4];  // w's fragments: n-tiles 2 np and 2 np + 1 of this warp
#pragma unroll
        for (int np = 0; np < 2; ++np)
          tc::ldmatrix_x4_trans(bfr[np], wt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * WLD + wn * 32 +
                                             np * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if (wm * 64 + mi * 16 >= rows) break;  // 16-row groups wholly past C
          uint32_t af[4];
          tc::ldmatrix_x4(af, xt + (wm * 64 + mi * 16 + (lane & 15)) * XLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int nj = 0; nj < 4; ++nj)
            tc::mma_bf16_16816(acc[mi][nj], af, bfr[nj / 2][(nj & 1) * 2], bfr[nj / 2][(nj & 1) * 2 + 1]);
        }
      }
    }
    tc::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring before the next C tile refills it

    if (wm * 64 >= rows) continue;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 64 + mi * 16 + g + 8 * half;
        if (r >= rows) continue;
        __nv_bfloat16* orow = op + (long long)(c_base + r) * a.F;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int col = f_base + wn * 32 + nj * 8 + 2 * t4;
          const float v0 = acc[mi][nj][2 * half], v1 = acc[mi][nj][2 * half + 1];
          if (a.F % 2 == 0 && col + 1 < a.F) {
            *reinterpret_cast<uint32_t*>(orow + col) = tc::pack_bf16x2(v0, v1);
          } else {
            if (col < a.F) orow[col] = __float2bfloat16_rn(v0);
            if (col + 1 < a.F) orow[col + 1] = __float2bfloat16_rn(v1);
          }
        }
      }
    }
  }
}

// a stride that the 16-byte copies can take: a multiple of 8 elements,
// or that of a dim of size 1 (never stepped)
bool copy_stride(long long stride, int size) { return size <= 1 || stride % 8 == 0; }

int launch_f32(const Args& a, int E, cudaStream_t stream) {
  dim3 grid((a.F + BF - 1) / BF, (a.C + BC - 1) / BC, E);
  gmm_kernel<<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_bf16(const Args& a, int E, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gmm_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, TC_SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = reinterpret_cast<uintptr_t>(a.x) % 16 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0 &&
                       copy_stride(a.x_se, E) && copy_stride(a.x_sc, a.C) && copy_stride(a.w_se, E) &&
                       copy_stride(a.w_sd, a.D);
  dim3 grid((a.F + TC_BF - 1) / TC_BF, E);
  gmm_kernel_tc<<<grid, TC_THREADS, TC_SMEM, stream>>>(a, aligned);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype (of x, w and out): 0 = float32, 1 = bfloat16.  Strides are in
// elements; the last dims of x and w (D and F) must be contiguous.
// Returns 0, cudaGetLastError() of the launch, or -1 for an unknown dtype
// or a layout the kernel does not take.
extern "C" int repro_gmm_fwd(
    const void* x, const void* w, void* out, int dtype, int E, int C, int D, int F,
    long long x_se, long long x_sc, long long x_sd,
    long long w_se, long long w_sd, long long w_sf, void* stream) {
  Args a{x, w, out, C, D, F, x_se, x_sc, x_sd, w_se, w_sd, w_sf};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((x_sd != 1 && D > 1) || (w_sf != 1 && F > 1)) return -1;
  if (dtype == 0) return launch_f32(a, E, st);
  if (dtype == 1) return launch_bf16(a, E, st);
  return -1;
}
