// Mamba2 SSD intra-chunk block for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`, launched by
// `ssd_chunk_kernel` in src/repro/kernels/ssd_scan.py.  Same function, per
// (batch, head, chunk) of Q steps, all arithmetic in f32:
//   acs      = cumsum(a_dt)                                  (Q)
//   L[i,j]   = exp(acs_i - acs_j) for j <= i, else 0          (Q x Q)
//   y_diag   = ((C . B^T) * L) . X                            (Q x P, x's dtype)
//   state    = X^T . (B * exp(acs_last - acs))                (P x N, f32)
// B/C groups are resolved by index (head h reads group h / (H/G)); the
// broadcast never exists in memory.
//
// What bounds it on an H100: at mamba2-130m's prefill shape (Q=64, P=64,
// N=128, 24 heads, S=1024, bf16) one call moves ~19 MB, most of it the f32
// chunk states, and does ~0.7 GFLOP, so a fast kernel is bound by bytes
// (~6 us at 3.35 TB/s).  This first version is right and simple, not fast:
// it uses no tensor cores and no TMA.  One block of 256 threads per
// (chunk, head, batch) replaces the TPU grid cell (blocks run in any order:
// nothing carries between them).  The chunk's b, c and x tiles are staged
// in shared memory as f32 (b and c transposed, N x Q, so a thread's four
// columns are one 16-byte read); each thread then owns a 4 x 4 register
// tile of one product at a time: C.B^T (only on and below the diagonal,
// the TPU kernel computes all of it), the masked decay, (C.B^T * L).X
// (its loop stops at the diagonal) and the state product.  After C.B^T, the
// shared c tile is reused for the decay-weighted b.  Shared memory holds up
// to ~168 KB (Q=128, P=64, N=64), above the 48 KB default, so the caller
// opts in to it once per size (repro_ssd_chunk_opt_in).  Q, P and N are
// run-time sizes (multiples of 4, Q <= 128), so one instantiation per
// dtype serves every configuration and the build
// stays short.  No fast-math: expf is the accurate one.  Inputs are read
// through their strides (the model passes transposed views, no copies);
// outputs are contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PAD = 4;  // keeps transposed rows 16-byte aligned, spreads banks

struct Args {
  const float* a;  // (B, H, nc, Q) f32
  const void* x;   // (B, H, nc, Q, P)
  const void* b;   // (B, G, nc, Q, N)
  const void* c;   // (B, G, nc, Q, N)
  void* y;         // (B, H, nc, Q, P) contiguous, x's dtype
  float* st;       // (B, H, nc, P, N) contiguous, f32
  int H, G, nc, Q, P, N;
  long long a_sb, a_sh, a_sc, a_sq;
  long long x_sb, x_sh, x_sc, x_sq;
  long long b_sb, b_sg, b_sc, b_sq;
  long long c_sb, c_sg, c_sc, c_sq;
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

__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  const size_t qs = Q + PAD;
  return (size_t)Q + 2 * (size_t)N * qs + (size_t)Q * P + (size_t)Q * qs;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, P = a.P, N = a.N;
  const int QS = Q + PAD;
  float* acs = smem;              // Q
  float* bT = acs + Q;            // N x QS: b transposed
  float* cT = bT + N * QS;        // N x QS: c transposed; later Q x N decay-weighted b
  float* xs = cT + N * QS;        // Q x P
  float* gT = xs + Q * P;         // Q x QS: (C.B^T * L) transposed, gT[j][i]

  const int tid = threadIdx.x;
  const int ch = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int g = h / (a.H / a.G);

  const float* ap = a.a + bi * a.a_sb + h * a.a_sh + ch * a.a_sc;
  const T* xp = static_cast<const T*>(a.x) + bi * a.x_sb + h * a.x_sh + ch * a.x_sc;
  const T* bp = static_cast<const T*>(a.b) + bi * a.b_sb + g * a.b_sg + ch * a.b_sc;
  const T* cp = static_cast<const T*>(a.c) + bi * a.c_sb + g * a.c_sg + ch * a.c_sc;
  const long long cell = ((long long)bi * a.H + h) * a.nc + ch;
  T* yp = static_cast<T*>(a.y) + cell * Q * P;
  float* sp = a.st + cell * P * N;

  // stage the tiles: consecutive threads read consecutive p / n
  for (int i = tid; i < Q * P; i += THREADS) {
    const int q = i / P, p = i % P;
    xs[i] = to_f32(xp[q * a.x_sq + p]);
  }
  for (int i = tid; i < Q * N; i += THREADS) {
    const int q = i / N, n = i % N;
    bT[n * QS + q] = to_f32(bp[q * a.b_sq + n]);
    cT[n * QS + q] = to_f32(cp[q * a.c_sq + n]);
  }
  // acs = cumsum(a_dt) by warp 0: each lane sums up to 4 consecutive steps,
  // then an inclusive scan of the lane totals over the warp
  if (tid < 32) {
    const int per = (Q + 31) / 32;
    float loc[4];
    float run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tid * per + k;
      if (k < per && q < Q) run += ap[q * a.a_sq];
      loc[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl += t;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = tid * per + k;
      if (k < per && q < Q) acs[q] = loc[k] + excl;
    }
  }
  __syncthreads();

  // 1. G = (C.B^T) * L in 4 x 4 tiles, rows i (queries) by columns j (keys);
  //    tiles wholly above the diagonal are never read, so never computed
  const int QT = Q / 4;
  for (int t = tid; t < QT * QT; t += THREADS) {
    const int i0 = (t / QT) * 4, j0 = (t % QT) * 4;
    if (j0 > i0 + 3) continue;
    float acc[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(cT + n * QS + i0);
      const float4 bv = *reinterpret_cast<const float4*>(bT + n * QS + j0);
      const float ci[4] = {cv.x, cv.y, cv.z, cv.w};
      const float bj[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(ci[r], bj[s], acc[r][s]);
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j0 + s;
      float4 out;
      float* o = reinterpret_cast<float*>(&out);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        o[r] = j <= i ? acc[r][s] * expf(acs[i] - acs[j]) : 0.f;
      }
      *reinterpret_cast<float4*>(gT + j * QS + i0) = out;
    }
  }
  __syncthreads();

  // the c tile is spent: reuse it for b weighted by the decay to the chunk's end
  float* bw = cT;  // Q x N
  const float acs_last = acs[Q - 1];
  for (int i = tid; i < Q * N; i += THREADS) {
    const int q = i / N, n = i % N;
    bw[i] = to_f32(bp[q * a.b_sq + n]) * expf(acs_last - acs[q]);
  }

  // 2. y_diag = G . X in 4 x 4 tiles of (Q x P); the loop stops at the diagonal
  const int PT = P / 4;
  for (int t = tid; t < QT * PT; t += THREADS) {
    const int i0 = (t / PT) * 4, p0 = (t % PT) * 4;
    float acc[4][4] = {};
    for (int j = 0; j <= i0 + 3; ++j) {
      const float4 gv = *reinterpret_cast<const float4*>(gT + j * QS + i0);
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
      const float gi[4] = {gv.x, gv.y, gv.z, gv.w};
      const float xp4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(gi[r], xp4[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) yp[(i0 + r) * P + p0 + s] = from_f32<T>(acc[r][s]);
  }
  __syncthreads();  // bw is complete

  // 3. state = X^T . bw in 4 x 4 tiles of (P x N)
  const int NT = N / 4;
  for (int t = tid; t < PT * NT; t += THREADS) {
    const int p0 = (t / NT) * 4, n0 = (t % NT) * 4;
    float acc[4][4] = {};
#pragma unroll 4
    for (int j = 0; j < Q; ++j) {
      const float4 xv = *reinterpret_cast<const float4*>(xs + j * P + p0);
      const float4 bv = *reinterpret_cast<const float4*>(bw + j * N + n0);
      const float xp4[4] = {xv.x, xv.y, xv.z, xv.w};
      const float bn[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(xp4[r], bn[s], acc[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(sp + (p0 + r) * N + n0) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.Q, a.P, a.N);
  dim3 grid(a.nc, a.H, B);
  ssd_chunk_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block needs at (Q, P, N).
extern "C" long long repro_ssd_chunk_smem_bytes(int Q, int P, int N) {
  return (long long)(sizeof(float) * smem_floats(Q, P, N));
}

// Opts the kernel of `dtype` on the current device in to `bytes` of dynamic
// shared memory (above the 48 KB default); a launch needing more than the
// last opt-in fails with cudaErrorInvalidValue.  Returns the CUDA error, or
// -1 for an unknown dtype.
extern "C" int repro_ssd_chunk_opt_in(int dtype, int bytes) {
  if (dtype == 0)
    return (int)cudaFuncSetAttribute(
        ssd_chunk_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (dtype == 1)
    return (int)cudaFuncSetAttribute(
        ssd_chunk_kernel<__nv_bfloat16>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  return -1;
}

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; a_dt is float32.
// Strides are in elements, for the leading four dims of each input; the
// last dim of x, b and c must be contiguous.  Returns 0,
// cudaGetLastError() of the launch, or -1 for an unknown dtype.
extern "C" int repro_ssd_chunk_fwd(
    const void* a_dt, const void* x, const void* b, const void* c, void* y, void* states,
    int dtype, int B, int H, int G, int nc, int Q, int P, int N,
    long long a_sb, long long a_sh, long long a_sc, long long a_sq,
    long long x_sb, long long x_sh, long long x_sc, long long x_sq,
    long long b_sb, long long b_sg, long long b_sc, long long b_sq,
    long long c_sb, long long c_sg, long long c_sc, long long c_sq, void* stream) {
  Args a{static_cast<const float*>(a_dt), x, b, c, y, static_cast<float*>(states),
         H, G, nc, Q, P, N,
         a_sb, a_sh, a_sc, a_sq, x_sb, x_sh, x_sc, x_sq,
         b_sb, b_sg, b_sc, b_sq, c_sb, c_sg, c_sc, c_sq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, B, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, B, st);
  return -1;
}
