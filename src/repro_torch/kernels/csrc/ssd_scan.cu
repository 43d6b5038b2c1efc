// Mamba2 SSD intra-chunk block for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_ssd_kernel`, launched by
// `ssd_chunk_kernel` in src/repro/kernels/ssd_scan.py.  Same function, per
// (batch, head, chunk) of Q steps:
//   acs      = cumsum(a_dt)                                  (Q, f32)
//   L[i,j]   = exp(acs_i - acs_j) for j <= i, else 0          (Q x Q)
//   y_diag   = ((C . B^T) * L) . X                            (Q x P, x's dtype)
//   state    = X^T . (B * exp(acs_last - acs))                (P x N, f32)
// B/C groups are resolved by index (head h reads group h / (H/G)); the
// broadcast never exists in memory.
//
// What bounds it on an H100: at mamba2-130m's prefill shape (Q=64, P=64,
// N=128, 24 heads, S=1024, bf16) one call moves ~19.5 MB, 12.6 MB of it
// the f32 chunk states it writes, and does ~0.7 GFLOP, so a fast kernel is
// bound by bytes (~6 us at 3.35 TB/s).
//
// Two routes, chosen by dtype in the C entry point (a route by dtype, not a
// fallback: every bf16 call takes the first, every f32 call the second):
//
// bf16: the tensor cores.  One block of 4 warps per (chunk, group, slice of
//   the group's heads, batch); the wrapper sizes the slice from the grid,
//   so that the blocks still fill the card in one wave.  The chunk's C and
//   B are staged once as bf16 in shared memory by 16-byte `cp.async` (rows
//   padded by 16 bytes, so the 8 row addresses of every `ldmatrix` fall in
//   distinct bank groups; rows that sit off 16 bytes take scalar loads
//   into the same tiles, zeros past Q, P and N either way).  S = C . B^T is
//   computed once for all the slice's heads, on `mma.sync` m16n8k16 (bf16
//   in, f32 sums; C and B are bf16, so every product is exact), only on the
//   16 x 16 tiles on and below the diagonal, and kept in shared memory as
//   the f32 accumulator fragments themselves.  Then, per head, with the
//   next head's X and a_dt loading meanwhile:
//   - y = (S * L) . X: each warp turns its rows' S fragments, times L (by
//     `ex2` with log2 e folded in), straight into A fragments (the
//     FlashAttention-2 register reuse) and multiplies them by X through
//     `ldmatrix.trans`, skipping the k-tiles past the diagonal;
//   - state = (X * d)^T . B with d = exp(acs_last - acs): X comes through
//     `ldmatrix.trans` as the A operand, and the decay goes on it in
//     registers (each element's k index, its step, is known from the
//     fragment layout); B is the shared tile, loaded once for all heads;
//     the f32 states leave in 16-byte stores (a quad's lanes swap halves
//     so that each holds 4 consecutive columns of one row).
//   One bf16 rounding of an f32 operand would break the tolerances (of
//   the decay-weighted X, 16x over the states' 1e-4; of S * L, near the
//   y tolerance), so both f32 operands are split hi + lo into two bf16
//   terms and run two products each: their error is about 2^-16 of the
//   operand.
//
// f32: the first, SIMT version, kept as it was: TF32 tensor cores (a
//   10-bit mantissa) would break the reference's 1e-4.  One block of 256
//   threads per (chunk, head, batch).  The chunk's b, c and x tiles are
//   staged in shared memory as f32 (b and c transposed, N x Q, so a
//   thread's four columns are one 16-byte read); each thread then owns a
//   4 x 4 register tile of one product at a time: C.B^T (only on and below
//   the diagonal), the masked decay, (C.B^T * L).X (its loop stops at the
//   diagonal) and the state product.  After C.B^T, the shared c tile is
//   reused for the decay-weighted b.  No fast-math: expf is the accurate
//   one.
//
// In both, the TPU grid's cells become blocks that run in any order:
// nothing carries between them.  Shared memory holds up to ~168 KB (f32 at
// Q=128, P=64, N=64), above the 48 KB default, so the caller opts in to it
// once per size (repro_ssd_chunk_opt_in).  Q, P and N are run-time sizes
// (multiples of 4, Q <= 128), so one instantiation per route serves every
// configuration and the build stays short.  Inputs are read through their
// strides (the model passes transposed views, no copies); outputs are
// contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

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
  int hpb;  // heads a block takes (bf16 route)
  long long a_sb, a_sh, a_sc, a_sq;
  long long x_sb, x_sh, x_sc, x_sq;
  long long b_sb, b_sg, b_sc, b_sq;
  long long c_sb, c_sg, c_sc, c_sq;
};

// ---------------------------------------------------------------- f32, SIMT
__host__ __device__ inline size_t smem_floats(int Q, int P, int N) {
  const size_t qs = Q + PAD;
  return (size_t)Q + 2 * (size_t)N * qs + (size_t)Q * P + (size_t)Q * qs;
}

__global__ void __launch_bounds__(THREADS) ssd_chunk_kernel_f32(Args a) {
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
  const float* xp = static_cast<const float*>(a.x) + bi * a.x_sb + h * a.x_sh + ch * a.x_sc;
  const float* bp = static_cast<const float*>(a.b) + bi * a.b_sb + g * a.b_sg + ch * a.b_sc;
  const float* cp = static_cast<const float*>(a.c) + bi * a.c_sb + g * a.c_sg + ch * a.c_sc;
  const long long cell = ((long long)bi * a.H + h) * a.nc + ch;
  float* yp = static_cast<float*>(a.y) + cell * Q * P;
  float* sp = a.st + cell * P * N;

  // stage the tiles: consecutive threads read consecutive p / n
  for (int i = tid; i < Q * P; i += THREADS) {
    const int q = i / P, p = i % P;
    xs[i] = xp[q * a.x_sq + p];
  }
  for (int i = tid; i < Q * N; i += THREADS) {
    const int q = i / N, n = i % N;
    bT[n * QS + q] = bp[q * a.b_sq + n];
    cT[n * QS + q] = cp[q * a.c_sq + n];
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
    bw[i] = bp[q * a.b_sq + n] * expf(acs_last - acs[q]);
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
      for (int s = 0; s < 4; ++s) yp[(i0 + r) * P + p0 + s] = acc[r][s];
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

// ------------------------------------------------------ bf16, tensor cores
constexpr int TC_THREADS = 128;  // 4 warps
constexpr int TC_WARPS = TC_THREADS / 32;
constexpr int TC_PAD = 8;   // bf16 elements (16 bytes) of row padding
constexpr int Y_COLS = 32;   // columns of y (p) one warp item covers
constexpr int ST_COLS = 64;  // columns of the states (n) one warp item covers
constexpr int Y_LD = Y_COLS + TC_PAD;  // pitch of a warp's y staging tile
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Index of the causal 16 x 16 tile (mt, kt), kt <= mt, among the lower
// triangle stored row by row.
__host__ __device__ inline int tri(int mt, int kt) { return mt * (mt + 1) / 2 + kt; }

// Shared-memory layout of the bf16 route at (Q, P, N): Q, P and N rounded
// up to 16 (the mma tile); bf16 rows padded by TC_PAD.
struct TcLayout {
  int Qp, Pp, Np, ldn, ldp;
  size_t s_off, c_off, b_off, x_off, y_off, acs_off, bytes;
};

__host__ __device__ inline TcLayout tc_layout(int Q, int P, int N) {
  TcLayout l;
  l.Qp = round16(Q);
  l.Pp = round16(P);
  l.Np = round16(N);
  l.ldn = l.Np + TC_PAD;
  l.ldp = l.Pp + TC_PAD;
  const int T = l.Qp / 16;
  size_t off = 0;
  l.s_off = off;  // S fragments: the causal tiles, 256 f32 each
  off += (size_t)tri(T, 0) * 256 * sizeof(float);
  l.c_off = off;  // C: Qp x ldn
  off += (size_t)l.Qp * l.ldn * 2;
  l.b_off = off;  // B: Qp x ldn
  off += (size_t)l.Qp * l.ldn * 2;
  l.x_off = off;  // X: 2 buffers of Qp x ldp
  off += 2 * (size_t)l.Qp * l.ldp * 2;
  l.y_off = off;  // y staging: 16 x Y_LD a warp
  off += (size_t)TC_WARPS * 16 * Y_LD * 2;
  l.acs_off = off;  // acs, then the decay to the chunk's end: 2 buffers of Qp each
  off += 4 * (size_t)l.Qp * sizeof(float);
  l.bytes = off;
  return l;
}

// Which warp takes item k of a list whose items grow in cost: rounds of
// TC_WARPS items, every other round in reverse, so that the costs even out.
__device__ __forceinline__ int owner(int k) {
  const int r = k / TC_WARPS, w = k % TC_WARPS;
  return (r & 1) ? TC_WARPS - 1 - w : w;
}

// Stages a (rows x cols) bf16 tile whose row r starts at src + r * sq into
// dst (pitch ld), as rows_p x cols_p with zeros past (rows, cols): 16-byte
// `cp.async` where the rows sit on 16 bytes, else scalar loads into the
// same tile (the same bits).  cols_p is a multiple of 8.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, long long sq,
                                           int rows, int cols, int rows_p, int cols_p, int tid) {
  const int chunks = cols_p / 8;
  const bool fast = (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (sq & 7) == 0;
  // piece i = r * chunks + k, advanced TC_THREADS at a time without a division
  const int rstep = TC_THREADS / chunks, kstep = TC_THREADS % chunks;
  int r = tid / chunks, k = tid % chunks;
  for (int i = tid; i < rows_p * chunks; i += TC_THREADS, r += rstep, k += kstep) {
    if (k >= chunks) {
      k -= chunks;
      ++r;
    }
    const int c = k * 8;
    const int n = r < rows ? max(0, min(8, cols - c)) : 0;  // elements of this piece in range
    __nv_bfloat16* d = dst + r * ld + c;
    if (fast) {
      tc::cp_async_16(d, n ? src + r * sq + c : src, 2 * n);
    } else {
      const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t lo = 2 * e < n ? s[r * sq + c + 2 * e] : 0u;
        const uint32_t hi = 2 * e + 1 < n ? s[r * sq + c + 2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One head's a_dt into lane registers: lane l holds steps l*per .. l*per+3
// (per = ceil(Q / 32) <= 4), zeros elsewhere.
__device__ __forceinline__ void load_a(float (&r)[4], const float* ap, long long sq, int Q, int lane) {
  const int per = (Q + 31) / 32;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = lane * per + k;
    r[k] = k < per && q < Q ? ap[q * sq] : 0.f;
  }
}

// By one warp: acs = cumsum(a_dt) from load_a's registers (each lane sums
// its steps, then an inclusive scan of the lane totals over the warp), and
// the decay to the chunk's end, exp(acs_last - acs).  Steps Q .. Qp-1 (zero
// rows of X, B and C) get acs_last and decay 1.
__device__ __forceinline__ void scan_a(const float (&r)[4], float* acs, float* dec, int Q, int Qp, int lane) {
  const int per = (Q + 31) / 32;
  float loc[4];
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run += r[k];
    loc[k] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += t;
  }
  const float excl = incl - run;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int q = lane * per + k;
    if (k < per && q < Q) acs[q] = loc[k] + excl;
  }
  __syncwarp();
  const float last = acs[Q - 1];
  for (int q = Q + lane; q < Qp; q += 32) acs[q] = last;
  __syncwarp();
  for (int q = lane; q < Qp; q += 32) dec[q] = expf(last - acs[q]);
}

// At most 128 registers a thread, so that four blocks share an SM where
// their shared memory fits (zamba2's shape; mamba2's fits three).
__global__ void __launch_bounds__(TC_THREADS, 4) ssd_chunk_kernel_tc(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int Q = a.Q, P = a.P, N = a.N;
  const TcLayout l = tc_layout(Q, P, N);
  const int T = l.Qp / 16;
  float4* s_frag = reinterpret_cast<float4*>(smem_raw + l.s_off);  // [tile][n8 half][lane]
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.c_off);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.b_off);
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.x_off);
  float* acs = reinterpret_cast<float*>(smem_raw + l.acs_off);  // [2][Qp]
  float* dec = acs + 2 * l.Qp;                                  // [2][Qp]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  __nv_bfloat16* yw = reinterpret_cast<__nv_bfloat16*>(smem_raw + l.y_off) + warp * 16 * Y_LD;
  const int ch = blockIdx.x, bi = blockIdx.z;
  const int rep = a.H / a.G;
  const int slices = (rep + a.hpb - 1) / a.hpb;
  const int grp = blockIdx.y / slices, h0 = grp * rep + (blockIdx.y % slices) * a.hpb;
  const int nh = min(a.hpb, grp * rep + rep - h0);

  const float* ap = a.a + bi * a.a_sb + ch * a.a_sc;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(a.x) + bi * a.x_sb + ch * a.x_sc;
  const __nv_bfloat16* bp = static_cast<const __nv_bfloat16*>(a.b) + bi * a.b_sb + grp * a.b_sg + ch * a.b_sc;
  const __nv_bfloat16* cp = static_cast<const __nv_bfloat16*>(a.c) + bi * a.c_sb + grp * a.c_sg + ch * a.c_sc;

  // the group's C and B, and the first head's X and a_dt
  stage_tile(cs, l.ldn, cp, a.c_sq, Q, N, l.Qp, l.Np, tid);
  stage_tile(bs, l.ldn, bp, a.b_sq, Q, N, l.Qp, l.Np, tid);
  stage_tile(xs, l.ldp, xp + h0 * a.x_sh, a.x_sq, Q, P, l.Qp, l.Pp, tid);
  tc::cp_async_commit();
  float a_next[4];
  if (warp == 0) {
    load_a(a_next, ap + h0 * a.a_sh, a.a_sq, Q, lane);
    scan_a(a_next, acs, dec, Q, l.Qp, lane);
  }
  tc::cp_async_wait<0>();
  __syncthreads();

  // S = C . B^T on the causal tiles, once for all heads: one item per 16 x
  // 16 tile (mt, kt), kt <= mt, its depth N summed in two interleaved
  // halves (even and odd 16-deep steps) so that no mma waits on the last
  {
    int item = 0;
    for (int mt = 0; mt < T; ++mt) {
      for (int kt = 0; kt <= mt; ++kt, ++item) {
        if (owner(item) != warp) continue;
        float s[2][2][4];  // [step parity][n8 half][fragment]
#pragma unroll
        for (int e = 0; e < 16; ++e) (&s[0][0][0])[e] = 0.f;
        auto step = [&](int kk, float (&acc)[2][4]) {
          uint32_t af[4], bf[4];
          tc::ldmatrix_x4(af, cs + (mt * 16 + (lane & 15)) * l.ldn + kk * 16 + (lane >> 4) * 8);
          // B's rows (steps j, n) are the columns of B^T, k-contiguous
          tc::ldmatrix_x4(bf, bs + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * l.ldn + kk * 16 + ((lane >> 3) & 1) * 8);
          tc::mma_bf16_16816(acc[0], af, bf[0], bf[1]);
          tc::mma_bf16_16816(acc[1], af, bf[2], bf[3]);
        };
        const int nk = l.Np / 16;
        for (int kk = 0; kk < nk; kk += 2) {
          step(kk, s[0]);
          if (kk + 1 < nk) step(kk + 1, s[1]);
        }
        float4* dst = s_frag + tri(mt, kt) * 64 + lane;
        dst[0] = make_float4(s[0][0][0] + s[1][0][0], s[0][0][1] + s[1][0][1], s[0][0][2] + s[1][0][2],
                             s[0][0][3] + s[1][0][3]);
        dst[32] = make_float4(s[0][1][0] + s[1][1][0], s[0][1][1] + s[1][1][1], s[0][1][2] + s[1][1][2],
                              s[0][1][3] + s[1][1][3]);
      }
    }
  }
  __syncthreads();

  const int yc_n = (l.Pp + Y_COLS - 1) / Y_COLS, pt_n = l.Pp / 16, stc_n = (l.Np + ST_COLS - 1) / ST_COLS;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh, buf = hh & 1;
    const bool more = hh + 1 < nh;
    if (more) stage_tile(xs + (buf ^ 1) * l.Qp * l.ldp, l.ldp, xp + (h + 1) * a.x_sh, a.x_sq, Q, P, l.Qp, l.Pp, tid);
    tc::cp_async_commit();
    if (warp == 0 && more) load_a(a_next, ap + (h + 1) * a.a_sh, a.a_sq, Q, lane);

    const __nv_bfloat16* xh = xs + buf * l.Qp * l.ldp;
    const float* acs_h = acs + buf * l.Qp;
    const float* dec_h = dec + buf * l.Qp;
    const long long cell = ((long long)bi * a.H + h) * a.nc + ch;
    __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(a.y) + cell * Q * P;
    float* sp = a.st + cell * P * N;

    // y = (S * L) . X, one item per (16 rows, Y_COLS columns); an item's
    // cost grows with its row tile, so owner() deals them out in turns
    for (int item = 0; item < T * yc_n; ++item) {
      if (owner(item) != warp) continue;
      const int mt = item / yc_n, pc = (item % yc_n) * Y_COLS;
      const int np_n = min(Y_COLS, l.Pp - pc) / 16;
      const int i0 = mt * 16 + g8;
      const float ai0 = acs_h[i0], ai1 = acs_h[i0 + 8];
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kt = 0; kt <= mt; ++kt) {
        // A fragments of S * L, split hi + lo: element e of n8 half hf is
        // row i0 + 8 (e / 2), column kt*16 + 8 hf + 2 t4 + e % 2
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float4 sv = s_frag[tri(mt, kt) * 64 + hf * 32 + lane];
          const int j0 = kt * 16 + hf * 8 + 2 * t4;
          const float aj0 = acs_h[j0], aj1 = acs_h[j0 + 1];
          const float v0 = j0 <= i0 ? sv.x * tc::ex2((ai0 - aj0) * LOG2E) : 0.f;
          const float v1 = j0 + 1 <= i0 ? sv.y * tc::ex2((ai0 - aj1) * LOG2E) : 0.f;
          const float v2 = j0 <= i0 + 8 ? sv.z * tc::ex2((ai1 - aj0) * LOG2E) : 0.f;
          const float v3 = j0 + 1 <= i0 + 8 ? sv.w * tc::ex2((ai1 - aj1) * LOG2E) : 0.f;
          tc::split_bf16x2(v0, v1, hi[2 * hf], lo[2 * hf]);
          tc::split_bf16x2(v2, v3, hi[2 * hf + 1], lo[2 * hf + 1]);
        }
        // X's rows (steps, p) are k-major, so B comes through .trans; every
        // product by hi is issued before those by lo into the same sums
        uint32_t xb[2][4];
#pragma unroll
        for (int np = 0; np < 2; ++np)
          if (np < np_n)
            tc::ldmatrix_x4_trans(xb[np], xh + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * l.ldp + pc + np * 16 +
                                              (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 2; ++np)
          if (np < np_n) {
            tc::mma_bf16_16816(acc[2 * np], hi, xb[np][0], xb[np][1]);
            tc::mma_bf16_16816(acc[2 * np + 1], hi, xb[np][2], xb[np][3]);
          }
#pragma unroll
        for (int np = 0; np < 2; ++np)
          if (np < np_n) {
            tc::mma_bf16_16816(acc[2 * np], lo, xb[np][0], xb[np][1]);
            tc::mma_bf16_16816(acc[2 * np + 1], lo, xb[np][2], xb[np][3]);
          }
      }
      // through the warp's staging tile, then out in 16-byte pieces (8 when
      // P is not a multiple of 8)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j >= 2 * np_n) break;
        *reinterpret_cast<uint32_t*>(yw + g8 * Y_LD + 8 * j + 2 * t4) = tc::pack_bf16x2(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(yw + (g8 + 8) * Y_LD + 8 * j + 2 * t4) = tc::pack_bf16x2(acc[j][2], acc[j][3]);
      }
      __syncwarp();
      const int cols = min(Y_COLS, P - pc);
      if ((P & 7) == 0) {
        const int pieces = cols / 8;
        for (int i = lane; i < 16 * pieces; i += 32) {
          const int r = i / pieces, c = (i % pieces) * 8;
          if (mt * 16 + r < Q)
            *reinterpret_cast<uint4*>(yp + (mt * 16 + r) * P + pc + c) = *reinterpret_cast<const uint4*>(yw + r * Y_LD + c);
        }
      } else {
        const int pieces = cols / 4;
        for (int i = lane; i < 16 * pieces; i += 32) {
          const int r = i / pieces, c = (i % pieces) * 4;
          if (mt * 16 + r < Q)
            *reinterpret_cast<uint2*>(yp + (mt * 16 + r) * P + pc + c) = *reinterpret_cast<const uint2*>(yw + r * Y_LD + c);
        }
      }
      __syncwarp();
    }

    // state = (X * d)^T . B, one item per (16 rows of p, ST_COLS columns of n)
    for (int item = warp; item < pt_n * stc_n; item += TC_WARPS) {
      const int pt = item / stc_n, n0 = (item % stc_n) * ST_COLS;
      const int nn = min(ST_COLS, l.Np - n0) / 16;
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int kt = 0; kt < T; ++kt) {
        // X^T as A through .trans: registers 0, 1 hold steps kt*16 + 2 t4,
        // +1 (rows p, p + 8), registers 2, 3 the steps 8 further on
        uint32_t xa[4];
        tc::ldmatrix_x4_trans(xa, xh + (kt * 16 + (lane & 7) + (lane >> 4) * 8) * l.ldp + pt * 16 + ((lane >> 3) & 1) * 8);
        const int q0 = kt * 16 + 2 * t4;
        const float d[4] = {dec_h[q0], dec_h[q0 + 1], dec_h[q0 + 8], dec_h[q0 + 9]};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 xv = tc::unpack_bf16x2(xa[r]);
          tc::split_bf16x2(xv.x * d[(r / 2) * 2], xv.y * d[(r / 2) * 2 + 1], hi[r], lo[r]);
        }
        uint32_t bb[4][4];
#pragma unroll
        for (int np = 0; np < 4; ++np)
          if (np < nn)
            tc::ldmatrix_x4_trans(bb[np], bs + (kt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * l.ldn + n0 + np * 16 +
                                              (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np)
          if (np < nn) {
            tc::mma_bf16_16816(acc[2 * np], hi, bb[np][0], bb[np][1]);
            tc::mma_bf16_16816(acc[2 * np + 1], hi, bb[np][2], bb[np][3]);
          }
#pragma unroll
        for (int np = 0; np < 4; ++np)
          if (np < nn) {
            tc::mma_bf16_16816(acc[2 * np], lo, bb[np][0], bb[np][1]);
            tc::mma_bf16_16816(acc[2 * np + 1], lo, bb[np][2], bb[np][3]);
          }
      }
      // lanes t4 and t4 ^ 1 swap halves: an even lane then holds row g8,
      // an odd one row g8 + 8, columns 8j + 4 (t4 / 2) .. +3 each
      const bool odd = t4 & 1;
      const int row = pt * 16 + g8 + (odd ? 8 : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= 2 * nn) break;
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][0] : acc[j][2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? acc[j][1] : acc[j][3], 1);
        const float4 v = odd ? make_float4(r0, r1, acc[j][2], acc[j][3]) : make_float4(acc[j][0], acc[j][1], r0, r1);
        const int col = n0 + 8 * j + 4 * (t4 >> 1);
        if (row < P && col < N) *reinterpret_cast<float4*>(sp + row * N + col) = v;
      }
    }

    // the next head's decay, once every warp is done with this buffer's
    // last user (the head before this one: the barrier below ended it)
    if (warp == 0 && more) scan_a(a_next, acs + (buf ^ 1) * l.Qp, dec + (buf ^ 1) * l.Qp, Q, l.Qp, lane);
    tc::cp_async_wait<0>();
    __syncthreads();
  }
}

int launch_f32(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(a.Q, a.P, a.N);
  dim3 grid(a.nc, a.H, B);
  ssd_chunk_kernel_f32<<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = tc_layout(a.Q, a.P, a.N).bytes;
  const int rep = a.H / a.G;
  dim3 grid(a.nc, a.G * ((rep + a.hpb - 1) / a.hpb), B);
  ssd_chunk_kernel_tc<<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

const void* kernel_of(int dtype) {
  if (dtype == 0) return (const void*)ssd_chunk_kernel_f32;
  if (dtype == 1) return (const void*)ssd_chunk_kernel_tc;
  return nullptr;
}

}  // namespace

// Bytes of dynamic shared memory one block of the `dtype` route needs at
// (Q, P, N); -1 for an unknown dtype.
extern "C" long long repro_ssd_chunk_smem_bytes(int dtype, int Q, int P, int N) {
  if (dtype == 0) return (long long)(sizeof(float) * smem_floats(Q, P, N));
  if (dtype == 1) return (long long)tc_layout(Q, P, N).bytes;
  return -1;
}

// Opts the kernel of `dtype` on the current device in to `bytes` of dynamic
// shared memory (above the 48 KB default); a launch needing more than the
// last opt-in fails with cudaErrorInvalidValue.  Returns the CUDA error, or
// -1 for an unknown dtype.
extern "C" int repro_ssd_chunk_opt_in(int dtype, int bytes) {
  const void* k = kernel_of(dtype);
  if (!k) return -1;
  return (int)cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Blocks of the `dtype` route that one SM of the current device holds at
// once with `bytes` of dynamic shared memory (after the opt-in); a negative
// CUDA error, or -1 for an unknown dtype.
extern "C" int repro_ssd_chunk_blocks_per_sm(int dtype, int bytes) {
  const void* k = kernel_of(dtype);
  if (!k) return -1;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, dtype == 0 ? THREADS : TC_THREADS, bytes);
  return e == cudaSuccess ? n : -(int)e;
}

// dtype (of x, b, c and y): 0 = float32, 1 = bfloat16; a_dt is float32.
// heads_per_block: heads of one group a bf16 block takes (>= 1; the f32
// route runs one head a block and ignores it).  Strides are in elements,
// for the leading four dims of each input; the last dim of x, b and c must
// be contiguous.  Returns 0, cudaGetLastError() of the launch, or -1 for
// an unknown dtype.
extern "C" int repro_ssd_chunk_fwd(
    const void* a_dt, const void* x, const void* b, const void* c, void* y, void* states,
    int dtype, int B, int H, int G, int nc, int Q, int P, int N, int heads_per_block,
    long long a_sb, long long a_sh, long long a_sc, long long a_sq,
    long long x_sb, long long x_sh, long long x_sc, long long x_sq,
    long long b_sb, long long b_sg, long long b_sc, long long b_sq,
    long long c_sb, long long c_sg, long long c_sc, long long c_sq, void* stream) {
  Args a{static_cast<const float*>(a_dt), x, b, c, y, static_cast<float*>(states),
         H, G, nc, Q, P, N, heads_per_block,
         a_sb, a_sh, a_sc, a_sq, x_sb, x_sh, x_sc, x_sq,
         b_sb, b_sg, b_sc, b_sq, c_sb, c_sg, c_sc, c_sq};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_f32(a, B, st);
  if (dtype == 1) return launch_bf16(a, B, st);
  return -1;
}
