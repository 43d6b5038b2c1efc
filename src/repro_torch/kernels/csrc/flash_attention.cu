// Forward GQA flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_attn_kernel`, launched by
// `flash_attention` in src/repro/kernels/flash_attention.py.  Same function:
// online softmax with an f32 running max, denominator and accumulator;
// causal, sliding-window and chunked-local masks with NEG_INF = -1e30;
// p rounded to v's dtype before the PV product; finalize acc / max(l, 1e-30).
//
// What bounds it on an H100: at the serving shapes (B=1, S<=1024, H=32,
// KV=4, D=64, bf16) attention does ~4*S^2/2*H*D operations on a few MB, so
// the tensor cores (989 TFLOP/s bf16) bound a fast kernel; the bytes (q, k,
// v, out once each at 3.35 TB/s) bound it only for short prompts.
//
// Two routes, chosen by dtype in the C entry point (a route by dtype, not a
// fallback: every bf16 call takes the first, every f32 call the second):
//
// bf16: a FlashAttention-2-class forward on the tensor cores.  One block of
//   4 warps per (64-row Q tile, head, batch); each warp owns 16 query rows.
//   Q's fragments are loaded once by `ldmatrix` and stay in registers for
//   the whole kv loop.  K and V tiles of 64 rows are staged as bf16 in a
//   ring of 3 stages (2 at D=128) in shared memory, filled by 16-byte
//   `cp.async` (zero past S), so the next tiles load while one computes,
//   with one barrier a tile; rows are padded by 16 bytes so that the 8 row
//   addresses of every `ldmatrix` fall in distinct bank groups.  S = Q K^T and O += P V run on `mma.sync` m16n8k16 (bf16
//   in, f32 sums); V's fragments come through `ldmatrix.trans`.  The online
//   softmax runs on the S accumulator fragments (row max and sum reduced
//   over the 4 lanes of a quad; p = 2^(s * scale * log2 e - max) by one
//   fma and the special-function unit's ex2), and P is rounded to
//   bf16 in registers and used directly as the A operand of PV: the TPU
//   kernel's "p in v's dtype".  Masks are applied only on the kv tiles that
//   need them.  Q tiles are launched longest causal kv range first, and a
//   GQA group's heads are neighbouring blocks, so they share K/V in L2.
//   Inputs must sit on 16 bytes with (B, S, H) strides a multiple of 8
//   elements (the wrapper checks and raises).
//
// f32: the first, SIMT version, kept as it was: TF32 tensor cores (a 10-bit
//   mantissa) would break the f32 tolerance of 5e-5 that the tests and the
//   f32 gates hold.  One block of 64 threads per (q tile, head, batch), one
//   query row per thread with its running max, denominator and D-wide
//   accumulator in registers; Q, K, V tiles and each thread's row of
//   probabilities staged in shared memory (Q and P rows padded by one
//   column against bank conflicts).
//
// In both, the TPU kernel's sequential kv grid axis becomes the loop over
// kv tiles inside the block, and the TPU kernel's skipped (fully masked)
// block pairs become the loop's bounds.  The ragged tail (S not a multiple
// of the tile) is masked in the kernel, so any S works.  Inputs are read
// through their (B, S, H, D) strides: no host transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int S, H, KV;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window, chunk;
  float scale;
};

// kv positions [lo, hi] that any row of the q tile [q_start, q_end] can see:
// the loop's bounds stand in for the TPU kernel's skipped block pairs
__device__ __forceinline__ void kv_range(const Args& a, int q_start, int q_end, int& lo, int& hi) {
  lo = 0;
  hi = a.causal ? q_end : a.S - 1;
  if (a.window > 0) lo = max(lo, q_start - a.window + 1);
  if (a.chunk > 0) {
    lo = max(lo, (q_start / a.chunk) * a.chunk);
    hi = min(hi, (q_end / a.chunk + 1) * a.chunk - 1);
  }
}

__device__ __forceinline__ bool visible(const Args& a, int qi, int kj) {
  bool vis = kj < a.S;
  if (a.causal) vis = vis && kj <= qi;
  if (a.window > 0) vis = vis && kj > qi - a.window;
  if (a.chunk > 0) vis = vis && (kj / a.chunk) == (qi / a.chunk);
  return vis;
}

// ---------------------------------------------------------------- f32, SIMT
constexpr int F32_BLOCK_Q = 64;  // query rows per block = threads per block
constexpr int F32_BLOCK_K = 32;  // kv rows per shared-memory tile

template <int D>
constexpr int f32_smem_floats() {
  return F32_BLOCK_Q * (D + 1) + 2 * F32_BLOCK_K * D + F32_BLOCK_Q * (F32_BLOCK_K + 1);
}

template <int D>
__global__ void __launch_bounds__(F32_BLOCK_Q) attn_fwd_kernel(Args a) {
  constexpr int BLOCK_Q = F32_BLOCK_Q, BLOCK_K = F32_BLOCK_K;
  extern __shared__ float smem[];
  float* q_s = smem;                     // BLOCK_Q x (D + 1), padded rows
  float* k_s = q_s + BLOCK_Q * (D + 1);  // BLOCK_K x D
  float* v_s = k_s + BLOCK_K * D;        // BLOCK_K x D
  float* p_s = v_s + BLOCK_K * D;        // BLOCK_Q x (BLOCK_K + 1), padded rows

  const int tid = threadIdx.x;
  const int q_start = blockIdx.x * BLOCK_Q;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (a.H / a.KV);
  const int S = a.S;

  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  // stage the Q tile; rows past S are zero and are never written back
  for (int i = tid; i < BLOCK_Q * D; i += BLOCK_Q) {
    const int r = i / D, d = i % D;
    const int qi = q_start + r;
    q_s[r * (D + 1) + d] = qi < S ? q[qi * a.q_ss + d] : 0.f;
  }

  int k_lo, k_hi;
  kv_range(a, q_start, min(q_start + BLOCK_Q, S) - 1, k_lo, k_hi);

  const int qi = q_start + tid;
  float m_i = NEG_INF;
  float l_i = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int kt = k_lo / BLOCK_K; kt <= k_hi / BLOCK_K; ++kt) {
    const int k_start = kt * BLOCK_K;
    __syncthreads();  // the previous tile is consumed (and Q is staged)
    for (int i = tid; i < BLOCK_K * D; i += BLOCK_Q) {
      const int j = i / D, d = i % D;
      const int kj = k_start + j;
      k_s[i] = kj < S ? k[kj * a.k_ss + d] : 0.f;
      v_s[i] = kj < S ? v[kj * a.v_ss + d] : 0.f;
    }
    __syncthreads();

    float s[BLOCK_K];
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[tid * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < BLOCK_K; ++j) s[j] = fmaf(qd, k_s[j * D + d], s[j]);
    }

    float m_cur = NEG_INF;
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      s[j] = visible(a, qi, k_start + j) ? s[j] * a.scale : NEG_INF;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m_i, m_cur);
    const float alpha = expf(m_i - m_new);
    float l_sum = 0.f;
    float* p_row = p_s + tid * (BLOCK_K + 1);  // read back by this thread only
#pragma unroll
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = expf(s[j] - m_new);
      l_sum += p;
      p_row[j] = p;  // p in v's dtype (f32) for the PV product
    }
    l_i = alpha * l_i + l_sum;
    m_i = m_new;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll 2
    for (int j = 0; j < BLOCK_K; ++j) {
      const float p = p_row[j];
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, v_s[j * D + d], acc[d]);
    }
  }

  // finalize into this thread's own Q row, then store the tile coalesced
  const float denom = fmaxf(l_i, 1e-30f);
#pragma unroll
  for (int d = 0; d < D; ++d) q_s[tid * (D + 1) + d] = acc[d] / denom;
  __syncthreads();
  for (int i = tid; i < BLOCK_Q * D; i += BLOCK_Q) {
    const int r = i / D, d = i % D;
    const int row = q_start + r;
    if (row < S) o[row * a.o_ss + d] = q_s[r * (D + 1) + d];
  }
}

// ------------------------------------------------------ bf16, tensor cores
constexpr int TC_BM = 64;        // query rows per block, 16 per warp
constexpr int TC_BN = 64;        // kv rows per staged tile
constexpr int TC_THREADS = 128;  // 4 warps
constexpr int TC_PAD = 8;        // bf16 elements (16 bytes) of row padding
constexpr float LOG2E = 1.4426950408889634f;
static_assert(TC_BM == TC_BN, "load_rows stages Q, K and V tiles of the same 64 rows");

// stages of the K/V ring: 3 where three blocks still fit an SM's shared
// memory (D <= 64), else 2 (at D=128 a third stage would leave one block
// an SM)
template <int D>
__host__ __device__ constexpr int tc_stages() {
  return D <= 64 ? 3 : 2;
}

template <int D>
constexpr int tc_smem_bytes() {
  return (TC_BM + 2 * tc_stages<D>() * TC_BN) * (D + TC_PAD) * 2;  // Q, then the K and V rings
}

// Issues the 16-byte copies of rows [r0, r0 + 64) of one head's (S, D)
// slab into a padded shared tile; rows past S are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long long ss, int r0,
                                          int S, int tid) {
  constexpr int LD = D + TC_PAD, CHUNKS = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < TC_BN * CHUNKS; i += TC_THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool in = r0 + r < S;
    tc::cp_async_16(dst + r * LD + c, in ? src + (r0 + r) * ss + c : src, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(TC_THREADS) attn_fwd_kernel_tc(Args a) {
  constexpr int LD = D + TC_PAD;
  constexpr int STAGES = tc_stages<D>();
  constexpr int NT = TC_BN / 8;  // 8-column tiles of S a warp holds
  constexpr int DT = D / 8;      // 8-column tiles of O a warp holds
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // TC_BM x LD
  __nv_bfloat16* k_s = q_s + TC_BM * LD;                             // STAGES x TC_BN x LD
  __nv_bfloat16* v_s = k_s + STAGES * TC_BN * LD;                    // STAGES x TC_BN x LD

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * TC_BM;  // longest causal kv range first
  const int kvh = h / (a.H / a.KV);
  const int S = a.S;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  const int q_end = min(q_start + TC_BM, S) - 1;
  int k_lo, k_hi;
  kv_range(a, q_start, q_end, k_lo, k_hi);
  const int t_lo = k_lo / TC_BN, t_hi = k_hi / TC_BN;

  // groups 0 .. STAGES-2: the Q tile with the first K/V tile, then the next
  load_rows<D>(q_s, q, a.q_ss, q_start, S, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (t_lo + st <= t_hi) {
      load_rows<D>(k_s + st * TC_BN * LD, k, a.k_ss, (t_lo + st) * TC_BN, S, tid);
      load_rows<D>(v_s + st * TC_BN * LD, v, a.v_ss, (t_lo + st) * TC_BN, S, tid);
    }
    tc::cp_async_commit();
  }

  const int row0 = q_start + warp * 16 + g;  // this lane's rows: row0 and row0 + 8
  const float scale_log2 = a.scale * LOG2E;  // scores scaled into log2 units inside ex2
  uint32_t qf[D / 16][4];
  float o_acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF};  // running max of the raw scores
  float l_i[2] = {0.f, 0.f};          // this lane's share of the running denominator

  for (int kt = t_lo; kt <= t_hi; ++kt) {
    const int it = kt - t_lo;
    tc::cp_async_wait<STAGES - 2>();  // tile kt (and Q) have landed ...
    __syncthreads();  // ... for every thread, and every warp is done with tile kt - 1
    if (kt + STAGES - 1 <= t_hi) {  // refill tile kt - 1's stage, STAGES - 1 tiles ahead
      const int st = (it + STAGES - 1) % STAGES;
      load_rows<D>(k_s + st * TC_BN * LD, k, a.k_ss, (kt + STAGES - 1) * TC_BN, S, tid);
      load_rows<D>(v_s + st * TC_BN * LD, v, a.v_ss, (kt + STAGES - 1) * TC_BN, S, tid);
    }
    tc::cp_async_commit();
    if (kt == t_lo) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        tc::ldmatrix_x4(qf[kk], q_s + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* ks = k_s + (it % STAGES) * TC_BN * LD;
    const __nv_bfloat16* vs = v_s + (it % STAGES) * TC_BN * LD;

    // S = Q K^T: K's rows (kv, d) are B's columns, k-contiguous
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t kb[4];
        tc::ldmatrix_x4(kb, ks + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16_16816(s[2 * jp], qf[kk], kb[0], kb[1]);
        tc::mma_bf16_16816(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }
    }

    // online softmax on the fragments: element e of tile j is row
    // row0 + 8 * (e / 2), kv position k_start + 8 j + 2 t4 + e % 2
    const int k_start = kt * TC_BN;
    bool need_mask = k_start + TC_BN > S;
    if (a.causal) need_mask |= k_start + TC_BN - 1 > q_start;
    if (a.window > 0) need_mask |= k_start <= q_start + TC_BM - 1 - a.window;
    if (a.chunk > 0)
      need_mask |= k_start / a.chunk != (k_start + TC_BN - 1) / a.chunk ||
                   q_start / a.chunk != (q_start + TC_BM - 1) / a.chunk || k_start / a.chunk != q_start / a.chunk;
    if (need_mask) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (!visible(a, row0 + 8 * (e / 2), k_start + 8 * j + 2 * t4 + (e & 1))) s[j][e] = NEG_INF;
    }
    float alpha[2], m_scaled[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m_cur = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j) m_cur = fmaxf(m_cur, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 1));
      m_cur = fmaxf(m_cur, __shfl_xor_sync(0xffffffffu, m_cur, 2));
      const float m_new = fmaxf(m_i[r], m_cur);
      alpha[r] = tc::ex2((m_i[r] - m_new) * scale_log2);
      m_i[r] = m_new;
      // a row with nothing visible yet keeps p = 0 (the fma below would
      // leave the rounding of NEG_INF * scale_log2, ~1e22, in the exponent)
      m_scaled[r] = m_new == NEG_INF ? 0.f : m_new * scale_log2;
      l_i[r] *= alpha[r];
    }
    // P, rounded to bf16, as the A operand of PV (16 kv positions a step)
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p0 = tc::ex2(fmaf(s[j][0], scale_log2, -m_scaled[0]));
      const float p1 = tc::ex2(fmaf(s[j][1], scale_log2, -m_scaled[0]));
      const float p2 = tc::ex2(fmaf(s[j][2], scale_log2, -m_scaled[1]));
      const float p3 = tc::ex2(fmaf(s[j][3], scale_log2, -m_scaled[1]));
      l_i[0] += p0 + p1;
      l_i[1] += p2 + p3;
      pa[j / 2][(j & 1) * 2] = tc::pack_bf16x2(p0, p1);
      pa[j / 2][(j & 1) * 2 + 1] = tc::pack_bf16x2(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }
    // O += P V: V's rows (kv, d) are k-major, so B comes through .trans
#pragma unroll
    for (int kk = 0; kk < TC_BN / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vb[4];
        tc::ldmatrix_x4_trans(vb, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16_16816(o_acc[2 * dp], pa[kk], vb[0], vb[1]);
        tc::mma_bf16_16816(o_acc[2 * dp + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }

  // finalize: the quad's denominators summed, acc / max(l, 1e-30); each
  // warp stages its own 16 rows in Q's tile (read by no other warp), then
  // stores them in 16-byte pieces
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    denom[r] = fmaxf(l_i[r], 1e-30f);
  }
  __nv_bfloat16* ws = q_s + warp * 16 * LD;
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    *reinterpret_cast<uint32_t*>(ws + g * LD + 8 * j + 2 * t4) =
        tc::pack_bf16x2(o_acc[j][0] / denom[0], o_acc[j][1] / denom[0]);
    *reinterpret_cast<uint32_t*>(ws + (g + 8) * LD + 8 * j + 2 * t4) =
        tc::pack_bf16x2(o_acc[j][2] / denom[1], o_acc[j][3] / denom[1]);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * (D / 8); i += 32) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int row = q_start + warp * 16 + r;
    if (row < S) *reinterpret_cast<uint4*>(o + row * a.o_ss + c) = *reinterpret_cast<const uint4*>(ws + r * LD + c);
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_f32(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * f32_smem_floats<D>();
  if (int e = set_smem((const void*)attn_fwd_kernel<D>, smem)) return e;
  dim3 grid((a.S + F32_BLOCK_Q - 1) / F32_BLOCK_Q, a.H, B);
  attn_fwd_kernel<D><<<grid, F32_BLOCK_Q, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  if (int e = set_smem((const void*)attn_fwd_kernel_tc<D>, smem)) return e;
  // heads fastest (a GQA group's blocks run together), q tiles slowest
  dim3 grid(a.H, B, (a.S + TC_BM - 1) / TC_BM);
  attn_fwd_kernel_tc<D><<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const Args& a, int dtype, int B, cudaStream_t stream) {
  if (dtype == 0) return launch_f32<D>(a, B, stream);
  if (dtype == 1) return launch_bf16<D>(a, B, stream);
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head dim
// must be contiguous, and for bf16 every pointer 16-byte aligned with
// (B, S, H) strides a multiple of 8.  Returns 0, cudaGetLastError() of the
// launch, or -1 for a dtype or head dim that has no instantiation.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int B, int S, int H,
    int KV, int D, long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, int causal, int window, int chunk,
    float scale, void* stream) {
  Args a{q,    k,    v,    o,    S,    H,    KV,                     //
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,  //
         causal, window, chunk, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(a, dtype, B, st);
    case 32: return launch<32>(a, dtype, B, st);
    case 64: return launch<64>(a, dtype, B, st);
    case 128: return launch<128>(a, dtype, B, st);
    default: return -1;
  }
}
