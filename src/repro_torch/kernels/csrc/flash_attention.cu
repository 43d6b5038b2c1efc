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
// the tensor cores (989 TFLOP/s bf16) would bound a fast kernel; the bytes
// (q, k, v, out once each at 3.35 TB/s) bound it only for short prompts.
// This first version is right and simple, not fast: it uses no tensor
// cores.  One block of BLOCK_Q threads per (q tile, head, batch); each
// thread owns one query row and keeps that row's running max, denominator
// and D-wide accumulator in registers.  The TPU kernel's sequential kv grid
// axis becomes the loop over kv tiles inside the block, and the TPU kernel's
// skipped (fully masked) block pairs become the loop's bounds.  Q, K and V
// tiles are staged in shared memory as f32, and so is each thread's row of
// probabilities; the Q and P rows are padded by one column so that the
// threads' row reads fall in distinct banks, and every thread reads the
// same K/V element at once (a broadcast).  The ragged tail
// (S not a multiple of the tile) is masked in the kernel, so any S works.
// Inputs are read through their (B, S, H, D) strides: no host transposes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;  // query rows per block = threads per block
constexpr int BLOCK_K = 32;  // kv rows per shared-memory tile
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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr int smem_floats() {
  return BLOCK_Q * (D + 1) + 2 * BLOCK_K * D + BLOCK_Q * (BLOCK_K + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(BLOCK_Q) attn_fwd_kernel(Args a) {
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

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  // stage the Q tile; rows past S are zero and are never written back
  for (int i = tid; i < BLOCK_Q * D; i += BLOCK_Q) {
    const int r = i / D, d = i % D;
    const int qi = q_start + r;
    q_s[r * (D + 1) + d] = qi < S ? to_f32(q[qi * a.q_ss + d]) : 0.f;
  }

  // kv positions any row of this tile can see: the loop's bounds stand in
  // for the TPU kernel's skipped block pairs
  const int q_end = min(q_start + BLOCK_Q, S) - 1;
  int k_lo = 0;
  int k_hi = a.causal ? q_end : S - 1;
  if (a.window > 0) k_lo = max(k_lo, q_start - a.window + 1);
  if (a.chunk > 0) {
    k_lo = max(k_lo, (q_start / a.chunk) * a.chunk);
    k_hi = min(k_hi, (q_end / a.chunk + 1) * a.chunk - 1);
  }

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
      k_s[i] = kj < S ? to_f32(k[kj * a.k_ss + d]) : 0.f;
      v_s[i] = kj < S ? to_f32(v[kj * a.v_ss + d]) : 0.f;
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
      const int kj = k_start + j;
      bool vis = kj < S;
      if (a.causal) vis = vis && kj <= qi;
      if (a.window > 0) vis = vis && kj > qi - a.window;
      if (a.chunk > 0) vis = vis && (kj / a.chunk) == (qi / a.chunk);
      s[j] = vis ? s[j] * a.scale : NEG_INF;
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
      p_row[j] = to_f32(from_f32<T>(p));  // p in v's dtype for the PV product
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
    if (row < S) o[row * a.o_ss + d] = from_f32<T>(q_s[r * (D + 1) + d]);
  }
}

template <typename T, int D>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        attn_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((a.S + BLOCK_Q - 1) / BLOCK_Q, a.H, B);
  attn_fwd_kernel<T, D><<<grid, BLOCK_Q, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, B, stream);
    case 32: return launch<T, 32>(a, B, stream);
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head dim
// must be contiguous.  Returns 0, cudaGetLastError() of the launch, or -1
// for a dtype or head dim that has no instantiation.
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
  if (dtype == 0) return launch_d<float>(a, B, D, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(a, B, D, st);
  return -1;
}
