// Flash attention for Hopper: online-softmax attention of q (BH,Sq,Dh)
// over k/v (BH,Sk,Dh), with a causal mask, a sliding window and a query
// offset, computed in float32 whatever the input type (bf16 or f32), the
// output in the input type:
//
//   out[b,i] = Σ_j p_ij v[b,j] / Σ_j p_ij,  p_ij = exp(s_ij − max_j s_ij),
//   s_ij = q[b,i]·k[b,j] / sqrt(Dh) where j is live for i, else masked:
//   live = j < Sk, (causal) j <= i + q_offset, (window W) j > i + q_offset − W.
//   A row with no live key gives 0 (masked scores are −1e30, l >= 1e-30).
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel). The TPU kernel runs a
// sequential grid (bh, q block, kv block) with (m, l, acc) carried in VMEM
// scratch across the kv sweep, 512-row blocks and the MXU; it asserts
// Sq % block_q == 0 and Sk % block_k == 0. Here:
//
//   one block per (q tile of 64 rows, bh). The Q tile is staged in shared
//   memory as float32 once; the block then walks the live K/V tiles in a
//   loop (tiles wholly in the future or before the window are never read),
//   staging each K/V tile in shared memory. Each q row is owned by Dh/32
//   neighbouring threads of one warp: each thread scores an interleaved
//   share of the tile's keys, the row's running max and sum are combined
//   with shuffles, p goes through shared memory to the row's threads, and
//   each thread keeps 32 of the row's Dh float32 accumulators in
//   registers. The ragged edges (q >= Sq, k >= Sk) are masked, so no
//   length has to divide a tile.
//
// Bound: at the serve shapes (Dh = 64, causal) about Dh/2 operations per
// byte moved, so the tensor cores' rate bounds it in bf16 and the float32
// rate in f32 (chip_smoke.py computes both). This first kernel multiplies
// on the CUDA cores in float32 (as the TPU kernel computes in float32):
// it is simple and right, not fast; wgmma and TMA are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors the ctypes.Structure in repro_torch/kernels/flash_attention.py.
// q/out (BH,Sq,Dh), k/v (BH,Sk,Dh): row-major, contiguous, 16-byte aligned.
struct FlashArgs {
  int BH, Sq, Sk, Dh;
  int causal, window, q_offset;
  int bf16;  // 1: every operand bf16; 0: every operand float32
  float scale;
  const void* q;
  const void* k;
  const void* v;
  void* out;
};

namespace {
constexpr int kBQ = 64;  // q rows per block
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Shared-memory layout, in floats: Q (kBQ, DH+4), K (BK, DH+4), V (BK, DH),
// P (kBQ, BK+TPR). The pads put neighbouring rows on other banks.
template <int DH, int BK>
struct Tile {
  static constexpr int TPR = DH / 32;        // threads per q row
  static constexpr int NT = kBQ * TPR;       // threads per block
  static constexpr int DS = DH + 4;          // Q/K row stride
  static constexpr int PS = BK + TPR;        // P row stride
  static constexpr int KPT = BK / TPR;       // keys scored per thread
  static constexpr int CPT = DH / 4 / TPR;   // float4 accumulators per thread
  static constexpr size_t kFloats = kBQ * DS + BK * DS + BK * DH + kBQ * PS;
};

// rows [r0, r0 + n) of a (·, DH) matrix into a float32 tile of row stride
// `stride`; rows past `limit` are zero
template <typename T, int DH, int NT>
__device__ __forceinline__ void stage(float* dst, int stride, const T* src,
                                      int r0, int n, int limit) {
  constexpr int C4 = DH / 4;
  for (int i = threadIdx.x; i < n * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    const float4 x = r0 + r < limit ? load4(src + static_cast<size_t>(r0 + r) * DH + 4 * c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * stride + 4 * c, x);
  }
}

template <typename T, int DH, int BK>
__global__ void __launch_bounds__(Tile<DH, BK>::NT)
flash_kernel(FlashArgs a) {
  using G = Tile<DH, BK>;
  constexpr int TPR = G::TPR, NT = G::NT, DS = G::DS, PS = G::PS;
  constexpr int KPT = G::KPT, CPT = G::CPT;
  static_assert(KPT <= 32, "the live-key mask is 32 bits");
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * DS;
  float* sV = sK + BK * DS;
  float* sP = sV + BK * DH;

  const int row = threadIdx.x / TPR, c = threadIdx.x % TPR;
  const int q0 = blockIdx.x * kBQ;
  const size_t bh = blockIdx.y;
  const T* q = static_cast<const T*>(a.q) + bh * a.Sq * DH;
  const T* k = static_cast<const T*>(a.k) + bh * a.Sk * DH;
  const T* v = static_cast<const T*>(a.v) + bh * a.Sk * DH;

  // the live K tiles of this q tile (absolute q positions qa_lo..qa_hi)
  const int qa_lo = q0 + a.q_offset;
  const int qa_hi = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
  int kt_lo = 0, kt_hi = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, qa_hi / BK + 1);
  if (a.window > 0 && qa_lo - a.window + 1 > 0) kt_lo = (qa_lo - a.window + 1) / BK;

  stage<T, DH, NT>(sQ, DS, q, q0, kBQ, a.Sq);
  const int qa = q0 + row + a.q_offset;  // this row's absolute position
  float m = kNegInf, l = 0.f;
  float4 acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous K/V tile
    stage<T, DH, NT>(sK, DS, k, k0, BK, a.Sk);
    stage<T, DH, NT>(sV, DH, v, k0, BK, a.Sk);
    __syncthreads();

    // scores of this thread's keys k0 + c + TPR·jj
    float s[KPT];
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) s[jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; d += 4) {
      const float4 qv = load4(sQ + row * DS + d);
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float4 kv = load4(sK + (c + TPR * jj) * DS + d);
        s[jj] = fmaf(qv.x, kv.x, s[jj]);
        s[jj] = fmaf(qv.y, kv.y, s[jj]);
        s[jj] = fmaf(qv.z, kv.z, s[jj]);
        s[jj] = fmaf(qv.w, kv.w, s[jj]);
      }
    }
    uint32_t live = 0;
    float mt = kNegInf;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const int kp = k0 + c + TPR * jj;
      const bool ok = kp < a.Sk && (!a.causal || kp <= qa) &&
                      (a.window <= 0 || kp > qa - a.window);
      live |= static_cast<uint32_t>(ok) << jj;
      s[jj] = ok ? s[jj] * a.scale : kNegInf;
      mt = fmaxf(mt, s[jj]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    const float m_new = fmaxf(m, mt);
    const float corr = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int jj = 0; jj < KPT; ++jj) {
      const float p = (live >> jj) & 1u ? expf(s[jj] - m_new) : 0.f;
      sP[row * PS + c + TPR * jj] = p;
      ls += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      ls += __shfl_xor_sync(0xffffffffu, ls, off);
    l = l * corr + ls;
    m = m_new;
    __syncwarp();  // the row's p is written by the row's own lanes

    const int n = min(BK, a.Sk - k0);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      acc[i].x *= corr; acc[i].y *= corr; acc[i].z *= corr; acc[i].w *= corr;
    }
    for (int j = 0; j < n; ++j) {
      const float p = sP[row * PS + j];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const float4 vv = load4(sV + j * DH + 4 * (c + TPR * i));
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
  }

  const int qi = q0 + row;
  if (qi >= a.Sq) return;  // ragged edge of Sq
  const float lc = fmaxf(l, 1e-30f);
  T* o = static_cast<T*>(a.out) + (bh * a.Sq + qi) * DH;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    store4(o + 4 * (c + TPR * i),
           make_float4(acc[i].x / lc, acc[i].y / lc, acc[i].z / lc, acc[i].w / lc));
}

template <typename T, int DH, int BK>
int launch(const FlashArgs& a, cudaStream_t stream) {
  using G = Tile<DH, BK>;
  const size_t smem = G::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DH, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.BH);
  flash_kernel<T, DH, BK><<<grid, G::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const FlashArgs& a, cudaStream_t stream) {
  switch (a.Dh) {
    case 64: return launch<T, 64, 64>(a, stream);
    case 128: return launch<T, 128, 64>(a, stream);
    case 256: return launch<T, 256, 32>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

extern "C" {

// One launch on `stream`; returns the CUDA error code (0 = ok).
int flash_attention_launch(const FlashArgs* args, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return args->bf16 ? launch_dh<__nv_bfloat16>(*args, s)
                    : launch_dh<float>(*args, s);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
