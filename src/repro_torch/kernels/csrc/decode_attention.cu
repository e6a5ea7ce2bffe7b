// Single-token GQA decode attention for Hopper: for each batch row b and kv
// head, the rep query heads of that group attend over the cache positions
// 0..pos[b], computed in float32 whatever the input type (bf16 or f32), the
// output in the input type:
//
//   out[b,g,r] = Σ_{j<=pos[b]} p_j v[b,j,g] / Σ p_j,
//   p_j = exp(s_j − max s),  s_j = q[b,g,r]·k[b,j,g] / sqrt(Dh).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention_pallas (body _decode_kernel). The TPU kernel transposes
// the cache to (B·KV, S, Dh), runs a sequential grid over cache blocks with
// (m, l, acc) in VMEM scratch, skips blocks past pos, and asserts
// S % block_s == 0. Here, flash-decoding in two launches:
//
//   1. one block per (cache chunk, b·kv). The block reads its chunk of the
//      (B,S,KV,Dh) caches in place through their strides (no transpose
//      copy), and only the positions <= pos[b]: a chunk past pos[b] reads
//      nothing. One thread per position scores it against all rep heads
//      (q staged in shared memory, the k row read once for all rep); one
//      warp per head takes the chunk's max and sum; then threads over Dh
//      accumulate p·v, the v row again read once for all rep heads. The
//      chunk's (m, l, acc) go to float32 scratch.
//   2. one block per (b·kv, head), a thread per dim: the chunks' partials
//      merged with their max, divided by the merged sum (>= 1e-30).
//
// The chunk size is chosen by the wrapper so that B·KV·chunks fills the
// card; S need not divide it. Bound: bytes (the cache rows <= pos, read
// once); about one operation per byte.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors the ctypes.Structure in repro_torch/kernels/decode_attention.py.
// q/out (B,KV,rep,Dh) contiguous; k/v caches (B,S,KV,Dh) with element
// strides sb, ss, skv (unit stride on Dh, rows 16-byte aligned); pos (B,)
// int32; part_m/part_l (B·KV, nsplit, rep), part_acc (B·KV, nsplit, rep,
// Dh) float32 scratch.
struct DecodeArgs {
  int B, S, KV, rep, Dh;
  int chunk, nsplit;
  int bf16;  // 1: q, caches and out bf16; 0: float32
  float scale;
  long long sb, ss, skv;
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  float* part_m;
  float* part_l;
  float* part_acc;
  void* out;
};

namespace {
constexpr int kThreads = 128;
constexpr int kRepMax = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// 8 consecutive elements as float32 (16 bytes of bf16, 32 of float32)
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads) decode_partial(DecodeArgs a) {
  constexpr int DPT = DH > kThreads ? DH / kThreads : 1;  // dims per thread
  constexpr int DW = DH < kThreads ? DH : kThreads;       // threads per v row
  constexpr int JG = kThreads / DW;                       // v rows at a time
  extern __shared__ float sh[];
  const int rep = a.rep, chunk = a.chunk;
  float* sq = sh;                    // (rep, DH) q in float32
  float* ss = sq + rep * DH;         // (rep, chunk) scores, then p
  float* sred = ss + rep * chunk;    // (JG, rep, DH) partial p·v sums

  const int bkv = blockIdx.y, split = blockIdx.x;
  const int b = bkv / a.KV, g = bkv % a.KV;
  const int c0 = split * chunk;
  const int n_valid = min(a.pos[b] + 1, a.S);
  const int n = min(c0 + chunk, n_valid) - c0;  // positions of this chunk
  const size_t pi = static_cast<size_t>(bkv) * a.nsplit + split;
  float* pm = a.part_m + pi * rep;
  float* pl = a.part_l + pi * rep;
  float* pacc = a.part_acc + pi * rep * DH;
  if (n <= 0) {  // wholly past pos[b]: nothing read, nothing weighed
    for (int i = threadIdx.x; i < rep * DH; i += kThreads) pacc[i] = 0.f;
    for (int r = threadIdx.x; r < rep; r += kThreads) {
      pm[r] = kNegInf;
      pl[r] = 0.f;
    }
    return;
  }

  const T* qg = static_cast<const T*>(a.q) + static_cast<size_t>(bkv) * rep * DH;
  for (int i = threadIdx.x; i < rep * DH; i += kThreads) sq[i] = to_f(qg[i]);
  const T* kb = static_cast<const T*>(a.k) + b * a.sb + g * a.skv;
  const T* vb = static_cast<const T*>(a.v) + b * a.sb + g * a.skv;
  __syncthreads();

  // 1. one thread per position: its score for every head
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const T* kr = kb + (c0 + j) * a.ss;
    float s[kRepMax];
#pragma unroll
    for (int r = 0; r < kRepMax; ++r) s[r] = 0.f;
    for (int d = 0; d < DH; d += 8) {
      float kf[8];
      load8(kr + d, kf);
#pragma unroll
      for (int r = 0; r < kRepMax; ++r) {
        if (r < rep) {
#pragma unroll
          for (int e = 0; e < 8; ++e) s[r] = fmaf(sq[r * DH + d + e], kf[e], s[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRepMax; ++r)
      if (r < rep) ss[r * chunk + j] = s[r] * a.scale;
  }
  __syncthreads();

  // 2. one warp per head: the chunk's max, p = exp(s − max) in place, sum
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rep; r += kThreads / 32) {
    float* sr = ss + r * chunk;
    float mx = kNegInf;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      pm[r] = mx;
      pl[r] = sum;
    }
  }
  __syncthreads();

  // 3. Σ p·v: thread (jg, dw) takes dims dw + DW·i of positions jg, jg+JG, …
  const int dw = threadIdx.x % DW, jg = threadIdx.x / DW;
  float acc[kRepMax][DPT];
#pragma unroll
  for (int r = 0; r < kRepMax; ++r)
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[r][i] = 0.f;
  for (int j = jg; j < n; j += JG) {
    const T* vr = vb + (c0 + j) * a.ss;
    float vv[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) vv[i] = to_f(vr[dw + DW * i]);
#pragma unroll
    for (int r = 0; r < kRepMax; ++r) {
      if (r < rep) {
        const float p = ss[r * chunk + j];
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[r][i] = fmaf(p, vv[i], acc[r][i]);
      }
    }
  }
  if constexpr (JG == 1) {
#pragma unroll
    for (int r = 0; r < kRepMax; ++r)
      if (r < rep)
#pragma unroll
        for (int i = 0; i < DPT; ++i) pacc[r * DH + dw + DW * i] = acc[r][i];
  } else {  // the JG position groups' sums, added in group order
#pragma unroll
    for (int r = 0; r < kRepMax; ++r)
      if (r < rep)
#pragma unroll
        for (int i = 0; i < DPT; ++i) sred[(jg * rep + r) * DH + dw + DW * i] = acc[r][i];
    __syncthreads();
    for (int i = threadIdx.x; i < rep * DH; i += kThreads) {
      float t = 0.f;
      for (int q = 0; q < JG; ++q) t += sred[q * rep * DH + i];
      pacc[i] = t;
    }
  }
}

// grid (B·KV, rep), DH threads: merge the chunks of one head
template <typename T>
__global__ void decode_combine(DecodeArgs a) {
  const int bkv = blockIdx.x, r = blockIdx.y, d = threadIdx.x;
  const int rep = a.rep, DH = a.Dh;
  const size_t base = static_cast<size_t>(bkv) * a.nsplit;
  float mx = kNegInf;
  for (int c = 0; c < a.nsplit; ++c) mx = fmaxf(mx, a.part_m[(base + c) * rep + r]);
  float l = 0.f, acc = 0.f;
  for (int c = 0; c < a.nsplit; ++c) {
    const size_t pi = (base + c) * rep + r;
    const float w = expf(a.part_m[pi] - mx);
    l = fmaf(a.part_l[pi], w, l);
    acc = fmaf(a.part_acc[pi * DH + d], w, acc);
  }
  T* o = static_cast<T*>(a.out) + (static_cast<size_t>(bkv) * rep + r) * DH + d;
  from_f(o, acc / fmaxf(l, 1e-30f));
}

template <typename T, int DH>
int launch(const DecodeArgs& a, size_t smem, cudaStream_t stream) {
  decode_partial<T, DH><<<dim3(a.nsplit, a.B * a.KV), kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine<T><<<dim3(a.B * a.KV, a.rep), DH, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dh(const DecodeArgs& a, size_t smem, cudaStream_t stream) {
  switch (a.Dh) {
    case 64: return launch<T, 64>(a, smem, stream);
    case 128: return launch<T, 128>(a, smem, stream);
    case 256: return launch<T, 256>(a, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

extern "C" {

int decode_attention_rep_max() { return kRepMax; }

size_t decode_attention_smem(int rep, int Dh, int chunk) {
  const int dw = Dh < kThreads ? Dh : kThreads;
  const int jg = kThreads / dw;
  const size_t red = jg > 1 ? static_cast<size_t>(jg) * rep * Dh : 0;
  return sizeof(float) * (static_cast<size_t>(rep) * Dh +
                          static_cast<size_t>(rep) * chunk + red);
}

// Two launches on `stream` (chunk partials, then the merge); returns the
// CUDA error code (0 = ok).
int decode_attention_launch(const DecodeArgs* args, void* stream) {
  const DecodeArgs a = *args;
  const size_t smem = decode_attention_smem(a.rep, a.Dh, a.chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.bf16 ? launch_dh<__nv_bfloat16>(a, smem, s) : launch_dh<float>(a, smem, s);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
