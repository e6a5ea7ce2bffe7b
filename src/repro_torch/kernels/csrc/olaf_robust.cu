// OLAF's robust combine at the PS for Hopper: the agg_count-weighted mean of
// the K rows drained in a cycle, their trimmed (winsorized) mean, and the
// choice between the two, in ONE launch that reads the (K, D) block once and
// writes the (D,) result once.
//
//   frac       = n_screen / max(n_send, 1)          (0-dim counts on the card)
//   out[d]     = frac > threshold ? trimmed[d] : mean[d]
//   mean[d]    = Σ_k w[k]·x[k,d] / max(Σ_k w[k], 1)
//   trimmed[d] = Σ_k v[k]·min(max(fin(x[k,d]), lo[d]), hi[d]) / max(Σ_k v[k], 1)
//
// with v[k] = w[k]·(w[k] > 0), fin(x) = x where finite and 0 elsewhere, and
// lo, hi the column's quantiles at trim and 1 − trim over the rows with
// w > 0 whose entry is not NaN, interpolated as jnp.nanquantile does
// (low·(1 − w) + high·w, not a lerp: ROADMAP hazard H18), then NaN → 0 and
// ±inf → ±FLT_MAX. The mean keeps a matrix-vector product's IEEE behaviour:
// a row of weight 0 with a non-finite entry still gives NaN there.
//
// Replaces no Pallas kernel: repro computes both branches in XLA and picks
// one (launch/train.py's ps_step: the weighted mean, core/aggregation.py::
// jax_trimmed_combine and a jnp.where). The port's plain version
// (kernels/olaf_robust.py) is that eager composition, which walks column
// slices with some thirty passes each.
//
// Bound: bytes, K·D·4 read and D·4 written (2.16 ms at K = 4 and
// D = 361,821,120 on an H100 at 3.35 TB/s). The mean is one fused
// multiply-add per element; the trimmed branch a few dozen operations per
// element, well under the card's rate per byte. The design:
//
//   * Every block reads the K weights and the two counts and forms the
//     sums and the choice itself (the same in every block), so nothing is
//     read back to the host and only the chosen branch is computed.
//   * A thread takes 4 adjacent columns: K 128-bit streaming loads (__ldcs),
//     one per row, all in flight before any arithmetic. Groups of 4 columns
//     are counted from the 16-byte boundary at or before the first column,
//     so with a row stride that is a multiple of 4 floats every group but
//     the first and the last is aligned on every row; those two, and every
//     group when the stride is not such a multiple, take scalar loads under
//     a mask. A grid-stride loop on as many blocks as fit on the card.
//   * The sort is the plain version's odd-even transposition network of
//     min/max over the rows, in registers, with K rounded up to a power of
//     two (2 to 32) by rows of +inf that sort last and are never read (as
//     the masked rows and NaN entries, which sort as +inf); a quantile
//     takes its two entries by an unrolled select, so no register array is
//     indexed at run time (which would put it in local memory).
//   * Rounded where the plain version rounds: the quantile's products and
//     sum one by one (__fmul_rn, __fadd_rn, no contraction), the weighted
//     sums over the rows in order by fused multiply-adds, as a
//     matrix-vector product takes them, and one IEEE division.
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kMaxRows = 32;
constexpr int kCols = 4;  // adjacent columns per thread: one float4 per row
}  // namespace

// Mirrors the ctypes.Structure in repro_torch/kernels/olaf_robust.py
// (tests/test_torch_kernel_abi.py checks it). All on one device.
struct OlafRobustArgs {
  int K, D;
  long long ld;        // floats from one row of `rows` to the next
  float threshold;     // the screened share above which the trimmed mean is taken
  float q_lo, q_hi;    // trim and 1 - trim
  const float* rows;   // (K, D), unit column stride
  const float* weights;  // (K,)
  const int* n_screen;   // 0-dim: sent rows screened at ingress
  const int* n_send;     // 0-dim: rows sent
  float* out;            // (D,)
};

// s[i] for a run-time i in [0, KP), by selects.
template <int KP>
__device__ __forceinline__ float pick(const float (&s)[KP], int i) {
  float v = s[0];
#pragma unroll
  for (int k = 1; k < KP; ++k) v = i == k ? s[k] : v;
  return v;
}

// The quantile q of the first `cnt` entries of the sorted s, as
// aggregation._quantile_of_sorted takes it, then nan_to_num.
template <int KP>
__device__ __forceinline__ float band(const float (&s)[KP], int cnt, float q) {
  if (cnt == 0) return 0.0f;  // NaN: no valid entry in the column
  const float top = __fsub_rn(static_cast<float>(cnt), 1.0f);
  const float r = __fmul_rn(q, top);
  const float low = floorf(r), high = ceilf(r);
  const float high_w = __fsub_rn(r, low);
  const float low_w = __fsub_rn(1.0f, high_w);
  const int li = static_cast<int>(fmaxf(fminf(low, top), 0.0f));
  const int hi = static_cast<int>(fmaxf(fminf(high, top), 0.0f));
  const float v = __fadd_rn(__fmul_rn(pick(s, li), low_w),
                            __fmul_rn(pick(s, hi), high_w));
  return isnan(v) ? 0.0f : fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

template <int KP>
__device__ __forceinline__ float trimmed_column(const float (&x)[KP][kCols],
                                                int j, int K, const float* w,
                                                const float* v, float q_lo,
                                                float q_hi) {
  float s[KP];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    const bool in = k < K && w[k] > 0.0f && !isnan(x[k][j]);
    s[k] = in ? x[k][j] : INFINITY;
    cnt += in;
  }
#pragma unroll
  for (int r = 0; r < KP; ++r)
#pragma unroll
    for (int i = r & 1; i + 1 < KP; i += 2) {
      const float a = s[i], b = s[i + 1];
      s[i] = fminf(a, b);
      s[i + 1] = fmaxf(a, b);
    }
  const float lo = band(s, cnt, q_lo), hi = band(s, cnt, q_hi);
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < KP; ++k)
    if (k < K) {
      const float e = isfinite(x[k][j]) ? x[k][j] : 0.0f;
      acc = __fmaf_rn(v[k], fminf(fmaxf(e, lo), hi), acc);
    }
  return acc;
}

template <int KP>
__global__ void __launch_bounds__(kThreads)
olaf_robust_combine_kernel(OlafRobustArgs a, int shift, int vec_rows,
                           int vec_out) {
  __shared__ float w[KP], v[KP];
  __shared__ float den;
  __shared__ int take_trimmed;
  const int K = a.K;
  if (threadIdx.x < KP) {
    const float wk = threadIdx.x < K ? a.weights[threadIdx.x] : 0.0f;
    w[threadIdx.x] = wk;
    v[threadIdx.x] = wk * (wk > 0.0f ? 1.0f : 0.0f);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const float frac = __fdiv_rn(static_cast<float>(*a.n_screen),
                                 fmaxf(static_cast<float>(*a.n_send), 1.0f));
    const bool trim = frac > a.threshold;
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) sum = __fadd_rn(sum, trim ? v[k] : w[k]);
    take_trimmed = trim;
    den = sum < 1.0f ? 1.0f : sum;  // torch.clamp(min=1): NaN stays NaN
  }
  __syncthreads();
  const bool trim = take_trimmed;
  const float d = den;
  const long long D = a.D;
  const long long groups = (D + shift + kCols - 1) / kCols;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const long long c0 = g * kCols - shift;
    const bool full = c0 >= 0 && c0 + kCols <= D;
    float x[KP][kCols];
#pragma unroll
    for (int k = 0; k < KP; ++k)
#pragma unroll
      for (int j = 0; j < kCols; ++j) x[k][j] = 0.0f;
    if (full && vec_rows) {
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (k < K) {
          const float4 t =
              __ldcs(reinterpret_cast<const float4*>(a.rows + k * a.ld + c0));
          x[k][0] = t.x;
          x[k][1] = t.y;
          x[k][2] = t.z;
          x[k][3] = t.w;
        }
    } else {
#pragma unroll
      for (int k = 0; k < KP; ++k)
        if (k < K)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            const long long c = c0 + j;
            if (c >= 0 && c < D) x[k][j] = __ldcs(a.rows + k * a.ld + c);
          }
    }
    float y[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      float acc = 0.0f;
      if (trim) {
        acc = trimmed_column(x, j, K, w, v, a.q_lo, a.q_hi);
      } else {
#pragma unroll
        for (int k = 0; k < KP; ++k)
          if (k < K) acc = __fmaf_rn(w[k], x[k][j], acc);
      }
      y[j] = __fdiv_rn(acc, d);
    }
    if (full && vec_out) {
      __stcs(reinterpret_cast<float4*>(a.out + c0),
             make_float4(y[0], y[1], y[2], y[3]));
    } else {
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const long long c = c0 + j;
        if (c >= 0 && c < D) __stcs(a.out + c, y[j]);
      }
    }
  }
}

template <int KP>
static int launch_with(const OlafRobustArgs& a, cudaStream_t st, int sms) {
  const uintptr_t rows = reinterpret_cast<uintptr_t>(a.rows);
  const uintptr_t out = reinterpret_cast<uintptr_t>(a.out);
  // 16-byte loads need every row at the same offset modulo 16 bytes
  const int vec_rows = a.ld % kCols == 0;
  const int shift = vec_rows ? static_cast<int>((rows / 4) % kCols) : 0;
  const int vec_out = static_cast<int>((out / 4) % kCols) == shift;
  const long long groups = (static_cast<long long>(a.D) + shift + kCols - 1) / kCols;
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, olaf_robust_combine_kernel<KP>, kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fill = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const long long need = (groups + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(need < fill ? (need > 0 ? need : 1) : fill);
  olaf_robust_combine_kernel<KP><<<blocks, kThreads, 0, st>>>(a, shift, vec_rows,
                                                              vec_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// One launch on `stream`; returns a CUDA error code (0 = ok).
int olaf_robust_combine_launch(const OlafRobustArgs* args, void* stream) {
  const OlafRobustArgs a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.K < 0 || a.K > kMaxRows || a.D < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.K <= 2) return launch_with<2>(a, st, sms);
  if (a.K <= 4) return launch_with<4>(a, st, sms);
  if (a.K <= 8) return launch_with<8>(a, st, sms);
  if (a.K <= 16) return launch_with<16>(a, st, sms);
  return launch_with<32>(a, st, sms);
}

const char* olaf_robust_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
