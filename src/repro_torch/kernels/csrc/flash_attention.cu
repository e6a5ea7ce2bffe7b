// Flash attention for Hopper: online-softmax attention of q over k/v, with a
// causal mask, a sliding window and a query offset, accumulated in float32,
// the output in the input type:
//
//   out[b,i,h] = Σ_j p_ij v[b,j,h] / Σ_j p_ij,  p_ij = exp(s_ij − max_j s_ij),
//   s_ij = q[b,i,h]·k[b,j,h] / sqrt(Dh) where j is live for i, else masked:
//   live = j < Sk, (causal) j <= i + q_offset, (window W) j > i + q_offset − W.
//   A row with no live key gives 0 (masked scores are −1e30, l >= 1e-30).
//
// Operands are (B, S, H, Dh) tensors read in place through their element
// strides (unit stride on Dh, every other stride a multiple of 16 bytes):
// the model's layout, and the folded (BH, S, Dh) form as H = 1. The output
// is written in the same (B, Sq, H, Dh) form through its own strides.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel). The TPU kernel runs a
// sequential grid (bh, q block, kv block) with (m, l, acc) carried in VMEM
// scratch across the kv sweep, 512-row blocks and the MXU; it asserts
// Sq % block_q == 0 and Sk % block_k == 0. Here no length has to divide a
// tile (ragged edges are masked) and there are two routes:
//
// * bf16: the tensor cores (flash_wgmma). Bound: at the serve shapes
//   (Dh = 64, causal) about Dh/2 operations per byte, above the card's
//   ~295 bf16 operations per byte at large Sq, so the bf16 tensor-core
//   rate. One block per (128 q rows, b·h): two consumer warpgroups of 64
//   rows and one producer warpgroup. The producer's one thread loads Q
//   once and walks the live K/V tiles through a 2-stage ring in shared
//   memory with TMA (128-byte swizzle, 64-column panels, a full/empty
//   mbarrier pair per stage; rows past Sk arrive as zeros). Each consumer
//   computes S = Q·Kᵀ with wgmma (m64nBKk16, both operands in shared
//   memory, float32 accumulators), masks only the tiles on the diagonal,
//   the window edge or past Sk, runs the online softmax on the accumulator
//   fragment (row max by quad shuffles, exp2 with scale·log2 e folded in),
//   rounds P to bf16 in registers (l from the float32 p) and feeds it as
//   the register A operand of O += P·V (V from shared memory, MN-major).
//   setmaxnreg moves registers from the producer to the consumers.
//   P in bf16 differs from the float32 P of the Pallas kernel by at most
//   2^-9 relative per element (ROADMAP hazard H15).
// * float32: the CUDA cores (flash_kernel). The tensor cores take float32
//   only as TF32 (about 3 decimal digits), which would miss the 1e-5 the
//   port holds float32 attention to, so float32 keeps the first kernel:
//   one block per 64-row q tile, K/V tiles staged in shared memory, each
//   q row owned by Dh/32 neighbouring threads; bound by the float32 rate.
//   On request the bf16 route also writes each row's log-sum-exp, m + log l
//   in natural units (float32, (B, H, Sq)), for the backward.
//
// The backward (bf16, Dh 64 or 128; flash_bwd_prep, flash_bwd_dkdv,
// flash_bwd_dq) ports no TPU kernel: repro's Pallas flash kernel is
// forward-only and repro trains through XLA's dense attention. It was added
// so that training need not materialise the (B, H, S, S) scores, their
// float32 copies and softmax passes, which took about 80% of a SmolLM
// gradient at S = 2048. Bound: seven products of 2·Dh operations per live
// (query, key) pair (S and dP recomputed in both kernels, dV, dK, dQ) on
// about Dh/2 operations per byte, above the card's ~295 bf16 operations
// per byte at training lengths, so the bf16 tensor-core rate. Design: the
// log-sum-exp saved by the forward makes P a pointwise function of S, so
// no kernel needs a second pass over a row. A pre-pass turns it into
// lse·log2 e and computes delta = Σ_d dO∘O per row. Then one block per
// (128 keys, b·h) keeps K and V in shared memory, walks only the live q
// tiles and accumulates dK and dV in registers; one block per (128 q rows,
// b·h) keeps Q and dO and walks the live K/V tiles for dQ. Every gradient
// row is owned by one block, so there are no atomics and the same inputs
// give the same bits. Both bring their tiles through a TMA ring with
// mbarriers, run every product with wgmma (float32 accumulators, P and dS
// rounded to bf16 as register A operands, as autograd of the dense route
// rounds them) and mask only the diagonal, window-edge and ragged tiles.
// They run two warpgroups and no producer warpgroup, so ptxas may give a
// thread 255 registers: the dK and dV accumulators and the S and dP tiles
// live in registers at once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Mirrors the ctypes.Structure in repro_torch/kernels/flash_attention.py.
// q/out (B,Sq,H,Dh), k/v (B,Sk,H,Dh); strides in elements.
struct FlashArgs {
  int B, H, Sq, Sk, Dh;
  int causal, window, q_offset;
  int bf16;  // 1: every operand bf16 (tensor cores); 0: every operand float32
  float scale;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;  // (B, H, Sq) or null: each row's log-sum-exp (bf16 route only)
};

// Mirrors _BwdArgs in repro_torch/kernels/flash_attention.py. q/o/dout/dq
// (B,Sq,H,Dh), k/v/dk/dv (B,Sk,H,Dh), all bf16, strides in elements; lse
// (B,H,Sq) float32 from the forward; lse2 and delta (B·H, sq_pad) float32
// scratch that the pre-pass fills.
struct FlashBwdArgs {
  int B, H, Sq, Sk, Dh;
  int causal, window, q_offset;
  int sq_pad;  // Sq rounded up to 128: the row stride of lse2 and delta
  float scale;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long dout_sb, dout_ss, dout_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  void* dq;
  void* dk;
  void* dv;
  float* lse2;   // lse · log2 e
  float* delta;  // Σ_d dout ∘ o
};

namespace {
constexpr float kNegInf = -1e30f;
// error codes past CUDA's own: a failed tensor-map encode (+ its CUresult)
constexpr int kTensorMapError = 100000;

// ---------------------------------------------------------------------------
// the float32 route: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;  // q rows per block

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
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

// rows [r0, r0 + n) of a (·, DH) matrix with row stride `rs` into a tile of
// row stride `stride`; rows past `limit` are zero
template <int DH, int NT>
__device__ __forceinline__ void stage(float* dst, int stride, const float* src,
                                      long long rs, int r0, int n, int limit) {
  constexpr int C4 = DH / 4;
  for (int i = threadIdx.x; i < n * C4; i += NT) {
    const int r = i / C4, c = i % C4;
    const float4 x = r0 + r < limit ? load4(src + (r0 + r) * rs + 4 * c)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * stride + 4 * c, x);
  }
}

template <int DH, int BK>
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
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const float* q = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* k = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
  const float* v = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

  // the live K tiles of this q tile (absolute q positions qa_lo..qa_hi)
  const int qa_lo = q0 + a.q_offset;
  const int qa_hi = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
  int kt_lo = 0, kt_hi = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, qa_hi / BK + 1);
  if (a.window > 0 && qa_lo - a.window + 1 > 0) kt_lo = (qa_lo - a.window + 1) / BK;

  stage<DH, NT>(sQ, DS, q, a.q_ss, q0, kBQ, a.Sq);
  const int qa = q0 + row + a.q_offset;  // this row's absolute position
  float m = kNegInf, l = 0.f;
  float4 acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every thread is done with the previous K/V tile
    stage<DH, NT>(sK, DS, k, a.k_ss, k0, BK, a.Sk);
    stage<DH, NT>(sV, DH, v, a.v_ss, k0, BK, a.Sk);
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
  float* o = static_cast<float*>(a.out) + b * a.o_sb + h * a.o_sh + qi * a.o_ss;
#pragma unroll
  for (int i = 0; i < CPT; ++i)
    store4(o + 4 * (c + TPR * i),
           make_float4(acc[i].x / lc, acc[i].y / lc, acc[i].z / lc, acc[i].w / lc));
}

// Opt the kernel into `bytes` of dynamic shared memory, once per device: the
// attribute call can wait for the card to go idle, so it stays off the
// launch path after the first call.
template <auto Kernel>
int opt_in_smem(size_t bytes) {
  static uint64_t done = 0;  // this kernel's devices: one bit per ordinal below 64
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && (done >> dev & 1)) return 0;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) done |= 1ull << dev;
  return 0;
}

template <int DH, int BK>
int launch_f32(const FlashArgs& a, cudaStream_t stream) {
  using G = Tile<DH, BK>;
  const size_t smem = G::kFloats * sizeof(float);
  const int err = opt_in_smem<flash_kernel<DH, BK>>(smem);
  if (err) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.H);
  flash_kernel<DH, BK><<<grid, G::NT, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the bf16 route: wgmma, TMA, an mbarrier ring, warp specialisation
// ---------------------------------------------------------------------------
constexpr int kWgBQ = 128;       // q rows per block: two consumer warpgroups
constexpr int kWgThreads = 384;  // warpgroups 0-1 consume, 2 produces
constexpr int kStages = 2;       // K/V ring depth
constexpr int kPanel = 64;       // bf16 columns of one 128-byte swizzle panel

template <int DH>
struct WgTile {
  static constexpr int BK = DH == 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int PANELS = DH / kPanel;
  static constexpr int Q_PANEL = kWgBQ * 128;  // bytes of one Q panel
  static constexpr int KV_PANEL = BK * 128;    // bytes of one K or V panel
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_BYTES = PANELS * KV_PANEL;  // one K (or V) tile
  static constexpr int TILES = Q_BYTES + 2 * kStages * KV_BYTES;
  // + barriers; + 1024 to align the tiles to the swizzle's 1024-byte period
  static constexpr int SMEM = TILES + 64 + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// spin until the barrier's phase with parity `parity` has completed; a wait
// that never ends (a load that never lands) traps, so the launch fails with
// an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spins == (1u << 26)) __trap();
  }
}
// one box of a 4-D tensor map (Dh, S, H, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 (SWIZZLE_128B)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accesses of `d` across the asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// D (64 x 64, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, f32) (+)= A (64 x 16, smem, K-major) * B (16 x 32, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 32) wgmma_ss_n32(d, da, db, acc);
  else if constexpr (N == 64) wgmma_ss_n64(d, da, db, acc);
  else wgmma_ss_n128(d, da, db, acc);
}
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_wgmma(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, FlashArgs a) {
  using G = WgTile<DH>;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = sQ + G::Q_BYTES;                 // kStages K tiles
  const uint32_t sV = sK + kStages * G::KV_BYTES;      // kStages V tiles
  const uint32_t bars = sV + kStages * G::KV_BYTES;    // full[2], empty[2], q
  const uint32_t bar_q = bars + 32;

  // heaviest q tiles first: under a causal mask the last tiles see most keys
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * kWgBQ;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int qa_lo = q0 + a.q_offset;
  const int qa_hi = min(q0 + kWgBQ, a.Sq) - 1 + a.q_offset;
  int kt_lo = 0, kt_hi = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, qa_hi / BK + 1);
  if (a.window > 0 && qa_lo - a.window + 1 > 0) kt_lo = (qa_lo - a.window + 1) / BK;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                      // full: the producer
      mbar_init(bars + 16 + 8 * s, 8);                 // empty: 8 consumer warps
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    setmaxnreg_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, G::Q_BYTES);
#pragma unroll
      for (int p = 0; p < G::PANELS; ++p)
        tma_load(sQ + p * G::Q_PANEL, &tq, bar_q, p * kPanel, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(bars + 16 + 8 * s, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bars + 8 * s, 2 * G::KV_BYTES);
        const int k0 = (kt_lo + i) * BK;
#pragma unroll
        for (int p = 0; p < G::PANELS; ++p) {
          tma_load(sK + s * G::KV_BYTES + p * G::KV_PANEL, &tk, bars + 8 * s,
                   p * kPanel, k0, h, b);
          tma_load(sV + s * G::KV_BYTES + p * G::KV_PANEL, &tv, bars + 8 * s,
                   p * kPanel, k0, h, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 q rows per warpgroup ----
    setmaxnreg_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int qa0 = row0 + a.q_offset, qa1 = qa0 + 8;
    const int wq_lo = q0 + 64 * wg + a.q_offset, wq_hi = wq_lo + 63;
    const float sl2 = a.scale * 1.4426950408889634f;  // scale · log2 e
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (kt_lo + i) * BK;
      mbar_wait(bars + 8 * s, (i / kStages) & 1);
      // every key of the tile masked for every row of this warpgroup
      const bool dead = (a.causal && k0 > wq_hi) ||
                        (a.window > 0 && k0 + BK - 1 <= wq_lo - a.window);
      if (!dead) {
        float sc[BK / 2];
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          const uint64_t da = sw128_desc(
              sQ + (kk / 4) * G::Q_PANEL + wg * 64 * 128 + (kk % 4) * 32, 16, 1024);
          const uint64_t db = sw128_desc(
              sK + s * G::KV_BYTES + (kk / 4) * G::KV_PANEL + (kk % 4) * 32, 16, 1024);
          wgmma_ss<BK>(sc, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        // per-element masks only on the diagonal, window-edge and Sk-edge tiles
        const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > wq_lo) ||
                          (a.window > 0 && k0 <= wq_hi - a.window);
        if (edge) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
              const int qa = e < 2 ? qa0 : qa1;
              const bool ok = col < a.Sk && (!a.causal || col <= qa) &&
                              (a.window <= 0 || col > qa - a.window);
              if (!ok) sc[4 * j + e] = kNegInf;
            }
          }
        }
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
          mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // masked maxima stay at −1e30: (−1e30 − m)·sl2 is finite, exp2 → 0
        const float c0 = exp2f((m0 - mx0) * sl2), c1 = exp2f((m1 - mx1) * sl2);
        m0 = mx0;
        m1 = mx1;
        const float mb0 = mx0 * sl2, mb1 = mx1 * sl2;
        float ls0 = 0.f, ls1 = 0.f;
        uint32_t pa[BK / 16][4];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          float p[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = sc[4 * j + e];
            p[e] = x == kNegInf ? 0.f : exp2f(fmaf(x, sl2, -(e < 2 ? mb0 : mb1)));
          }
          ls0 += p[0] + p[1];
          ls1 += p[2] + p[3];
          // the S fragment of keys 16kk..16kk+15 is the A fragment of P·V
          pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p[0], p[1]);
          pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        }
        l0 = l0 * c0 + ls0;
        l1 = l1 * c1 + ls1;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j) {
          o[4 * j] *= c0;
          o[4 * j + 1] *= c0;
          o[4 * j + 2] *= c1;
          o[4 * j + 3] *= c1;
        }
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db = sw128_desc(sV + s * G::KV_BYTES + kk * 16 * 128,
                                         G::KV_PANEL, 1024);
          wgmma_rs<DH>(o, pa[kk], db);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 16 + 8 * s);  // the stage is free
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (a.lse && lane % 4 == 0) {  // m + log l in natural units; −inf if no live key
      float* lse = a.lse + static_cast<long long>(blockIdx.y) * a.Sq;
      if (row0 < a.Sq) lse[row0] = m0 * a.scale + logf(l0);
      if (row0 + 8 < a.Sq) lse[row0 + 8] = m1 * a.scale + logf(l1);
    }
    const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out) + b * a.o_sb + h * a.o_sh;
    __nv_bfloat16* o0 = out + static_cast<long long>(row0) * a.o_ss + 2 * (lane % 4);
    __nv_bfloat16* o1 = o0 + 8 * a.o_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (row0 < a.Sq)
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) = pack_bf16(o[4 * j] / lc0, o[4 * j + 1] / lc0);
      if (row0 + 8 < a.Sq)
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) = pack_bf16(o[4 * j + 2] / lc1, o[4 * j + 3] / lc1);
    }
  }
}

// cuTensorMapEncodeTiled from the driver, found at run time (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

int encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || !p)
      return static_cast<int>(cudaErrorSymbolNotFound);
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return 0;
}

// a (B, S, H, Dh) bf16 tensor as a 4-D map (Dh, S, H, B), boxes of 64
// columns x `rows` rows, 128-byte swizzle; rows past S read as zeros
int make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int Dh, int S, int H,
             int B, long long sb, long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(Dh), static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kPanel), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + static_cast<int>(r);
}

template <int DH>
int launch_bf16(const FlashArgs& a, cudaStream_t stream) {
  using G = WgTile<DH>;
  EncodeTiled enc;
  int rc = encode_tiled(&enc);
  if (rc) return rc;
  CUtensorMap tq, tk, tv;
  if ((rc = make_map(enc, &tq, a.q, DH, a.Sq, a.H, a.B, a.q_sb, a.q_ss, a.q_sh, kWgBQ)))
    return rc;
  if ((rc = make_map(enc, &tk, a.k, DH, a.Sk, a.H, a.B, a.k_sb, a.k_ss, a.k_sh, G::BK)))
    return rc;
  if ((rc = make_map(enc, &tv, a.v, DH, a.Sk, a.H, a.B, a.v_sb, a.v_ss, a.v_sh, G::BK)))
    return rc;
  if ((rc = opt_in_smem<flash_wgmma<DH>>(G::SMEM))) return rc;
  const dim3 grid((a.Sq + kWgBQ - 1) / kWgBQ, a.B * a.H);
  flash_wgmma<DH><<<grid, kWgThreads, G::SMEM, stream>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the backward (bf16, Dh 64 or 128): a pre-pass, then the dK/dV and dQ kernels
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBwdBK = 128;   // keys per dK/dV block: two consumer warpgroups
constexpr int kPadRows = 128; // sq_pad's granularity (the dQ block's rows)
// Two warpgroups and no producer of their own: ptxas gives a kernel one
// register count, and each of the SM's four quarters holds 16,384 registers
// for the warps placed on it, so 8 warps may take 255 registers a thread
// where a third warpgroup (or warp) caps every thread at 168 and the
// accumulators spill. Thread 0 starts the loads, one tile ahead.
constexpr int kBwdThreads = 256;
// ring depth of both backward kernels: the load of tile i + 1 goes out at
// the top of tile i, into the stage that tile i − 2 gave back, so one
// warpgroup may run up to a tile ahead of the other
constexpr int kBwdStages = 3;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// one warp per row (b·h, i < sq_pad): delta = Σ_d dout·o in float32 and
// lse2 = lse·log2 e; rows past Sq get 0
template <int DH>
__global__ void __launch_bounds__(256) flash_bwd_prep(FlashBwdArgs a) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = blockIdx.x * 8 + warp;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  float d = 0.f, l2 = 0.f;
  if (i < a.Sq) {
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(a.o) + b * a.o_sb +
                             h * a.o_sh + i * a.o_ss;
    const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(a.dout) + b * a.dout_sb +
                             h * a.dout_sh + i * a.dout_ss;
#pragma unroll
    for (int c = 2 * lane; c < DH; c += 64) {
      const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
      const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(g + c));
      d = fmaf(x.x, y.x, fmaf(x.y, y.y, d));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    l2 = a.lse[static_cast<long long>(bh) * a.Sq + i] * kLog2e;
  }
  if (lane == 0 && i < a.sq_pad) {
    a.delta[static_cast<long long>(bh) * a.sq_pad + i] = d;
    a.lse2[static_cast<long long>(bh) * a.sq_pad + i] = l2;
  }
}

template <int DH>
struct DkvTile {
  // q rows per ring stage: dV and dK take DH registers a thread, Sᵀ, dPᵀ and
  // their bf16 copies 1.5·BQ
  static constexpr int BQ = DH == 64 ? 64 : 32;
  static constexpr int PANELS = DH / kPanel;
  static constexpr int KV_PANEL = kBwdBK * 128;  // bytes of one K or V panel
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int Q_PANEL = BQ * 128;       // bytes of one Q or dO panel
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int ROW_BYTES = BQ * 4;       // one stage's lse2 (or delta)
  static constexpr int TILES = 2 * KV_BYTES + 2 * kBwdStages * Q_BYTES;
  // + lse2/delta rows; + barriers; + 1024 to align the tiles to the swizzle's period
  static constexpr int SMEM = TILES + 2 * kBwdStages * ROW_BYTES + 64 + 1024;
};

// the barriers of a backward kernel's ring: full[s], empty[s], then the one
// of the operands loaded once
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) {
  return bars + 8 * (kBwdStages + s);
}
__device__ __forceinline__ uint32_t bar_once(uint32_t bars) { return bars + 16 * kBwdStages; }

__device__ __forceinline__ void init_bwd_bars(uint32_t bars) {
  for (int s = 0; s < kBwdStages; ++s) {
    mbar_init(bar_full(bars, s), 1);   // the producer
    mbar_init(bar_empty(bars, s), 8);  // 8 consumer warps
  }
  mbar_init(bar_once(bars), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// a consumer warp gives its stage back to the producer
__device__ __forceinline__ void release(uint32_t bars, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar_empty(bars, s));
}

// dK and dV of 128 keys of one (b, h): K and V stay in shared memory, the
// live q tiles of BQ rows (Q, dO, lse2, delta) come through the ring. Per
// tile each consumer warpgroup (64 keys) forms Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ
// (float32), Pᵀ = exp2(Sᵀ·scale·log2 e − lse2) and dSᵀ = Pᵀ∘(dPᵀ − delta),
// then dV += Pᵀ·dO and dK += dSᵀ·Q with Pᵀ and dSᵀ rounded to bf16 as the
// register A operand. dK is scaled once at the end.
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
               FlashBwdArgs a) {
  using G = DkvTile<DH>;
  constexpr int BQ = G::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base;
  const uint32_t sV = sK + G::KV_BYTES;
  const uint32_t sQ = sV + G::KV_BYTES;                  // kBwdStages Q tiles
  const uint32_t sO = sQ + kBwdStages * G::Q_BYTES;      // kBwdStages dO tiles
  const uint32_t sL = sO + kBwdStages * G::Q_BYTES;      // kBwdStages lse2 rows
  const uint32_t sD = sL + kBwdStages * G::ROW_BYTES;    // kBwdStages delta rows
  const uint32_t bars = sD + kBwdStages * G::ROW_BYTES;

  // heaviest key tiles first: under a causal mask the first see most queries
  const int k0 = blockIdx.x * kBwdBK;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  int qt_lo = 0, qt_hi = n_qt;
  if (a.causal) qt_lo = min(n_qt, max(0, k0 - a.q_offset) / BQ);
  if (a.window > 0) {  // the last q row some key of the tile is live for
    const int last = k0 + kBwdBK - 2 + a.window - a.q_offset;
    qt_hi = last < 0 ? 0 : min(n_qt, last / BQ + 1);
  }
  const int n_tiles = max(0, qt_hi - qt_lo);

  if (threadIdx.x == 0) init_bwd_bars(bars);
  __syncthreads();

  const float* lse2 = a.lse2 + static_cast<long long>(bh) * a.sq_pad;
  const float* delta = a.delta + static_cast<long long>(bh) * a.sq_pad;
  // tile i's Q, dO, lse2 and delta into its stage, once every warp has given
  // back the tile kBwdStages before it (thread 0)
  auto load = [&](int i) {
    const int s = i % kBwdStages;
    const uint32_t full = bar_full(bars, s);
    mbar_wait(bar_empty(bars, s), ((i / kBwdStages) & 1) ^ 1);
    mbar_expect_tx(full, 2 * G::Q_BYTES + 2 * G::ROW_BYTES);
    const int q0 = (qt_lo + i) * BQ;
#pragma unroll
    for (int p = 0; p < G::PANELS; ++p) {
      tma_load(sQ + s * G::Q_BYTES + p * G::Q_PANEL, &tq, full, p * kPanel, q0, h, b);
      tma_load(sO + s * G::Q_BYTES + p * G::Q_PANEL, &tdo, full, p * kPanel, q0, h, b);
    }
    bulk_load(sL + s * G::ROW_BYTES, lse2 + q0, G::ROW_BYTES, full);
    bulk_load(sD + s * G::ROW_BYTES, delta + q0, G::ROW_BYTES, full);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_once(bars), 2 * G::KV_BYTES);
#pragma unroll
    for (int p = 0; p < G::PANELS; ++p) {
      tma_load(sK + p * G::KV_PANEL, &tk, bar_once(bars), p * kPanel, k0, h, b);
      tma_load(sV + p * G::KV_PANEL, &tv, bar_once(bars), p * kPanel, k0, h, b);
    }
    if (n_tiles > 0) load(0);
  }
  {
    // ---- 64 keys per warpgroup ----
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int kr0 = k0 + 64 * wg + 16 * warp + lane / 4;  // and kr0 + 8
    const int wk_lo = k0 + 64 * wg, wk_hi = wk_lo + 63;
    const float sl2 = a.scale * kLog2e;
    const float* rows = reinterpret_cast<const float*>(smem_raw + (sL - raw));
    float dv[DH / 2], dk[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dv[i] = dk[i] = 0.f;
    mbar_wait(bar_once(bars), 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kBwdStages;
      const int q0 = (qt_lo + i) * BQ;
      const int qa_lo = q0 + a.q_offset, qa_hi = qa_lo + BQ - 1;
      if (threadIdx.x == 0 && i + 1 < n_tiles) load(i + 1);
      mbar_wait(bar_full(bars, s), (i / kBwdStages) & 1);
      // every (key, query) pair of this warpgroup's part of the tile masked
      const bool dead = wk_lo >= a.Sk || (a.causal && qa_hi < wk_lo) ||
                        (a.window > 0 && wk_hi <= qa_lo - a.window);
      if (dead) {
        release(bars, s, lane);
        continue;
      }
      float st[BQ / 2], dpt[BQ / 2];
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<BQ>(st, sw128_desc(sK + (kk / 4) * G::KV_PANEL + wg * 64 * 128 + (kk % 4) * 32,
                                    16, 1024),
                     sw128_desc(sQ + s * G::Q_BYTES + (kk / 4) * G::Q_PANEL + (kk % 4) * 32, 16,
                                1024),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<BQ>(dpt, sw128_desc(sV + (kk / 4) * G::KV_PANEL + wg * 64 * 128 + (kk % 4) * 32,
                                     16, 1024),
                     sw128_desc(sO + s * G::Q_BYTES + (kk / 4) * G::Q_PANEL + (kk % 4) * 32, 16,
                                1024),
                     kk > 0);
      wgmma_commit();

      // per-element masks only on the diagonal, window-edge, Sk- and Sq-edge tiles
      const bool edge = wk_hi >= a.Sk || q0 + BQ > a.Sq || (a.causal && qa_lo < wk_hi) ||
                        (a.window > 0 && wk_lo <= qa_hi - a.window);
      const float* l2 = rows + s * BQ;
      const float* dl = rows + kBwdStages * BQ + s * BQ;
      wgmma_wait0();
      fence_regs(st);
      fence_regs(dpt);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * (lane % 4) + (e & 1);
          const int key = e < 2 ? kr0 : kr0 + 8;
          const int qa = q0 + c + a.q_offset;
          const bool ok = !edge || (key < a.Sk && q0 + c < a.Sq && (!a.causal || key <= qa) &&
                                    (a.window <= 0 || key > qa - a.window));
          st[4 * j + e] = ok ? exp2f(fmaf(st[4 * j + e], sl2, -l2[c])) : 0.f;  // Pᵀ
        }
        // the Sᵀ fragment of queries 16kk..16kk+15 is the A fragment of Pᵀ·dO
        pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(st[4 * j], st[4 * j + 1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(st[4 * j + 2], st[4 * j + 3]);
      }
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DH>(dv, pa[kk], sw128_desc(sO + s * G::Q_BYTES + kk * 16 * 128, G::Q_PANEL, 1024));
      // dSᵀ while Pᵀ·dO runs
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ds[e] = st[4 * j + e] * (dpt[4 * j + e] - dl[8 * j + 2 * (lane % 4) + (e & 1)]);
        sa[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<DH>(dk, sa[kk], sw128_desc(sQ + s * G::Q_BYTES + kk * 16 * 128, G::Q_PANEL, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dv);
      fence_regs(dk);
      release(bars, s, lane);
    }

    const long long r0 = kr0, r1 = kr0 + 8;
    __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(a.dv) + b * a.dv_sb + h * a.dv_sh +
                         2 * (lane % 4);
    __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(a.dk) + b * a.dk_sb + h * a.dk_sh +
                         2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (r0 < a.Sk) {
        *reinterpret_cast<uint32_t*>(dvp + r0 * a.dv_ss + 8 * j) = pack_bf16(dv[4 * j], dv[4 * j + 1]);
        *reinterpret_cast<uint32_t*>(dkp + r0 * a.dk_ss + 8 * j) =
            pack_bf16(dk[4 * j] * a.scale, dk[4 * j + 1] * a.scale);
      }
      if (r1 < a.Sk) {
        *reinterpret_cast<uint32_t*>(dvp + r1 * a.dv_ss + 8 * j) =
            pack_bf16(dv[4 * j + 2], dv[4 * j + 3]);
        *reinterpret_cast<uint32_t*>(dkp + r1 * a.dk_ss + 8 * j) =
            pack_bf16(dk[4 * j + 2] * a.scale, dk[4 * j + 3] * a.scale);
      }
    }
  }
}

template <int DH>
struct DqTile {
  static constexpr int BK = DH == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int PANELS = DH / kPanel;
  static constexpr int Q_PANEL = kWgBQ * 128;     // bytes of one Q or dO panel
  static constexpr int Q_BYTES = PANELS * Q_PANEL;
  static constexpr int KV_PANEL = BK * 128;       // bytes of one K or V panel
  static constexpr int KV_BYTES = PANELS * KV_PANEL;
  static constexpr int TILES = 2 * Q_BYTES + 2 * kBwdStages * KV_BYTES;
  static constexpr int SMEM = TILES + 64 + 1024;
};

// dQ of 128 q rows of one (b, h): Q and dO stay in shared memory, the live
// K/V tiles come through the ring as in the forward. Per tile each
// warpgroup (64 rows) forms S = Q·Kᵀ and dP = dO·Vᵀ, P from the row's lse2,
// dS = P∘(dP − delta), and dQ += dS·K with dS rounded to bf16. dQ is scaled
// once at the end.
template <int DH>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
             FlashBwdArgs a) {
  using G = DqTile<DH>;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sO = sQ + G::Q_BYTES;
  const uint32_t sK = sO + G::Q_BYTES;                  // kBwdStages K tiles
  const uint32_t sV = sK + kBwdStages * G::KV_BYTES;    // kBwdStages V tiles
  const uint32_t bars = sV + kBwdStages * G::KV_BYTES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest q tiles first
  const int q0 = qt * kWgBQ;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int qa_lo = q0 + a.q_offset;
  const int qa_hi = min(q0 + kWgBQ, a.Sq) - 1 + a.q_offset;
  int kt_lo = 0, kt_hi = (a.Sk + BK - 1) / BK;
  if (a.causal) kt_hi = min(kt_hi, qa_hi / BK + 1);
  if (a.window > 0 && qa_lo - a.window + 1 > 0) kt_lo = (qa_lo - a.window + 1) / BK;
  const int n_tiles = max(0, kt_hi - kt_lo);

  if (threadIdx.x == 0) init_bwd_bars(bars);
  __syncthreads();

  // tile i's K and V into its stage, once every warp has given back the
  // tile kBwdStages before it (thread 0)
  auto load = [&](int i) {
    const int s = i % kBwdStages;
    const uint32_t full = bar_full(bars, s);
    mbar_wait(bar_empty(bars, s), ((i / kBwdStages) & 1) ^ 1);
    mbar_expect_tx(full, 2 * G::KV_BYTES);
    const int k0 = (kt_lo + i) * BK;
#pragma unroll
    for (int p = 0; p < G::PANELS; ++p) {
      tma_load(sK + s * G::KV_BYTES + p * G::KV_PANEL, &tk, full, p * kPanel, k0, h, b);
      tma_load(sV + s * G::KV_BYTES + p * G::KV_PANEL, &tv, full, p * kPanel, k0, h, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_once(bars), 2 * G::Q_BYTES);
#pragma unroll
    for (int p = 0; p < G::PANELS; ++p) {
      tma_load(sQ + p * G::Q_PANEL, &tq, bar_once(bars), p * kPanel, q0, h, b);
      tma_load(sO + p * G::Q_PANEL, &tdo, bar_once(bars), p * kPanel, q0, h, b);
    }
    if (n_tiles > 0) load(0);
  }
  {
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int row0 = q0 + 64 * wg + 16 * warp + lane / 4;  // and row0 + 8
    const int qa0 = row0 + a.q_offset, qa1 = qa0 + 8;
    const int wq_lo = q0 + 64 * wg + a.q_offset, wq_hi = wq_lo + 63;
    const float sl2 = a.scale * kLog2e;
    // rows up to sq_pad exist in the scratch (q0 + 128 <= sq_pad)
    const long long pr = static_cast<long long>(bh) * a.sq_pad + row0;
    const float l20 = a.lse2[pr], l21 = a.lse2[pr + 8];
    const float d0 = a.delta[pr], d1 = a.delta[pr + 8];
    float dq[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;
    mbar_wait(bar_once(bars), 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kBwdStages;
      const int k0 = (kt_lo + i) * BK;
      if (threadIdx.x == 0 && i + 1 < n_tiles) load(i + 1);
      mbar_wait(bar_full(bars, s), (i / kBwdStages) & 1);
      const bool dead = (a.causal && k0 > wq_hi) ||
                        (a.window > 0 && k0 + BK - 1 <= wq_lo - a.window);
      if (dead) {
        release(bars, s, lane);
        continue;
      }
      float sc[BK / 2], dp[BK / 2];
      uint32_t sa[BK / 16][4];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<BK>(sc, sw128_desc(sQ + (kk / 4) * G::Q_PANEL + wg * 64 * 128 + (kk % 4) * 32,
                                    16, 1024),
                     sw128_desc(sK + s * G::KV_BYTES + (kk / 4) * G::KV_PANEL + (kk % 4) * 32,
                                16, 1024),
                     kk > 0);
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<BK>(dp, sw128_desc(sO + (kk / 4) * G::Q_PANEL + wg * 64 * 128 + (kk % 4) * 32,
                                    16, 1024),
                     sw128_desc(sV + s * G::KV_BYTES + (kk / 4) * G::KV_PANEL + (kk % 4) * 32,
                                16, 1024),
                     kk > 0);
      wgmma_commit();

      const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > wq_lo) ||
                        (a.window > 0 && k0 <= wq_hi - a.window);
      wgmma_wait0();
      fence_regs(sc);
      fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const int qa = e < 2 ? qa0 : qa1;
          const bool ok = !edge || (col < a.Sk && (!a.causal || col <= qa) &&
                                    (a.window <= 0 || col > qa - a.window));
          const float p = ok ? exp2f(fmaf(sc[4 * j + e], sl2, -(e < 2 ? l20 : l21))) : 0.f;
          ds[e] = p * (dp[4 * j + e] - (e < 2 ? d0 : d1));
        }
        sa[j / 2][(j % 2) * 2 + 0] = pack_bf16(ds[0], ds[1]);
        sa[j / 2][(j % 2) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DH>(dq, sa[kk], sw128_desc(sK + s * G::KV_BYTES + kk * 16 * 128,
                                            G::KV_PANEL, 1024));
      wgmma_commit();
      wgmma_wait0();
      fence_regs(dq);
      release(bars, s, lane);
    }

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq) + b * a.dq_sb + h * a.dq_sh;
    __nv_bfloat16* o0 = out + static_cast<long long>(row0) * a.dq_ss + 2 * (lane % 4);
    __nv_bfloat16* o1 = o0 + 8 * a.dq_ss;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      if (row0 < a.Sq)
        *reinterpret_cast<uint32_t*>(o0 + 8 * j) =
            pack_bf16(dq[4 * j] * a.scale, dq[4 * j + 1] * a.scale);
      if (row0 + 8 < a.Sq)
        *reinterpret_cast<uint32_t*>(o1 + 8 * j) =
            pack_bf16(dq[4 * j + 2] * a.scale, dq[4 * j + 3] * a.scale);
    }
  }
}

// the pre-pass, dK/dV, then dQ, in the stream's order
template <int DH>
int launch_bwd(const FlashBwdArgs& a, cudaStream_t stream) {
  using KV = DkvTile<DH>;
  using Q = DqTile<DH>;
  EncodeTiled enc;
  int rc = encode_tiled(&enc);
  if (rc) return rc;
  flash_bwd_prep<DH><<<dim3(a.sq_pad / 8, a.B * a.H), 256, 0, stream>>>(a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;

  CUtensorMap tq, tk, tv, tdo;
  if ((rc = make_map(enc, &tq, a.q, DH, a.Sq, a.H, a.B, a.q_sb, a.q_ss, a.q_sh, KV::BQ)))
    return rc;
  if ((rc = make_map(enc, &tdo, a.dout, DH, a.Sq, a.H, a.B, a.dout_sb, a.dout_ss, a.dout_sh,
                     KV::BQ)))
    return rc;
  if ((rc = make_map(enc, &tk, a.k, DH, a.Sk, a.H, a.B, a.k_sb, a.k_ss, a.k_sh, kBwdBK)))
    return rc;
  if ((rc = make_map(enc, &tv, a.v, DH, a.Sk, a.H, a.B, a.v_sb, a.v_ss, a.v_sh, kBwdBK)))
    return rc;
  if ((rc = opt_in_smem<flash_bwd_dkdv<DH>>(KV::SMEM))) return rc;
  flash_bwd_dkdv<DH><<<dim3((a.Sk + kBwdBK - 1) / kBwdBK, a.B * a.H), kBwdThreads, KV::SMEM,
                       stream>>>(tq, tk, tv, tdo, a);
  if ((rc = static_cast<int>(cudaGetLastError()))) return rc;

  if ((rc = make_map(enc, &tq, a.q, DH, a.Sq, a.H, a.B, a.q_sb, a.q_ss, a.q_sh, kWgBQ)))
    return rc;
  if ((rc = make_map(enc, &tdo, a.dout, DH, a.Sq, a.H, a.B, a.dout_sb, a.dout_ss, a.dout_sh,
                     kWgBQ)))
    return rc;
  if ((rc = make_map(enc, &tk, a.k, DH, a.Sk, a.H, a.B, a.k_sb, a.k_ss, a.k_sh, Q::BK)))
    return rc;
  if ((rc = make_map(enc, &tv, a.v, DH, a.Sk, a.H, a.B, a.v_sb, a.v_ss, a.v_sh, Q::BK)))
    return rc;
  if ((rc = opt_in_smem<flash_bwd_dq<DH>>(Q::SMEM))) return rc;
  flash_bwd_dq<DH><<<dim3((a.Sq + kWgBQ - 1) / kWgBQ, a.B * a.H), kBwdThreads, Q::SMEM,
                     stream>>>(tq, tk, tv, tdo, a);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// One launch on `stream`; returns 0, a CUDA error code, or kTensorMapError
// plus the CUresult of a failed tensor-map encode.
int flash_attention_launch(const FlashArgs* args, void* stream) {
  const FlashArgs& a = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (a.Dh * 2 + a.bf16) {
    case 128: return launch_f32<64, 64>(a, s);
    case 256: return launch_f32<128, 64>(a, s);
    case 512: return launch_f32<256, 32>(a, s);
    case 129: return launch_bf16<64>(a, s);
    case 257: return launch_bf16<128>(a, s);
    case 513: return launch_bf16<256>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The backward: three launches on `stream` (pre-pass, dK/dV, dQ); returns as
// flash_attention_launch. Dh 64 or 128, bf16, sq_pad a multiple of 128.
int flash_attention_bwd_launch(const FlashBwdArgs* args, void* stream) {
  const FlashBwdArgs& a = *args;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.sq_pad % kPadRows || a.sq_pad < a.Sq) return static_cast<int>(cudaErrorInvalidValue);
  switch (a.Dh) {
    case 64: return launch_bwd<64>(a, s);
    case 128: return launch_bwd<128>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int err) {
  if (err >= kTensorMapError) return "cuTensorMapEncodeTiled refused the operand layout";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
