// Single-token GQA decode attention for Hopper: for each batch row b and kv
// head, the rep query heads of that group attend over the cache positions
// 0..pos[b], accumulated in float32 whatever the input type (bf16 or f32),
// the output in the input type:
//
//   out[b,g,r] = Σ_{j<=pos[b]} p_j v[b,j,g] / Σ p_j,
//   p_j = exp(s_j − max s),  s_j = q[b,g,r]·k[b,j,g] / sqrt(Dh).
//
// Replaces the Pallas TPU kernel repro/kernels/decode_attention.py::
// decode_attention_pallas (body _decode_kernel). The TPU kernel transposes
// the cache to (B·KV, S, Dh), runs a sequential grid over cache blocks with
// (m, l, acc) in VMEM scratch, skips blocks past pos, and asserts
// S % block_s == 0. Here, flash-decoding in one launch:
//
//   one block per (b·kv, cache chunk), the kv heads of one position
//   neighbours in the grid so that they read neighbouring cache lines. The
//   block reads its chunk of the (B,S,KV,Dh) caches in place through their
//   strides (no transpose copy), and only the positions <= pos[b]: a chunk
//   past pos[b] reads nothing. Each of its warps (four, or eight where
//   the grid is too small to fill the card or the chunk is long) streams
//   its own stages of the chunk (2 KB of K and 2 KB of V each; stages w,
//   w + warps, ...) through its own ring of three shared-memory slots,
//   filled by cp.async two stages ahead of the one it computes, with no
//   block-wide barrier in the loop: lanes split a row into 16-byte
//   pieces, so a warp reads whole 128-byte lines, and K and V are both in
//   flight before the first score.
//   In bf16 at Dh 64 (the serve and long-cache shapes) the warp scores its
//   16-row stage on the tensor cores: S = Q·Kᵀ and O += P·V by mma.sync
//   m16n8k16 with the rep heads padded to 16 rows, K and V read by
//   ldmatrix from the stage (its 16-byte pieces swizzled by row, so the
//   reads are free of bank conflicts), P rounded to bf16 for the second
//   product (ROADMAP hazard H15). The CUDA-core route, for float32 and the
//   other head dims: the lanes of a row score it for every head (the k row
//   read once, q scaled by scale·log2 e so that exp2 gives the softmax),
//   the warp's max by shuffles, the running sums rescaled only when the
//   max moves, each lane accumulating p·v for its pieces of the row. Both
//   run the online softmax over the stage in registers; the warps' (m, l,
//   acc) are merged through shared memory in warp order.
//   The block writes its chunk's (m, l, acc) to float32 scratch; the last
//   block of its (b, kv) group to arrive, found by an atomic ticket, merges
//   the group's chunks in chunk order (so the result does not depend on
//   the order blocks finish: repeated calls are bitwise equal): the
//   chunks' (m, l) go to shared memory in one burst, one thread per head
//   turns them into weights and the merged sum, then one warp per head
//   sums its output over the chunks, a batch of chunks' loads in flight at
//   a time, and scales by 1 / the merged sum (>= 1e-30). It sets the
//   ticket back to 0.
//
// The chunk size and the warps per block are chosen by the wrapper so that
// B·KV·chunks fills the card; S need not divide the chunk. Bound: bytes
// (the cache rows <= pos, read once); about one operation per byte, so the
// tensor cores help only by leaving the warps free to keep loads in flight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Mirrors the ctypes.Structure in repro_torch/kernels/decode_attention.py.
// q/out (B,KV,rep,Dh) contiguous; k/v caches (B,S,KV,Dh) with element
// strides sb, ss, skv (unit stride on Dh, rows 16-byte aligned); pos (B,)
// int32; part_m/part_l (B·KV, nsplit, rep), part_acc (B·KV, nsplit, rep,
// Dh) float32 scratch; tickets (B·KV,) int32, 0 between calls.
struct DecodeArgs {
  int B, S, KV, rep, Dh;
  int chunk, nsplit;  // positions per block, blocks per (b, kv) group
  int warps;          // per block: 4 or 8
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
  int* tickets;
  void* out;
};

namespace {
constexpr int kWarpStage = 2048;  // bytes of K (and of V) per warp stage
constexpr int kRing = 3;           // stages in each warp's ring
constexpr int kAhead = kRing - 1;  // stages in flight ahead of the computed one
constexpr int kRepMax = 16;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// one 16-byte piece as float32 (8 bf16 or 4 float32)
__device__ __forceinline__ void unpack(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void unpack(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}
// four 8x8 bf16 matrices; lanes 8j..8j+7 give the row addresses of matrix j
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T, int DH>
struct Plan {
  static constexpr int EPV = 16 / sizeof(T);                 // elements per piece
  static constexpr int VPR = DH / EPV;                       // pieces per row
  static constexpr int LPR = VPR < 32 ? VPR : 32;            // lanes per row
  static constexpr int VPL = VPR / LPR;                      // pieces per lane
  static constexpr int EPL = VPL * EPV;                      // elements per lane
  static constexpr int RG = 32 / LPR;                        // rows a warp takes at once
  static constexpr int TR = kWarpStage / (DH * sizeof(T));   // rows per warp stage
  static constexpr int PASSES = TR / RG;                     // rows per lane per stage
  static_assert(TR % RG == 0 && VPR % LPR == 0, "row split");
};

// shared memory of a block of nw warps: the warps' rings, reused after the
// loop for the warps' (rep, Dh) sums and the merge's (m, l); then q in float32
__host__ __device__ constexpr int region_bytes(int nw, int Dh, int rb) {
  return nw * kRing * 2 * kWarpStage > nw * rb * Dh * 4 ? nw * kRing * 2 * kWarpStage
                                                        : nw * rb * Dh * 4;
}
size_t smem_bytes(int nw, int Dh, int rb) {
  return static_cast<size_t>(region_bytes(nw, Dh, rb)) + sizeof(float) * static_cast<size_t>(rb) * Dh;
}

// wait until at most n of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    default: cp_async_wait<kAhead>(); break;
  }
}

// grid (B·KV, nsplit), NW warps; RB >= rep bounds the register arrays
template <typename T, int DH, int RB, int NW>
__global__ void __launch_bounds__(NW * 32) decode_kernel(DecodeArgs a) {
  using P = Plan<T, DH>;
  constexpr int EPV = P::EPV, VPR = P::VPR, LPR = P::LPR, VPL = P::VPL, EPL = P::EPL;
  constexpr int RG = P::RG, TR = P::TR, PASSES = P::PASSES;
  constexpr int kThreads = NW * 32;
  // bf16 at Dh 64 (the serve and 32k shapes) scores and accumulates on the
  // tensor cores; the other types and head dims on the CUDA cores
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value && DH == 64;
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);  // [NW warps][kRing stages][K, V][TR][DH]
  float* sq = reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + region_bytes(NW, DH, RB));
  __shared__ float warp_m[NW][RB], warp_l[NW][RB], inv_l[RB];
  __shared__ int ticket;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = lane / LPR, ll = lane % LPR;  // row group, lane in the row
  const int rep = a.rep, chunk = a.chunk;
  const int bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / a.KV, g = bkv % a.KV;
  const int n_valid = min(a.pos[b] + 1, a.S);
  const int c0 = split * chunk;
  const int n = min(c0 + chunk, n_valid) - c0;  // positions of this chunk
  const size_t pi = static_cast<size_t>(bkv) * a.nsplit + split;

  if (n > 0) {
    const T* kb = static_cast<const T*>(a.k) + b * a.sb + g * a.skv;
    const T* vb = static_cast<const T*>(a.v) + b * a.sb + g * a.skv;
    // this warp's stages of the chunk: warp, warp + NW, ...
    const int n_st = (n + TR - 1) / TR;
    const int mine = n_st > warp ? (n_st - warp + NW - 1) / NW : 0;
    T* wring = ring + warp * kRing * 2 * TR * DH;
    auto issue = [&](int k) {  // the warp's k-th stage into its slot k % kRing
      const int r0 = (warp + NW * k) * TR, nt = min(TR, n - r0);
      T* K = wring + (k % kRing) * 2 * TR * DH;
      T* V = K + TR * DH;
      for (int i = lane; i < nt * VPR; i += 32) {
        const int j = i / VPR, pc = i % VPR;
        const int at = kMma ? pc ^ (j & 7) : pc;  // swizzled: ldmatrix reads it conflict-free
        const long long off = (c0 + r0 + j) * a.ss + pc * EPV;
        cp_async16(K + j * DH + at * EPV, kb + off);
        cp_async16(V + j * DH + at * EPV, vb + off);
      }
      if constexpr (kMma) {  // rows past the chunk are zeros: 0 · v stays 0
        for (int i = nt * VPR + lane; i < TR * VPR; i += 32) {
          *reinterpret_cast<uint4*>(K + i * EPV) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(V + i * EPV) = make_uint4(0, 0, 0, 0);
        }
      }
      cp_async_commit();
    };
    for (int k = 0; k < min(kAhead, mine); ++k) issue(k);
    const T* qg = static_cast<const T*>(a.q) + static_cast<size_t>(bkv) * rep * DH;
    // q·k comes out in log2 units: exp2 of a difference is exp of the scaled one
    const float qscale = a.scale * 1.4426950408889634f;
    float* wacc = reinterpret_cast<float*>(smem4);  // after the loop: (NW, rep, DH)
    if constexpr (!kMma) {
    for (int i = tid; i < rep * DH; i += kThreads) sq[i] = to_f(qg[i]) * qscale;
    __syncthreads();  // q
    // the lane's slice of q for every head, in registers when it is small
    constexpr bool QREG = RB * EPL <= 64;
    float qr[QREG ? RB : 1][QREG ? EPL : 1];
    if constexpr (QREG) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int vi = 0; vi < VPL; ++vi)
#pragma unroll
          for (int e = 0; e < EPV; ++e)
            qr[r][vi * EPV + e] = r < rep ? sq[r * DH + (ll + LPR * vi) * EPV + e] : 0.f;
    }

    float m[RB], l[RB], acc[RB][EPL];  // m is the warp's; l, acc this row group's
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }
    for (int k = 0; k < mine; ++k) {
      if (k + kAhead < mine) issue(k + kAhead);
      cp_async_wait_n(min(mine - 1 - k, kAhead));
      __syncwarp();  // every lane's copies of stage k visible to the warp
      const T* K = wring + (k % kRing) * 2 * TR * DH;
      const T* V = K + TR * DH;
      const int nt = min(TR, n - (warp + NW * k) * TR);

      // scores: the LPR lanes of a row split it, the k row read once for
      // every head
      float s[PASSES][RB];
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int j = p * RG + rg;
        float part[RB];
#pragma unroll
        for (int r = 0; r < RB; ++r) part[r] = 0.f;
        if (j < nt) {
#pragma unroll
          for (int vi = 0; vi < VPL; ++vi) {
            const int d = (ll + LPR * vi) * EPV;
            float kf[EPV];
            unpack(K + j * DH + d, kf);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r < rep) {
                if constexpr (QREG) {
#pragma unroll
                  for (int e = 0; e < EPV; ++e) part[r] = fmaf(qr[r][vi * EPV + e], kf[e], part[r]);
                } else {
#pragma unroll
                  for (int e = 0; e < EPV; e += 4) {
                    const float4 qv = *reinterpret_cast<const float4*>(sq + r * DH + d + e);
                    part[r] = fmaf(qv.x, kf[e], part[r]);
                    part[r] = fmaf(qv.y, kf[e + 1], part[r]);
                    part[r] = fmaf(qv.z, kf[e + 2], part[r]);
                    part[r] = fmaf(qv.w, kf[e + 3], part[r]);
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < rep) {
#pragma unroll
            for (int off = 1; off < LPR; off <<= 1)
              part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
          }
          s[p][r] = j < nt ? part[r] : kNegInf;
        }
      }
      // online softmax over the stage: the warp's max per head, p in place
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < rep) {
          float mt = s[0][r];
#pragma unroll
          for (int p = 1; p < PASSES; ++p) mt = fmaxf(mt, s[p][r]);
#pragma unroll
          for (int off = LPR; off < 32; off <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
          if (mt > m[r]) {  // warp-uniform: rescale only when the max moves
            const float corr = exp2f(m[r] - mt);
            m[r] = mt;
            l[r] *= corr;
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[r][e] *= corr;
          }
#pragma unroll
          for (int p = 0; p < PASSES; ++p) {
            const float pv = s[p][r] == kNegInf ? 0.f : exp2f(s[p][r] - m[r]);
            s[p][r] = pv;
            l[r] += pv;
          }
        }
      }
      // Σ p·v over the row group's rows, the v row read once for every head
#pragma unroll
      for (int p = 0; p < PASSES; ++p) {
        const int j = p * RG + rg;
        if (j < nt) {
#pragma unroll
          for (int vi = 0; vi < VPL; ++vi) {
            float vf[EPV];
            unpack(V + j * DH + (ll + LPR * vi) * EPV, vf);
#pragma unroll
            for (int r = 0; r < RB; ++r) {
              if (r < rep) {
#pragma unroll
                for (int e = 0; e < EPV; ++e)
                  acc[r][vi * EPV + e] = fmaf(s[p][r], vf[e], acc[r][vi * EPV + e]);
              }
            }
          }
        }
      }
      __syncwarp();  // slot k % kRing free for the warp's next issue
    }

    // the warp's row groups summed (a fixed shuffle tree), then the warps
    // merged through shared memory, in warp order
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rep) {
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
        }
      }
    }
    __syncthreads();  // every warp is done with the ring
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < rep) {
        if (lane == 0) {
          warp_m[warp][r] = m[r];
          warp_l[warp][r] = l[r];
        }
        if (rg == 0) {
#pragma unroll
          for (int vi = 0; vi < VPL; ++vi)
#pragma unroll
            for (int e = 0; e < EPV; ++e)
              wacc[(warp * rep + r) * DH + (ll + LPR * vi) * EPV + e] = acc[r][vi * EPV + e];
        }
      }
    }
    } else {
    // tensor cores: S = Q·Kᵀ and O += P·V by mma.sync m16n8k16, the heads
    // padded to 16 rows, K and V read from the swizzled stage by ldmatrix;
    // P is rounded to bf16 for the second product (as in the flash kernel,
    // ROADMAP hazard H15), l taken from the float32 p
    static_assert(TR == 16, "a stage is one k16 step of keys");
    const int gq = lane / 4, tq = lane % 4;  // fragment row (head) and column pair
    const int mat = lane / 8, r8 = lane % 8;  // ldmatrix: matrix and row this lane addresses
    uint32_t qa[DH / 16][4];                  // the A fragments of q, rows >= rep zero
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(qg);
#pragma unroll
    for (int kt = 0; kt < DH / 16; ++kt) {
      const int c = 8 * kt + tq;  // the bf16 pair at columns 16 kt + 2 tq
      qa[kt][0] = gq < rep ? q32[gq * (DH / 2) + c] : 0u;
      qa[kt][1] = gq + 8 < rep ? q32[(gq + 8) * (DH / 2) + c] : 0u;
      qa[kt][2] = gq < rep ? q32[gq * (DH / 2) + c + 4] : 0u;
      qa[kt][3] = gq + 8 < rep ? q32[(gq + 8) * (DH / 2) + c + 4] : 0u;
    }
    float o[DH / 8][4];
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads gq and gq + 8
    for (int k = 0; k < mine; ++k) {
      if (k + kAhead < mine) issue(k + kAhead);
      cp_async_wait_n(min(mine - 1 - k, kAhead));
      __syncwarp();  // every lane's copies of stage k visible to the warp
      const T* K = wring + (k % kRing) * 2 * TR * DH;
      const uint32_t ks = smem_u32(K), vs = smem_u32(K + TR * DH);
      const int nt = min(TR, n - (warp + NW * k) * TR);
      float sc[2][4] = {};  // keys 0-7 and 8-15
#pragma unroll
      for (int kt = 0; kt < DH / 16; ++kt) {
        const int key = (mat / 2) * 8 + r8, ch = 2 * kt + mat % 2;
        uint32_t bk[4];
        ldmatrix_x4(bk, ks + (key * DH + (ch ^ (key & 7)) * 8) * 2);
        mma_bf16(sc[0], qa[kt], bk[0], bk[1]);
        mma_bf16(sc[1], qa[kt], bk[2], bk[3]);
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = 8 * h + 2 * tq + (e & 1) < nt ? sc[h][e] * qscale : kNegInf;
          sc[h][e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float corr0 = exp2f(m0 - mx0), corr1 = exp2f(m1 - mx1);
      m0 = mx0;
      m1 = mx1;
      l0 *= corr0;
      l1 *= corr1;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[j][0] *= corr0;
        o[j][1] *= corr0;
        o[j][2] *= corr1;
        o[j][3] *= corr1;
      }
      // a masked score is −1e30 and the stage's first key is live, so its
      // exp2 argument stays finite and gives 0
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[h][e] = exp2f(sc[h][e] - (e < 2 ? m0 : m1));
          if (e < 2) l0 += sc[h][e];
          else l1 += sc[h][e];
        }
      // the S fragments of keys 0-7 and 8-15 are the A fragment of P·V
      const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                              pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        const int key = (mat % 2) * 8 + r8, ch = 2 * np + mat / 2;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (key * DH + (ch ^ (key & 7)) * 8) * 2);
        mma_bf16(o[2 * np], pa, bv[0], bv[1]);
        mma_bf16(o[2 * np + 1], pa, bv[2], bv[3]);
      }
      __syncwarp();  // slot k % kRing free for the warp's next issue
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the four lanes of a head
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    __syncthreads();  // every warp is done with the ring
    if (tq == 0) {
      if (gq < rep) {
        warp_m[warp][gq] = m0;
        warp_l[warp][gq] = l0;
      }
      if (gq + 8 < rep) {
        warp_m[warp][gq + 8] = m1;
        warp_l[warp][gq + 8] = l1;
      }
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int d = 8 * j + 2 * tq;
      if (gq < rep) {
        wacc[(warp * rep + gq) * DH + d] = o[j][0];
        wacc[(warp * rep + gq) * DH + d + 1] = o[j][1];
      }
      if (gq + 8 < rep) {
        wacc[(warp * rep + gq + 8) * DH + d] = o[j][2];
        wacc[(warp * rep + gq + 8) * DH + d + 1] = o[j][3];
      }
    }
    }
    __syncthreads();
    float* pacc = a.part_acc + pi * rep * DH;
    for (int i = tid; i < rep * DH; i += kThreads) {
      const int r = i / DH;
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < NW; ++w) mx = fmaxf(mx, warp_m[w][r]);
      float t = 0.f, lt = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float wt = exp2f(warp_m[w][r] - mx);
        t = fmaf(wacc[(w * rep + r) * DH + i % DH], wt, t);
        lt = fmaf(warp_l[w][r], wt, lt);
      }
      pacc[i] = t;
      if (i % DH == 0) {
        a.part_m[pi * rep + r] = mx;
        a.part_l[pi * rep + r] = lt;
      }
    }
  }

  // the last block of the group to arrive merges the group's chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) ticket = atomicAdd(a.tickets + bkv, 1);
  __syncthreads();
  if (ticket != a.nsplit - 1) return;
  __threadfence();
  const int nv = n_valid > 0 ? min((n_valid + chunk - 1) / chunk, a.nsplit) : 0;
  const size_t base = static_cast<size_t>(bkv) * a.nsplit;
  // 1. every (chunk, head)'s m and l into shared memory at once
  const int n_w = nv * rep;
  float* wm = reinterpret_cast<float*>(smem4);  // (nv, rep) m, then weights
  float* wl = wm + n_w;                          // (nv, rep) l
  for (int p = tid; p < n_w; p += kThreads) {
    wm[p] = __ldcg(a.part_m + base * rep + p);
    wl[p] = __ldcg(a.part_l + base * rep + p);
  }
  __syncthreads();
  // 2. one thread per head: the max, the weights and the merged sum, in
  //    chunk order
  if (tid < rep) {
    float mx = kNegInf;
    for (int c = 0; c < nv; ++c) mx = fmaxf(mx, wm[c * rep + tid]);
    float lt = 0.f;
    for (int c = 0; c < nv; ++c) {
      const float w = exp2f(wm[c * rep + tid] - mx);
      wm[c * rep + tid] = w;
      lt = fmaf(wl[c * rep + tid], w, lt);
    }
    inv_l[tid] = 1.f / fmaxf(lt, 1e-30f);
  }
  __syncthreads();
  // 3. one warp per head, lanes over Dh: Σ_c w_c acc_c in chunk order, a
  //    batch of chunks' loads in flight at a time
  constexpr int EW = DH / 32;  // elements per lane
  constexpr int CB = 8;        // chunks per batch
  const float* pacc = a.part_acc + base * rep * DH;
  T* out = static_cast<T*>(a.out) + static_cast<size_t>(bkv) * rep * DH;
  for (int r = warp; r < rep; r += NW) {
    float o[EW];
#pragma unroll
    for (int u = 0; u < EW; ++u) o[u] = 0.f;
    for (int cb = 0; cb < nv; cb += CB) {
      float x[CB][EW];
#pragma unroll
      for (int c = 0; c < CB; ++c)
#pragma unroll
        for (int u = 0; u < EW; ++u)
          x[c][u] = cb + c < nv
              ? __ldcg(pacc + (static_cast<size_t>(cb + c) * rep + r) * DH + lane + 32 * u)
              : 0.f;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        if (cb + c < nv) {
          const float w = wm[(cb + c) * rep + r];
#pragma unroll
          for (int u = 0; u < EW; ++u) o[u] = fmaf(x[c][u], w, o[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < EW; ++u) from_f(out + r * DH + lane + 32 * u, o[u] * inv_l[r]);
  }
  if (tid == 0) a.tickets[bkv] = 0;  // every block of the group has its ticket
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

template <typename T, int DH, int RB, int NW>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(NW, DH, RB);
  const int err = opt_in_smem<decode_kernel<T, DH, RB, NW>>(smem);
  if (err) return err;
  decode_kernel<T, DH, RB, NW><<<dim3(a.B * a.KV, a.nsplit), NW * 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH, int RB>
int launch_warps(const DecodeArgs& a, cudaStream_t stream) {
  return a.warps == 8 ? launch<T, DH, RB, 8>(a, stream) : launch<T, DH, RB, 4>(a, stream);
}

template <typename T, int DH>
int launch_rep(const DecodeArgs& a, cudaStream_t stream) {
  if (a.rep <= 4) return launch_warps<T, DH, 4>(a, stream);
  if (a.rep <= 8) return launch_warps<T, DH, 8>(a, stream);
  return launch_warps<T, DH, kRepMax>(a, stream);
}

template <typename T>
int launch_dh(const DecodeArgs& a, cudaStream_t stream) {
  switch (a.Dh) {
    case 64: return launch_rep<T, 64>(a, stream);
    case 128: return launch_rep<T, 128>(a, stream);
    case 256: return launch_rep<T, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int rep_bound(int rep) { return rep <= 4 ? 4 : rep <= 8 ? 8 : kRepMax; }
}  // namespace

extern "C" {

int decode_attention_rep_max() { return kRepMax; }

// the most (chunk, head) pairs whose (m, l) the merge holds in shared memory
size_t decode_attention_max_weights(int rep, int Dh, int warps) {
  return region_bytes(warps, Dh, rep_bound(rep)) / (2 * sizeof(float));
}

size_t decode_attention_smem(int rep, int Dh, int warps) {
  return smem_bytes(warps, Dh, rep_bound(rep));
}

// One launch on `stream`; returns the CUDA error code (0 = ok).
int decode_attention_launch(const DecodeArgs* args, void* stream) {
  const DecodeArgs a = *args;
  if (a.rep < 1 || a.rep > kRepMax || (a.warps != 4 && a.warps != 8) ||
      static_cast<size_t>(a.nsplit) * a.rep > decode_attention_max_weights(a.rep, a.Dh, a.warps))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.bf16 ? launch_dh<__nv_bfloat16>(a, s) : launch_dh<float>(a, s);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
