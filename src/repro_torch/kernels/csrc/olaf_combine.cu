// OLAF burst combine for Hopper: land a window of U weighted updates into
// the Q cluster slots of each of S switch queues (running mean), and with
// it the forwarding pass of the boundary, in ONE launch.
//
//   cnt[s,q]  = reset[s,q] ? 0 : count[s,q]
//   new[s,q]  = (slot[s,q]·cnt[s,q] + Σ_{u: cluster[s,u]=q} gate[s,u]·upd[s,u])
//               / max(cnt[s,q] + hits[s,q], 1),   hits[s,q] = Σ_{u: cluster=q} gate
//   new_count[s,q] = cnt[s,q] + hits[s,q]
//   then, for each departing (drain_sw[k], drain_slot[k]):
//   drained[k] = hop[k] < -1 ? 0 : new[sw, slot];  new[sw, slot] = 0, new_count = 0
//
// Replaces the Pallas TPU kernel repro/kernels/olaf_combine.py::
// olaf_combine_pallas (body _combine_kernel), and with it the rest of
// repro/kernels/ops.py::olaf_forward (the reset-mask zeroing of the counts,
// the gather of the departing rows from the post-combine buffer, the clear
// of their slots and counts, and the hop mask), which repro jits into the
// same XLA dispatch. A drain-only boundary (land = 0, U = 0) copies the
// slots and counts unchanged, then drains, as olaf_forward skips the
// combine there. The TPU kernel makes the segment sum a one-hot
// (Qt,U)x(U,Dt) MXU product per grid step; here the segment sum is taken
// directly, which needs no matrix unit.
//
// Bound: bytes. The function needs the contributing update rows, the slot
// rows whose old value weighs in, the slot rows that change and the drained
// rows; this kernel also reads and writes every other slot row (fresh
// output buffers, every slot rewritten as x·c/c the way the plain version
// and repro do; chip_smoke.py counts both). About two flops per element
// moved. The design:
//
//   * One launch on a (blocks per switch, S) grid sized to the card. Each
//     block stages its switch's gates, counts, reset flags and drain list
//     into shared memory once, behind one barrier, then walks work items
//     (slot, column tile), slot-major so that the blocks of a switch stream
//     a row together. The contributing rows of each slot (gate != 0 and
//     cluster == the slot) are a bit mask per 32 updates, one __ballot_sync
//     per slot and 32 updates while staging, so an item takes its rows in
//     ascending u by __ffs with no per-slot list to build behind more
//     barriers.
//   * A thread owns kCols columns strided by the block width (coalesced,
//     4-byte accesses: D is odd on every path, so rows sit at every offset
//     modulo 16 bytes and wide or bulk copies do not apply) and loads the
//     slot's old row and up to kAhead contributing rows before their adds.
//     Two instances: 4 columns and 4 blocks per SM where D fits one
//     1024-column tile (the hybrid's D = 941: latency), 8 columns and 2
//     blocks per SM otherwise (more blocks streamed more rows at once and
//     ran slower at the fat-tree shape).
//   * Products rounded and then added in ascending u (__fmul_rn /
//     __fadd_rn, no contraction), as the plain version's index_add_ order
//     gives them: no atomics touch a payload, so the event and window
//     replays of the hybrid give the same bits on every run.
//   * A row weighs in only in the slot it names, so a non-finite element
//     of one update reaches only that slot (ROADMAP hazard H9).
//   * Blocks share nothing but read-only inputs: a departing row is
//     written by the block that computes its slot's tile, while the value
//     is in registers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 4;  // contributing rows loaded before their adds
constexpr unsigned kFull = 0xffffffffu;
}  // namespace

// Mirrors the ctypes.Structure in repro_torch/kernels/olaf_combine.py
// (tests/test_torch_kernel_abi.py checks it). All row-major, contiguous, on
// one device: slots/out (S,Q,D), counts/out_counts/reset (S,Q), updates
// (S,U,D), clusters/gate (S,U), drain_* (K,), drained (K,D).
struct OlafCombineArgs {
  int S, Q, U, D, K;
  int land;  // 1: land the window; 0: a drain-only boundary (copy, then drain)
  const float* slots;
  const int* counts;
  const float* updates;
  const int* clusters;
  const int* gate;
  const bool* reset;       // null: no slot restarts
  const int* drain_sw;     // null with K = 0; negative wraps as in torch
  const int* drain_slot;
  const int* drain_hop;    // null: every drained row kept
  float* out;
  int* out_counts;
  float* drained;
};

template <int N>
__device__ __forceinline__ void load_cols(float (&v)[N], const float* row,
                                          int d0, int D) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int d = d0 + j * kThreads;
    v[j] = d < D ? row[d] : 0.0f;
  }
}

template <int N>
__device__ __forceinline__ void store_cols(float* row, int d0, int D,
                                           const float (&v)[N], bool zero) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int d = d0 + j * kThreads;
    if (d < D) row[d] = zero ? 0.0f : v[j];
  }
}

// The contributing updates of one slot, in ascending u, from its bit masks
// (W words of 32 updates).
struct Rows {
  const unsigned* mask;
  int W, c;
  unsigned m;
  __device__ Rows(const unsigned* slot_mask, int words)
      : mask(slot_mask), W(words), c(0), m(words > 0 ? slot_mask[0] : 0u) {}
  __device__ __forceinline__ int next(int none) {  // `none` past the last
    while (m == 0) {
      if (++c >= W) return none;
      m = mask[c];
    }
    const int u = c * 32 + __ffs(m) - 1;
    m &= m - 1;
    return u;
  }
};

template <int kCols, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
olaf_combine_kernel(OlafCombineArgs a) {
  constexpr int kTile = kThreads * kCols;  // columns per work item
  extern __shared__ int sh[];
  const int S = a.S, Q = a.Q, U = a.U, D = a.D, K = a.K;
  const int s = blockIdx.y, tid = threadIdx.x;
  const int W = (U + 31) / 32;
  const size_t Dz = static_cast<size_t>(D);
  int* cnt = sh;             // (Q) counts entering the combine
  int* gt = cnt + Q;         // (U) gate per update
  unsigned* mask = reinterpret_cast<unsigned*>(gt + U);  // (Q, W) contributing bits
  int* dsw = reinterpret_cast<int*>(mask + Q * W);  // (K) departing switch, -1 out of range
  int* dslot = dsw + K;      // (K) departing slot
  int* dkeep = dslot + K;    // (K) hop >= -1

  const size_t q0 = static_cast<size_t>(s) * Q;
  const size_t u0 = static_cast<size_t>(s) * U;
  for (int q = tid; q < Q; q += kThreads) {
    const bool restart = a.land && a.reset != nullptr && a.reset[q0 + q];
    cnt[q] = restart ? 0 : a.counts[q0 + q];
  }
  for (int c = tid / 32; c < W; c += kWarps) {  // a warp per 32 updates
    const int lane = tid & 31, u = c * 32 + lane;
    const int cu = u < U ? a.clusters[u0 + u] : -1;
    const int gu = u < U ? a.gate[u0 + u] : 0;
    if (u < U) gt[u] = gu;
    for (int q = 0; q < Q; ++q) {
      const unsigned bits = __ballot_sync(kFull, cu == q && gu != 0);
      if (lane == 0) mask[q * W + c] = bits;
    }
  }
  for (int k = tid; k < K; k += kThreads) {
    int w = a.drain_sw[k], q = a.drain_slot[k];
    w += w < 0 ? S : 0;
    q += q < 0 ? Q : 0;
    const bool inside = w >= 0 && w < S && q >= 0 && q < Q;
    dsw[k] = inside ? w : -1;
    dslot[k] = inside ? q : -1;
    dkeep[k] = a.drain_hop == nullptr || a.drain_hop[k] >= -1;
  }
  __syncthreads();

  const float* upd = a.updates + u0 * Dz;
  if (blockIdx.x == 0)
    for (int q = tid; q < Q; q += kThreads) {
      int hits = 0, popped = 0;  // a gate-0 entry adds nothing
      Rows rows(mask + q * W, W);
      for (int u = rows.next(U); u < U; u = rows.next(U)) hits += gt[u];
      for (int k = 0; k < K; ++k) popped |= dsw[k] == s && dslot[k] == q;
      a.out_counts[q0 + q] = popped ? 0 : cnt[q] + (a.land ? hits : 0);
    }

  // work items (slot or departing row, column tile)
  const float* slot = a.slots + q0 * Dz;
  float* out = a.out + q0 * Dz;
  const unsigned ntiles = (D + kTile - 1) / kTile;
  const unsigned items = ntiles * (Q + K);
  for (unsigned it = blockIdx.x; it < items; it += gridDim.x) {
    const int q = static_cast<int>(it / ntiles);
    const int d0 = static_cast<int>(it - q * ntiles) * kTile + tid;
    float v[kCols];
    if (q >= Q) {  // a departing row naming no slot: zeros, written by switch 0
      const int k = q - Q;
      if (s == 0 && dsw[k] < 0) store_cols(a.drained + k * Dz, d0, D, v, true);
      continue;
    }
    load_cols(v, slot + q * Dz, d0, D);
    if (a.land) {
      float sum[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) sum[j] = 0.0f;
      int hits = 0;
      Rows rows(mask + q * W, W);
      for (int u = rows.next(U); u < U;) {  // kAhead rows, then their adds
        int idx[kAhead];
        float r[kAhead][kCols];
        idx[0] = u;
#pragma unroll
        for (int i = 1; i < kAhead; ++i) idx[i] = idx[i - 1] < U ? rows.next(U) : U;
#pragma unroll
        for (int i = 0; i < kAhead; ++i)
          if (idx[i] < U) load_cols(r[i], upd + idx[i] * Dz, d0, D);
#pragma unroll
        for (int i = 0; i < kAhead; ++i)
          if (idx[i] < U) {
            const float g = static_cast<float>(gt[idx[i]]);
            hits += gt[idx[i]];
#pragma unroll
            for (int j = 0; j < kCols; ++j) sum[j] = __fadd_rn(sum[j], __fmul_rn(g, r[i][j]));
          }
        u = idx[kAhead - 1] < U ? rows.next(U) : U;
      }
      const float c = static_cast<float>(cnt[q]);
      const int n = cnt[q] + hits;
      const float nf = static_cast<float>(n > 1 ? n : 1);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        v[j] = __fdiv_rn(__fadd_rn(__fmul_rn(v[j], c), sum[j]), nf);
    }
    bool popped = false;
    for (int k = 0; k < K; ++k) popped |= dsw[k] == s && dslot[k] == q;
    store_cols(out + q * Dz, d0, D, v, popped);
    if (popped)  // departs: its rows carry the post-combine values
      for (int k = 0; k < K; ++k)
        if (dsw[k] == s && dslot[k] == q)
          store_cols(a.drained + k * Dz, d0, D, v, !dkeep[k]);
  }
}

extern "C" size_t olaf_combine_smem_words(int Q, int U, int K);

template <int kCols, int kMinBlocks>
static int launch_with(const OlafCombineArgs& a, cudaStream_t st, int sms) {
  const long long tiles = (a.D + kThreads * kCols - 1) / (kThreads * kCols);
  const long long items = tiles * (a.Q + a.K);
  const long long fill = (static_cast<long long>(sms) * kMinBlocks + a.S - 1) / a.S;
  const int per_switch = static_cast<int>(items < fill ? (items > 0 ? items : 1) : fill);
  dim3 grid(per_switch, a.S);
  olaf_combine_kernel<kCols, kMinBlocks>
      <<<grid, kThreads, olaf_combine_smem_words(a.Q, a.U, a.K) * sizeof(int), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

// Dynamic shared memory of one block, in 4-byte words.
size_t olaf_combine_smem_words(int Q, int U, int K) {
  const size_t W = (static_cast<size_t>(U) + 31) / 32;
  return static_cast<size_t>(Q) * (1 + W) + static_cast<size_t>(U) +
         3 * static_cast<size_t>(K);
}

// One launch on `stream`; returns cudaGetLastError() (0 = ok).
int olaf_combine_launch(const OlafCombineArgs* args, void* stream) {
  const OlafCombineArgs a = *args;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return a.D <= kThreads * 4 ? launch_with<4, 4>(a, st, sms)
                             : launch_with<8, 2>(a, st, sms);
}

const char* olaf_combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
