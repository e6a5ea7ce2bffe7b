// Fused OLAF data-plane cycle for Hopper: burst enqueue (Algorithm 1) then
// drain-k, for S independent queues, in ONE launch.
//
// Replaces the Pallas TPU kernel repro/kernels/olaf_step.py::olaf_step_pallas
// (body _olaf_step_kernel, with olaf_combine.py::alg1_resolve). It is held to
// the sequential oracle repro/core/olaf_queue.py::_burst_resolve +
// jax_dequeue_burst, not to alg1_resolve: the queue is full by COUNT
// (occupied >= capacity) and an append takes the first empty slot at ANY
// index (ROADMAP hazard H1).
//
// The same launch with K = 0 and every row sent (olaf_enqueue_launch)
// replaces repro/kernels/olaf_combine.py::olaf_enqueue_pallas (body
// _enqueue_kernel), the enqueue-only half of the cycle; it is held to
// repro/core/olaf_queue.py::jax_enqueue_burst the same way.
//
// Bound: bytes. Per cycle this kernel reads the contributing burst rows,
// writes every slot row the burst touches or the drain pops and reads those
// that no reset in the burst restarts, and writes the k drained rows; the
// least the cycle needs is a little smaller (no write of an empty slot the
// drain pops: chip_smoke.py's cycle_cost counts both). The arithmetic is
// about one add per burst element. At the trainer's shapes the cycle is
// latency: a few dependent memory round trips and the launch itself.
//
// On the TPU the grid steps ran in order and shared scratch; CUDA blocks
// do not. The design:
//
//   * One launch on a (blocks per queue, S) grid sized to the card. Every
//     block of queue s stages the queue's metadata and the burst's with
//     coalesced loads into shared memory, and one warp walks Algorithm 1
//     with the first kRegSlots slots held in its registers (slot q in lane
//     q % 32, in two named copies: an indexed register array would be
//     placed in local memory): ballots find the hit, the empty slot and the
//     occupancy, shuffles fetch the hit slot's fields from their lane and
//     broadcast each update's, and the lane that holds a slot updates it.
//     No memory access lies on the U-step chain below kRegSlots slots. Then
//     the warp builds the CSR of contributing updates in ascending u (counts by
//     shared atomics, an order-free result; ranks by __match_any_sync)
//     while the block ranks the slots for drain-k (each slot's rank among
//     the (seq, slot) keys). Every block computes the same plan from the
//     same pre-burst state, bit for bit.
//   * The plan never leaves shared memory. Each block then walks work items
//     (slot, column tile), slot-major so that the blocks of a queue stream
//     a row together: a thread owns kCols columns strided by the block
//     width (coalesced, 4-byte accesses: D is odd on every path, so rows sit
//     at every offset modulo 16 bytes and wide or bulk copies do not apply)
//     and loads the slot's old row and its first two contributing rows
//     before any add. Two instances: 4 columns and 4 blocks per SM where D
//     fits one 1024-column tile (the paths' D = 941: latency), 16 columns
//     and 2 blocks per SM otherwise (48 loads of 4 bytes in flight per
//     thread; more blocks streamed more rows at once and ran slower).
//   * The in-place hazard. The queue's metadata is updated in place, so no
//     block may write it back while another block of the same queue has
//     yet to read the pre-burst state. Each block takes an atomic ticket
//     (after a __threadfence) once its staging loads have landed in shared
//     memory, and keeps it in a register, so nothing waits for the atomic;
//     the block that drew the last ticket of its queue writes the metadata,
//     the counters and the drained rows' metadata back at its end, and sets
//     the ticket to 0 again for the next call on the stream. No block waits
//     for another, so a grid larger than the card cannot deadlock; the
//     wrapper keeps the tickets per (device, stream) as
//     csrc/decode_attention.cu's are kept. A cooperative launch with a grid
//     barrier would do the same with a barrier every block waits at.
//   * A slot that a reset in this burst restarts does not read its old row:
//     its new value is the contributing rows' mean alone. The plain version
//     computes old·0 + sums (core/olaf_queue.py::enqueue_burst_ex), so a
//     non-finite element of that old row gives NaN there and not here
//     (ROADMAP hazard H16, pinned by a card test); on finite rows the two
//     agree. The read would cost a row per reset slot.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kEmptySeq = 0x7fffffff;
constexpr int kEvDrop = 0;
constexpr int kEvAgg = 1;
constexpr int kEvReset = 2;
constexpr int kThreads = 256;
constexpr int kRegSlots = 64;  // slots whose state the walk keeps in registers
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Mirrors the ctypes.Structure in repro_torch/kernels/olaf_step.py field for
// field (tests/test_torch_kernel_abi.py checks it). Shapes: metadata (S,Q),
// payload (S,Q,D), counters (S,), burst (S,U) and (S,U,D), drained rows
// (S,K) and (S,K,D), tickets (S,). All row-major, contiguous, on one
// device.
struct OlafStepArgs {
  int S, Q, U, D, K;
  int cap;  // every queue's capacity where `capacity` is null
  float thr;
  // queue state, updated in place
  int* cluster;
  int* worker;
  int* seq;
  float* gen_time;
  float* reward;
  int* agg_count;
  bool* replaceable;
  float* payload;
  int* next_seq;
  int* n_dropped;
  int* n_agg;
  int* n_repl;
  int* n_screened;
  const int* capacity;  // (S,) or null: `cap`
  // burst
  const int* u_cluster;
  const int* u_worker;
  const float* u_gen_time;
  const float* u_reward;
  const bool* u_send;    // null: every row sent
  const bool* u_screen;  // null: no row screened
  const float* u_payload;
  // drained rows (metadata read before the clear); null with K = 0
  bool* d_valid;
  int* d_cluster;
  int* d_worker;
  int* d_agg_count;
  float* d_gen_time;
  float* d_reward;
  float* d_payload;
  int* n_valid;
  int* tickets;  // (S,) int32, 0 between calls; unused with one block per queue
};

// jnp.maximum / torch.maximum: NaN in either operand gives NaN (a
// constant: nanf("") is a library call that parses its argument).
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

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

// One warp: off[q] = Σ_{q' < q} n[q'] for q <= Q, then n[q] = off[q] (the
// fill cursor).
__device__ __forceinline__ void exclusive_scan(int* n, int* off, int Q, int lane) {
  int carry = 0;
  for (int b = 0; b < Q; b += 32) {
    const int q = b + lane;
    const int v = q < Q ? n[q] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (q < Q) off[q] = n[q] = carry + x - v;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) off[Q] = carry;
  __syncwarp();
}

// One warp: list[cursor[slot[u]]++] = u for every u with slot[u] >= 0, in
// ascending u per slot. Within 32 updates, the lanes naming one slot find
// each other with __match_any_sync and take ranks in lane order.
__device__ __forceinline__ void csr_fill(const int* slot_of, int U, int* cursor,
                                         int* list, int lane) {
  for (int b = 0; b < U; b += 32) {
    const int u = b + lane;
    const int q = u < U ? slot_of[u] : -1;
    const unsigned peers = __match_any_sync(kFull, q >= 0 ? q : -1 - lane);
    if (q >= 0) list[cursor[q] + __popc(peers & ((1u << lane) - 1u))] = u;
    __syncwarp();
    if (q >= 0 && lane == 31 - __clz(peers)) cursor[q] += __popc(peers);
    __syncwarp();
  }
}

// Shared memory, in 4-byte words (olaf_step_smem_words): eleven (Q) arrays,
// the (Q+1) CSR offsets, eight (U) arrays and the K drained slots.
struct Smem {
  int *cl, *wk, *sq, *cnt, *cnt0, *rp, *last_reset, *ncon, *drow, *off;
  float *gt, *rw;
  int *ucl, *uwk, *uact, *ev_slot, *con_slot, *upd, *dsel;
  float *ugt, *urw;
};

__device__ __forceinline__ Smem carve(int* sh, int Q, int U) {
  Smem m;
  m.cl = sh;
  m.wk = m.cl + Q;
  m.sq = m.wk + Q;
  m.cnt = m.sq + Q;   // agg_count as the walk leaves it
  m.cnt0 = m.cnt + Q; // agg_count before the burst
  m.rp = m.cnt0 + Q;
  m.gt = reinterpret_cast<float*>(m.rp + Q);
  m.rw = m.gt + Q;
  m.last_reset = reinterpret_cast<int*>(m.rw + Q);
  m.ncon = m.last_reset + Q;  // contributing rows per slot, then the cursor
  m.drow = m.ncon + Q;        // drained row that pops the slot, or -1
  m.off = m.drow + Q;         // Q + 1
  m.ucl = m.off + Q + 1;
  m.uwk = m.ucl + U;
  m.uact = m.uwk + U;         // bit 0 sent, bit 1 screened
  m.ev_slot = m.uact + U;
  m.con_slot = m.ev_slot + U; // event kind, then the slot if u contributes
  m.upd = m.con_slot + U;     // CSR: contributing u per slot, ascending
  m.ugt = reinterpret_cast<float*>(m.upd + U);
  m.urw = m.ugt + U;
  m.dsel = reinterpret_cast<int*>(m.urw + U);  // K: slot drained into row t
  return m;
}

// One slot's state in a lane's registers during the walk (two named
// copies per lane, never indexed, so that none is placed in local memory).
struct Slot {
  int cl, wk, sq, cnt, rp, lr;
  float gt, rw;
};

__device__ __forceinline__ Slot load_slot(const Smem& m, int q, int Q) {
  Slot x;
  const bool in = q < Q;
  x.cl = in ? m.cl[q] : -1;
  x.wk = in ? m.wk[q] : 0;
  x.sq = in ? m.sq[q] : 0;
  x.cnt = in ? m.cnt[q] : 0;
  x.rp = in ? m.rp[q] : 0;
  x.gt = in ? m.gt[q] : 0.0f;
  x.rw = in ? m.rw[q] : 0.0f;
  x.lr = -1;
  return x;
}

__device__ __forceinline__ void store_slot(const Smem& m, int q, int Q,
                                           const Slot& x) {
  if (q >= Q) return;
  m.cl[q] = x.cl;
  m.wk[q] = x.wk;
  m.sq[q] = x.sq;
  m.cnt[q] = x.cnt;
  m.rp[q] = x.rp;
  m.gt[q] = x.gt;
  m.rw[q] = x.rw;
  m.last_reset[q] = x.lr;
}

// x takes the write where `mine` (selects, not a branch: a divergent
// branch here costs a reconvergence before the next update's shuffles).
__device__ __forceinline__ void set_slot(Slot& x, bool mine, int c, int w,
                                         int sq, float gt, float rw, int cnt,
                                         int rp, bool reset, int u) {
  x.cl = mine ? c : x.cl;
  x.wk = mine ? w : x.wk;
  x.sq = mine ? sq : x.sq;
  x.gt = mine ? gt : x.gt;
  x.rw = mine ? rw : x.rw;
  x.cnt = mine ? cnt : x.cnt;
  x.rp = mine ? rp : x.rp;
  x.lr = mine && reset ? u : x.lr;
}

// The occupied, hit and empty slots among 32 (base b) by ballot.
__device__ __forceinline__ void scan_chunk(int cq, bool in, int b, int c,
                                           int Q, int& occ, int& hit_idx,
                                           int& empty_idx) {
  const unsigned m_occ = __ballot_sync(kFull, cq >= 0);
  const unsigned m_hit = __ballot_sync(kFull, cq >= 0 && cq == c);
  const unsigned m_empty = __ballot_sync(kFull, in && cq < 0);
  occ += __popc(m_occ);
  if (hit_idx == Q && m_hit) hit_idx = b + __ffs(m_hit) - 1;
  if (empty_idx == Q && m_empty) empty_idx = b + __ffs(m_empty) - 1;
}

// Algorithm 1 over the burst, by one warp (every lane computes the same
// decision). Slots lane and 32 + lane live in lane's registers (lo, hi),
// the rest in shared memory (kSpill: Q > kRegSlots; the instance without
// them keeps the U-step loop short). Leaves the post-burst metadata, each
// update's slot and event and the last reset per slot in shared memory,
// and the counters in ctr.
template <bool kSpill>
__device__ __forceinline__ void walk(const Smem& m, int* ctr, int Q, int U,
                                     int cap, float thr, int lane) {
  int nseq = ctr[0], nd = ctr[1], na = ctr[2], nr = ctr[3], ns = ctr[4];
  Slot lo = load_slot(m, lane, Q), hi = load_slot(m, 32 + lane, Q);
  for (int base = 0; base < U; base += 32) {
    // this lane's update of the 32, broadcast in turn below
    const int mine = base + lane;
    const int bc = mine < U ? m.ucl[mine] : 0, bw = mine < U ? m.uwk[mine] : 0;
    const float bt = mine < U ? m.ugt[mine] : 0.0f, br = mine < U ? m.urw[mine] : 0.0f;
    const int bact = mine < U ? m.uact[mine] : 0;
    const int n = min(32, U - base);
    int my_slot = 0, my_kind = 0;
    for (int src = 0; src < n; ++src) {
      const int u = base + src;
      const int c = __shfl_sync(kFull, bc, src), w = __shfl_sync(kFull, bw, src);
      const float t = __shfl_sync(kFull, bt, src), r = __shfl_sync(kFull, br, src);
      const int ua = __shfl_sync(kFull, bact, src);
      const bool snd = (ua & 1) != 0, scr = (ua & 2) != 0;
      const bool act = snd && !scr;  // sent AND admitted by the screen

      int hit_idx = Q, empty_idx = Q, occ = 0;
      scan_chunk(lo.cl, lane < Q, 0, c, Q, occ, hit_idx, empty_idx);
      scan_chunk(hi.cl, 32 + lane < Q, 32, c, Q, occ, hit_idx, empty_idx);
      if (kSpill)
        for (int b = kRegSlots; b < Q; b += 32) {  // slots past the registers
          const int q = b + lane;
          scan_chunk(q < Q ? m.cl[q] : -1, q < Q, b, c, Q, occ, hit_idx, empty_idx);
        }

      const bool hit = hit_idx < Q;
      const int sh_i = hit ? hit_idx : 0;  // jnp.argmax of an all-False mask
      int h_rp, h_wk, h_sq, h_cnt;
      float h_rw, h_gt;
      if (!kSpill || sh_i < kRegSlots) {  // from the lane that holds the slot
        const bool low = sh_i < 32;
        const int from = sh_i & 31;
        h_rp = __shfl_sync(kFull, low ? lo.rp : hi.rp, from);
        h_wk = __shfl_sync(kFull, low ? lo.wk : hi.wk, from);
        h_sq = __shfl_sync(kFull, low ? lo.sq : hi.sq, from);
        h_cnt = __shfl_sync(kFull, low ? lo.cnt : hi.cnt, from);
        h_rw = __shfl_sync(kFull, low ? lo.rw : hi.rw, from);
        h_gt = __shfl_sync(kFull, low ? lo.gt : hi.gt, from);
      } else {
        h_rp = m.rp[sh_i];
        h_wk = m.wk[sh_i];
        h_sq = m.sq[sh_i];
        h_cnt = m.cnt[sh_i];
        h_rw = m.rw[sh_i];
        h_gt = m.gt[sh_i];
      }
      const bool swr = act && hit && h_rp != 0 && h_wk == w;
      const float rdiff = r - h_rw;
      const bool rr = act && hit && !swr && (rdiff > thr);
      const bool rd = act && hit && !swr && (rdiff < -thr);
      const bool agg = act && hit && !swr && !rr && !rd;
      const bool full = occ >= cap;  // a COUNT, not a slot region
      const bool app = act && !hit && !full;
      const bool dropf = act && !hit && full;
      const int slot = hit ? hit_idx : (empty_idx < Q ? empty_idx : 0);
      const bool write = swr || rr || agg || app;
      const int new_seq = hit ? h_sq : nseq;
      const float new_gt = agg ? max_nan(t, h_gt) : t;
      const float new_rw = agg ? max_nan(r, h_rw) : r;
      const int new_cnt = agg ? h_cnt + 1 : 1;
      const int new_rp = (swr || app) ? 1 : 0;
      set_slot(lo, write && slot == lane, c, w, new_seq, new_gt, new_rw,
               new_cnt, new_rp, !agg, u);
      set_slot(hi, write && slot == 32 + lane, c, w, new_seq, new_gt, new_rw,
               new_cnt, new_rp, !agg, u);
      if (kSpill && write && slot >= kRegSlots && lane == 0) {
        m.cl[slot] = c;
        m.wk[slot] = w;
        m.sq[slot] = new_seq;
        m.gt[slot] = new_gt;
        m.rw[slot] = new_rw;
        m.cnt[slot] = new_cnt;
        m.rp[slot] = new_rp;
        if (!agg) m.last_reset[slot] = u;
      }
      if (kSpill) __syncwarp();  // lane 0's writes before the next reads
      // each lane records its own update's slot and event
      my_slot = lane == src ? slot : my_slot;
      my_kind = lane == src ? (agg ? kEvAgg : (write ? kEvReset : kEvDrop)) : my_kind;
      nseq += app ? 1 : 0;
      nd += (dropf || rd) ? 1 : 0;
      na += agg ? 1 : 0;
      nr += (swr || rr) ? 1 : 0;
      ns += (snd && scr) ? 1 : 0;
    }
    if (lane < n) {
      m.ev_slot[mine] = my_slot;
      m.con_slot[mine] = my_kind;
    }
  }
  store_slot(m, lane, Q, lo);
  store_slot(m, 32 + lane, Q, hi);
  if (lane == 0) {
    ctr[0] = nseq;
    ctr[1] = nd;
    ctr[2] = na;
    ctr[3] = nr;
    ctr[4] = ns;
  }
  __syncwarp();
}

// What the payload pass reads of the plan, and where the rows are.
struct Pass {
  Smem m;
  float* pay;           // the queue's (Q, D) payload, updated in place
  const float* burst;   // the queue's (U, D) burst rows
  float* drained;       // the queue's (K, D) drained rows
  size_t Dz;
  int D, Q;
  unsigned ntiles;
};

// One work item: a slot (or, past Q, a drained row) and a column tile,
// with its old row and first two contributing rows once begun.
template <int kCols>
struct Item {
  int q, d0, o0, o1, t;
  bool restart;
  float v[kCols], r0[kCols], r1[kCols];
};

// Issue the item's loads: the old row (unless a reset in the burst
// restarts the slot: H16, its old row is not read) and the first two
// contributing rows.
template <int kCols>
__device__ __forceinline__ void begin(const Pass& ps, Item<kCols>& x,
                                      unsigned it, int tid) {
  constexpr int kTile = kThreads * kCols;
  x.q = static_cast<int>(it / ps.ntiles);
  x.d0 = static_cast<int>(it - x.q * ps.ntiles) * kTile + tid;
  if (x.q >= ps.Q) return;
  x.o0 = ps.m.off[x.q];
  x.o1 = ps.m.off[x.q + 1];
  x.t = ps.m.drow[x.q];
  x.restart = ps.m.last_reset[x.q] >= 0;
  if (x.o1 == x.o0 && x.t < 0) return;  // untouched and not popped: no bytes
  if (x.restart) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) x.v[j] = 0.0f;
  } else {
    load_cols(x.v, ps.pay + x.q * ps.Dz, x.d0, ps.D);
  }
  if (x.o1 > x.o0) load_cols(x.r0, ps.burst + ps.m.upd[x.o0] * ps.Dz, x.d0, ps.D);
  if (x.o1 > x.o0 + 1) load_cols(x.r1, ps.burst + ps.m.upd[x.o0 + 1] * ps.Dz, x.d0, ps.D);
}

// Finish the item: a touched slot becomes (old·base + the contributing rows
// in ascending u) / max(base + n, 1), each product and sum rounded on its
// own; a popped slot's value goes to its drained row and the slot is
// cleared.
template <int kCols>
__device__ __forceinline__ void finish(const Pass& ps, Item<kCols>& x) {
  if (x.q >= ps.Q) {  // drained row t: zeros where it popped no valid slot
    const int t = x.q - ps.Q;
    if (ps.m.cl[ps.m.dsel[t]] < 0)
      store_cols(ps.drained + t * ps.Dz, x.d0, ps.D, x.v, true);
    return;
  }
  if (x.o1 == x.o0 && x.t < 0) return;
  if (x.o1 > x.o0) {  // touched: a contributing row exists
    const int base = x.restart ? 0 : ps.m.cnt0[x.q];
    const float bw = static_cast<float>(base);
#pragma unroll
    for (int j = 0; j < kCols; ++j) x.v[j] = __fadd_rn(__fmul_rn(x.v[j], bw), x.r0[j]);
    if (x.o1 > x.o0 + 1) {
#pragma unroll
      for (int j = 0; j < kCols; ++j) x.v[j] = __fadd_rn(x.v[j], x.r1[j]);
    }
    for (int i = x.o0 + 2; i < x.o1; i += 2) {  // the rest, two rows at a time
      const bool two = i + 1 < x.o1;
      load_cols(x.r0, ps.burst + ps.m.upd[i] * ps.Dz, x.d0, ps.D);
      if (two) load_cols(x.r1, ps.burst + ps.m.upd[i + 1] * ps.Dz, x.d0, ps.D);
#pragma unroll
      for (int j = 0; j < kCols; ++j) x.v[j] = __fadd_rn(x.v[j], x.r0[j]);
      if (two) {
#pragma unroll
        for (int j = 0; j < kCols; ++j) x.v[j] = __fadd_rn(x.v[j], x.r1[j]);
      }
    }
    const float n = fmaxf(static_cast<float>(base + x.o1 - x.o0), 1.0f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) x.v[j] = __fdiv_rn(x.v[j], n);
  }
  if (x.t >= 0)  // popped: the drained row carries the combined payload
    store_cols(ps.drained + x.t * ps.Dz, x.d0, ps.D, x.v, false);
  store_cols(ps.pay + x.q * ps.Dz, x.d0, ps.D, x.v, x.t >= 0);
}

template <int kCols, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
olaf_step_kernel(OlafStepArgs a) {
  constexpr int kTile = kThreads * kCols;  // columns per work item
  extern __shared__ int sh[];
  __shared__ int ctr[5];  // next_seq, n_dropped, n_agg, n_repl, n_screened
  __shared__ int ticket;
  const int Q = a.Q, U = a.U, K = a.K, D = a.D;
  const int s = blockIdx.y, tid = threadIdx.x, lane = tid & 31;
  const Smem m = carve(sh, Q, U);
  const size_t q0 = static_cast<size_t>(s) * Q;
  const size_t u0 = static_cast<size_t>(s) * U;

  // ---- 1. stage the pre-burst state and the burst's metadata
  for (int q = tid; q < Q; q += kThreads) {
    m.cl[q] = a.cluster[q0 + q];
    m.wk[q] = a.worker[q0 + q];
    m.sq[q] = a.seq[q0 + q];
    m.cnt[q] = m.cnt0[q] = a.agg_count[q0 + q];
    m.rp[q] = a.replaceable[q0 + q] ? 1 : 0;
    m.gt[q] = a.gen_time[q0 + q];
    m.rw[q] = a.reward[q0 + q];
    m.last_reset[q] = -1;
    m.ncon[q] = 0;
    m.drow[q] = -1;
  }
  for (int u = tid; u < U; u += kThreads) {
    m.ucl[u] = a.u_cluster[u0 + u];
    m.uwk[u] = a.u_worker[u0 + u];
    m.ugt[u] = a.u_gen_time[u0 + u];
    m.urw[u] = a.u_reward[u0 + u];
    const bool snd = a.u_send == nullptr || a.u_send[u0 + u];
    const bool scr = a.u_screen != nullptr && a.u_screen[u0 + u];
    m.uact[u] = (snd ? 1 : 0) | (scr ? 2 : 0);
  }
  if (tid == 0) {
    ctr[0] = a.next_seq[s];
    ctr[1] = a.n_dropped[s];
    ctr[2] = a.n_agg[s];
    ctr[3] = a.n_repl[s];
    ctr[4] = a.n_screened[s];
  }
  __syncthreads();
  // every load of the queue's state has landed: this block no longer needs
  // it. The ticket stays in a register until the write-back: nothing waits
  // for the atomic before then.
  int my_ticket = 0;
  if (gridDim.x > 1 && tid == 32) {
    __threadfence();
    my_ticket = atomicAdd(a.tickets + s, 1);
  }

  // ---- 2. Algorithm 1 (warp 0), then the plan: the last reset per slot
  // and the aggregates after it contribute (the telescoped running mean),
  // in ascending u. With last_reset the last reset of its slot, u
  // contributes iff its event is not a drop and u >= last_reset[its slot].
  if (tid < 32) {
    const int cap = a.capacity != nullptr ? a.capacity[s] : a.cap;
    if (Q > kRegSlots)
      walk<true>(m, ctr, Q, U, cap, a.thr, lane);
    else
      walk<false>(m, ctr, Q, U, cap, a.thr, lane);
    for (int u = lane; u < U; u += 32) {
      const int q = m.ev_slot[u];
      const bool con = m.con_slot[u] != kEvDrop && u >= m.last_reset[q];
      m.con_slot[u] = con ? q : -1;
      if (con) atomicAdd(m.ncon + q, 1);
    }
    __syncwarp();
    exclusive_scan(m.ncon, m.off, Q, lane);
    csr_fill(m.con_slot, U, m.ncon, m.upd, lane);
  }
  __syncthreads();
  // drain-k: the k smallest seq, ties broken by the lowest slot
  // (lax.top_k(-seq)'s order); a slot's rank among the distinct (seq with
  // its sign bit flipped, slot) keys is its drained row
  for (int q = tid; q < Q; q += kThreads) {
    const unsigned long long key =
        (static_cast<unsigned long long>(static_cast<unsigned>(m.sq[q]) ^ 0x80000000u) << 32) |
        static_cast<unsigned>(q);
    int rank = 0;
    for (int p = 0; p < Q; ++p) {
      const unsigned long long kp =
          (static_cast<unsigned long long>(static_cast<unsigned>(m.sq[p]) ^ 0x80000000u) << 32) |
          static_cast<unsigned>(p);
      rank += kp < key ? 1 : 0;
    }
    if (rank < K) {
      m.dsel[rank] = q;
      if (m.cl[q] >= 0) m.drow[q] = rank;
    }
  }
  __syncthreads();

  // ---- 3. payload: work items (slot or drained row, column tile). (Two
  // items begun before either finished ran slower at the stress shape.)
  const Pass ps{m, a.payload + q0 * static_cast<size_t>(D),
                a.u_payload + u0 * static_cast<size_t>(D),
                K > 0 ? a.d_payload + static_cast<size_t>(s) * K * D : nullptr,
                static_cast<size_t>(D), D, Q,
                static_cast<unsigned>((D + kTile - 1) / kTile)};
  const unsigned items = ps.ntiles * (Q + K);
  for (unsigned it = blockIdx.x; it < items; it += gridDim.x) {
    Item<kCols> x;
    begin(ps, x, it, tid);
    finish(ps, x);
  }

  // ---- 4. the queue's last block writes the post-drain metadata back:
  // popped slots cleared, their gen_time kept (jax_dequeue_burst)
  if (tid == 32) ticket = my_ticket;
  __syncthreads();
  if (gridDim.x > 1 && ticket != static_cast<int>(gridDim.x) - 1) return;
  for (int q = tid; q < Q; q += kThreads) {
    const bool popped = m.drow[q] >= 0;
    a.cluster[q0 + q] = popped ? -1 : m.cl[q];
    a.worker[q0 + q] = popped ? -1 : m.wk[q];
    a.seq[q0 + q] = popped ? kEmptySeq : m.sq[q];
    a.agg_count[q0 + q] = popped ? 0 : m.cnt[q];
    a.replaceable[q0 + q] = popped ? false : m.rp[q] != 0;
    a.gen_time[q0 + q] = m.gt[q];
    a.reward[q0 + q] = popped ? -INFINITY : m.rw[q];
  }
  const size_t k0 = static_cast<size_t>(s) * K;
  for (int t = tid; t < K; t += kThreads) {
    const int q = m.dsel[t];
    a.d_valid[k0 + t] = m.cl[q] >= 0;
    a.d_cluster[k0 + t] = m.cl[q];
    a.d_worker[k0 + t] = m.wk[q];
    a.d_agg_count[k0 + t] = m.cnt[q];
    a.d_gen_time[k0 + t] = m.gt[q];
    a.d_reward[k0 + t] = m.rw[q];
  }
  if (tid == 0) {
    a.next_seq[s] = ctr[0];
    a.n_dropped[s] = ctr[1];
    a.n_agg[s] = ctr[2];
    a.n_repl[s] = ctr[3];
    a.n_screened[s] = ctr[4];
    if (a.n_valid != nullptr) {
      int nv = 0;
      for (int t = 0; t < K; ++t) nv += m.cl[m.dsel[t]] >= 0 ? 1 : 0;
      a.n_valid[s] = nv;
    }
    if (gridDim.x > 1) a.tickets[s] = 0;  // every block has drawn its ticket
  }
}

extern "C" size_t olaf_step_smem_words(int Q, int U, int K);

template <int kCols, int kMinBlocks>
static int launch_with(const OlafStepArgs& a, cudaStream_t st, int sms) {
  const long long tiles = (a.D + kThreads * kCols - 1) / (kThreads * kCols);
  const long long items = tiles * (a.Q + a.K);
  const long long fill = (static_cast<long long>(sms) * kMinBlocks + a.S - 1) / a.S;
  const int per_queue = static_cast<int>(items < fill ? (items > 0 ? items : 1) : fill);
  if (per_queue > 1 && a.tickets == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(per_queue, a.S);
  olaf_step_kernel<kCols, kMinBlocks>
      <<<grid, kThreads, olaf_step_smem_words(a.Q, a.U, a.K) * sizeof(int), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

static int launch_cycle(const OlafStepArgs& a, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  return a.D <= kThreads * 4 ? launch_with<4, 4>(a, st, sms)
                             : launch_with<16, 2>(a, st, sms);
}

extern "C" {

// Dynamic shared memory of one block, in 4-byte words.
size_t olaf_step_smem_words(int Q, int U, int K) {
  return 12 * static_cast<size_t>(Q) + 1 + 8 * static_cast<size_t>(U) +
         static_cast<size_t>(K);
}

// One launch on `stream`; returns cudaGetLastError() (0 = ok).
int olaf_step_launch(const OlafStepArgs* args, void* stream) {
  return launch_cycle(*args, static_cast<cudaStream_t>(stream));
}

// The enqueue-only half of the cycle (olaf_combine.py::olaf_enqueue_pallas):
// the same launch with no drain (K = 0: no drained row is selected or
// written) and no transmission-control gate (u_send null: every row is
// sent; screen and capacity still apply).
int olaf_enqueue_launch(const OlafStepArgs* args, void* stream) {
  OlafStepArgs a = *args;
  if (a.K != 0 || a.u_send != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  a.d_valid = nullptr;
  a.d_cluster = a.d_worker = a.d_agg_count = a.n_valid = nullptr;
  a.d_gen_time = a.d_reward = a.d_payload = nullptr;
  return launch_cycle(a, static_cast<cudaStream_t>(stream));
}

const char* olaf_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
