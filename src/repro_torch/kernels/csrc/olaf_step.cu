// Fused OLAF data-plane cycle for Hopper: burst enqueue (Algorithm 1) then
// drain-k, for S independent queues.
//
// Replaces the Pallas TPU kernel repro/kernels/olaf_step.py::olaf_step_pallas
// (body _olaf_step_kernel, with olaf_combine.py::alg1_resolve). It is held to
// the sequential oracle repro/core/olaf_queue.py::_burst_resolve +
// jax_dequeue_burst, not to alg1_resolve: the queue is full by COUNT
// (occupied >= capacity) and an append takes the first empty slot at ANY
// index.
//
// The same two launches with K = 0 and every row sent (olaf_enqueue_launch)
// replace repro/kernels/olaf_combine.py::olaf_enqueue_pallas (body
// _enqueue_kernel), the enqueue-only half of the cycle; they are held to
// repro/core/olaf_queue.py::jax_enqueue_burst the same way.
//
// Bound: bytes. Per cycle this kernel reads the contributing burst rows,
// reads and writes every slot row the burst touches or the drain pops, and
// writes the k drained rows; the least the cycle needs is smaller (no read
// of a slot a reset restarts, no write of an empty slot the drain pops:
// chip_smoke.py's cycle_cost counts both). The arithmetic is about one add
// per burst element. On the TPU
// the grid steps ran in order and shared scratch; CUDA blocks do not, so the
// cycle is two launches on one stream:
//
//   1. olaf_resolve_kernel, one warp per queue: the sequential U walk over
//      the (Q,) metadata held in shared memory, the drain-k selection, and
//      the per-slot plan for the payload pass (base count, CSR list of the
//      contributing updates in ascending u, drained row).
//   2. olaf_payload_kernel on an (ceil(D/TD), S) grid: each thread owns one
//      column of one queue and walks the Q slots, reading and writing only
//      the rows the plan names. The payload is updated in place, so an
//      untouched, un-popped slot row costs no bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kEmptySeq = 0x7fffffff;
constexpr int kEvDrop = 0;
constexpr int kEvAgg = 1;
constexpr int kEvReset = 2;
constexpr int kPayloadThreads = 256;  // columns per payload block
constexpr unsigned kFull = 0xffffffffu;

}  // namespace

// Mirrors the ctypes.Structure in repro_torch/kernels/olaf_step.py field for
// field. Shapes: metadata (S,Q), payload (S,Q,D), counters (S,), burst
// (S,U) and (S,U,D), drained rows (S,K) and (S,K,D). All row-major,
// contiguous, on one device.
struct OlafStepArgs {
  int S, Q, U, D, K;
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
  const int* capacity;
  // burst
  const int* u_cluster;
  const int* u_worker;
  const float* u_gen_time;
  const float* u_reward;
  const bool* u_send;  // null: every row sent (olaf_enqueue_launch)
  const bool* u_screen;
  const float* u_payload;
  // drained rows (metadata read before the clear)
  bool* d_valid;
  int* d_cluster;
  int* d_worker;
  int* d_agg_count;
  float* d_gen_time;
  float* d_reward;
  float* d_payload;
  int* n_valid;  // null with K = 0
  // plan written by the resolve launch, read by the payload launch
  int* slot_base;  // (S,Q): -1 untouched, else the old payload's weight
  int* slot_off;   // (S,Q+1): CSR offsets into slot_upd
  int* slot_upd;   // (S,max(U,1)): contributing updates, ascending u per slot
  int* slot_drow;  // (S,Q): drained row that pops the slot, or -1
};

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ unsigned long long warp_min_u64(unsigned long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    unsigned long long w = __shfl_xor_sync(kFull, v, o);
    v = w < v ? w : v;
  }
  return v;
}

// jnp.maximum / torch.maximum: NaN in either operand gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

// One warp (32 threads) per queue s = blockIdx.x.
__global__ void olaf_resolve_kernel(OlafStepArgs a) {
  extern __shared__ int sh[];
  const int Q = a.Q, U = a.U, K = a.K;
  const int s = blockIdx.x;
  const int lane = threadIdx.x;
  int* cl = sh;
  int* wk = cl + Q;
  int* sq = wk + Q;
  int* cnt = sq + Q;
  int* rp = cnt + Q;
  int* last_reset = rp + Q;
  int* ncon = last_reset + Q;
  int* taken = ncon + Q;
  int* ev_slot = taken + Q;
  int* ev_kind = ev_slot + U;
  float* gt = reinterpret_cast<float*>(ev_kind + U);
  float* rw = gt + Q;

  const size_t q0 = static_cast<size_t>(s) * Q;
  for (int q = lane; q < Q; q += 32) {
    cl[q] = a.cluster[q0 + q];
    wk[q] = a.worker[q0 + q];
    sq[q] = a.seq[q0 + q];
    cnt[q] = a.agg_count[q0 + q];
    rp[q] = a.replaceable[q0 + q] ? 1 : 0;
    gt[q] = a.gen_time[q0 + q];
    rw[q] = a.reward[q0 + q];
    last_reset[q] = -1;
    ncon[q] = 0;
    taken[q] = 0;
  }
  int nseq = a.next_seq[s], nd = a.n_dropped[s], na = a.n_agg[s];
  int nr = a.n_repl[s], ns = a.n_screened[s];
  const int cap = a.capacity[s];
  const float thr = a.thr;
  __syncwarp();

  // ---- 1. Algorithm 1, one update at a time. Every lane computes the same
  // decision; lane 0 alone writes the shared metadata.
  const size_t u0 = static_cast<size_t>(s) * U;
  for (int u = 0; u < U; ++u) {
    const int c = a.u_cluster[u0 + u];
    const int w = a.u_worker[u0 + u];
    const float t = a.u_gen_time[u0 + u];
    const float r = a.u_reward[u0 + u];
    const bool snd = a.u_send == nullptr || a.u_send[u0 + u];  // enqueue: all sent
    const bool scr = a.u_screen[u0 + u];
    const bool act = snd && !scr;  // sent AND admitted by the screen

    int hit_idx = Q, empty_idx = Q, occ = 0;
    for (int q = lane; q < Q; q += 32) {
      const bool o = cl[q] >= 0;
      occ += o ? 1 : 0;
      if (o && cl[q] == c) hit_idx = min(hit_idx, q);
      if (!o) empty_idx = min(empty_idx, q);
    }
    hit_idx = warp_min(hit_idx);
    empty_idx = warp_min(empty_idx);
    occ = warp_sum(occ);

    const bool hit = hit_idx < Q;
    const int sh_i = hit ? hit_idx : 0;  // jnp.argmax of an all-False mask
    const bool swr = act && hit && rp[sh_i] != 0 && wk[sh_i] == w;
    const float rdiff = r - rw[sh_i];
    const bool rr = act && hit && !swr && (rdiff > thr);
    const bool rd = act && hit && !swr && (rdiff < -thr);
    const bool agg = act && hit && !swr && !rr && !rd;
    const bool full = occ >= cap;  // a COUNT, not a slot region
    const bool app = act && !hit && !full;
    const bool dropf = act && !hit && full;
    const int slot = hit ? hit_idx : (empty_idx < Q ? empty_idx : 0);
    const bool write = swr || rr || agg || app;
    const int new_seq = hit ? sq[sh_i] : nseq;
    const float new_gt = agg ? max_nan(t, gt[sh_i]) : t;
    const float new_rw = agg ? max_nan(r, rw[sh_i]) : r;
    const int new_cnt = agg ? cnt[sh_i] + 1 : 1;
    __syncwarp();  // every lane has read the slot before lane 0 writes it
    if (lane == 0) {
      if (write) {
        cl[slot] = c;
        wk[slot] = w;
        sq[slot] = new_seq;
        gt[slot] = new_gt;
        rw[slot] = new_rw;
        cnt[slot] = new_cnt;
        rp[slot] = (swr || app) ? 1 : 0;
      }
      ev_slot[u] = slot;
      ev_kind[u] = agg ? kEvAgg : (write ? kEvReset : kEvDrop);
    }
    nseq += app ? 1 : 0;
    nd += (dropf || rd) ? 1 : 0;
    na += agg ? 1 : 0;
    nr += (swr || rr) ? 1 : 0;
    ns += (snd && scr) ? 1 : 0;
    __syncwarp();
  }

  // ---- 2. plan for the payload pass: the last reset per slot and the
  // aggregates after it contribute (the telescoped running mean).
  int* off = a.slot_off + static_cast<size_t>(s) * (Q + 1);
  int* upd = a.slot_upd + static_cast<size_t>(s) * (U > 0 ? U : 1);
  if (lane == 0) {
    for (int u = 0; u < U; ++u)
      if (ev_kind[u] == kEvReset) last_reset[ev_slot[u]] = u;
    for (int u = 0; u < U; ++u) {
      const int q = ev_slot[u], lr = last_reset[q];
      const bool con = (ev_kind[u] == kEvAgg && u > lr) ||
                       (ev_kind[u] == kEvReset && u == lr);
      ev_kind[u] = con ? 1 : 0;  // reused as the contributes flag
      ncon[q] += con ? 1 : 0;
    }
    int acc = 0;
    for (int q = 0; q < Q; ++q) {
      off[q] = acc;
      acc += ncon[q];
      ncon[q] = off[q];  // reused as the fill cursor
    }
    off[Q] = acc;
    for (int u = 0; u < U; ++u)
      if (ev_kind[u]) upd[ncon[ev_slot[u]]++] = u;
  }
  __syncwarp();
  for (int q = lane; q < Q; q += 32) {
    const bool touched = last_reset[q] >= 0 || off[q + 1] > off[q];
    // the old payload keeps its pre-burst weight unless a reset restarted
    // the slot; a.agg_count still holds the pre-burst counts here
    a.slot_base[q0 + q] = !touched ? -1 : (last_reset[q] < 0 ? a.agg_count[q0 + q] : 0);
    a.slot_drow[q0 + q] = -1;
  }
  __syncwarp();

  // ---- 3. drain-k: the k smallest seq, ties broken by the lowest slot
  // (lax.top_k(-seq)'s order). Key = (seq with its sign bit flipped, slot).
  const size_t k0 = static_cast<size_t>(s) * K;
  int nvalid = 0;
  for (int t = 0; t < K; ++t) {
    unsigned long long best = ~0ull;
    for (int q = lane; q < Q; q += 32) {
      if (taken[q]) continue;
      const unsigned long long key =
          (static_cast<unsigned long long>(static_cast<unsigned>(sq[q]) ^ 0x80000000u) << 32) |
          static_cast<unsigned>(q);
      best = key < best ? key : best;
    }
    best = warp_min_u64(best);
    const int q = static_cast<int>(best & 0xffffffffull);
    const bool valid = cl[q] >= 0;
    nvalid += valid ? 1 : 0;
    if (lane == 0) {
      taken[q] = 1;
      a.d_valid[k0 + t] = valid;
      a.d_cluster[k0 + t] = cl[q];
      a.d_worker[k0 + t] = wk[q];
      a.d_agg_count[k0 + t] = cnt[q];
      a.d_gen_time[k0 + t] = gt[q];
      a.d_reward[k0 + t] = rw[q];
      if (valid) a.slot_drow[q0 + q] = t;
    }
    __syncwarp();
  }

  // ---- 4. post-drain metadata back to the state: popped slots are
  // cleared, their gen_time kept (jax_dequeue_burst).
  for (int q = lane; q < Q; q += 32) {
    const bool popped = a.slot_drow[q0 + q] >= 0;
    a.cluster[q0 + q] = popped ? -1 : cl[q];
    a.worker[q0 + q] = popped ? -1 : wk[q];
    a.seq[q0 + q] = popped ? kEmptySeq : sq[q];
    a.agg_count[q0 + q] = popped ? 0 : cnt[q];
    a.replaceable[q0 + q] = popped ? false : rp[q] != 0;
    a.gen_time[q0 + q] = gt[q];
    a.reward[q0 + q] = popped ? -INFINITY : rw[q];
  }
  if (lane == 0) {
    a.next_seq[s] = nseq;
    a.n_dropped[s] = nd;
    a.n_agg[s] = na;
    a.n_repl[s] = nr;
    a.n_screened[s] = ns;
    if (a.n_valid != nullptr) a.n_valid[s] = nvalid;
  }
}

// Grid (ceil(D / kPayloadThreads), S); thread = one column d of queue s.
__global__ void olaf_payload_kernel(OlafStepArgs a) {
  extern __shared__ int sh[];
  const int Q = a.Q, U = a.U, K = a.K, D = a.D;
  const int s = blockIdx.y;
  int* base = sh;
  int* drow = base + Q;
  int* off = drow + Q;
  int* upd = off + Q + 1;
  int* dvalid = upd + (U > 0 ? U : 1);

  const size_t q0 = static_cast<size_t>(s) * Q;
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    base[i] = a.slot_base[q0 + i];
    drow[i] = a.slot_drow[q0 + i];
  }
  for (int i = threadIdx.x; i <= Q; i += blockDim.x)
    off[i] = a.slot_off[static_cast<size_t>(s) * (Q + 1) + i];
  for (int i = threadIdx.x; i < U; i += blockDim.x)
    upd[i] = a.slot_upd[static_cast<size_t>(s) * U + i];
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    dvalid[i] = a.d_valid[static_cast<size_t>(s) * K + i] ? 1 : 0;
  __syncthreads();

  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;  // ragged edge of D
  const size_t Dz = static_cast<size_t>(D);
  float* pay = a.payload + q0 * Dz + d;
  const float* burst = a.u_payload + static_cast<size_t>(s) * U * Dz + d;
  float* drained = K > 0 ? a.d_payload + static_cast<size_t>(s) * K * Dz + d : nullptr;

  for (int q = 0; q < Q; ++q) {
    const int b = base[q], t = drow[q];
    if (b < 0 && t < 0) continue;  // untouched and not popped: no bytes
    float v = pay[q * Dz];
    if (b >= 0) {  // touched: (old * base_n + sum of contributions) / n
      float acc = v * static_cast<float>(b);
      for (int i = off[q]; i < off[q + 1]; ++i) acc += burst[upd[i] * Dz];
      v = acc / fmaxf(static_cast<float>(b + off[q + 1] - off[q]), 1.0f);
    }
    if (t >= 0) {  // popped: the drained row carries the combined payload
      drained[t * Dz] = v;
      pay[q * Dz] = 0.0f;
    } else {
      pay[q * Dz] = v;
    }
  }
  for (int t = 0; t < K; ++t)
    if (!dvalid[t]) drained[t * Dz] = 0.0f;
}

extern "C" size_t olaf_step_resolve_smem(int Q, int U);
extern "C" size_t olaf_step_payload_smem(int Q, int U, int K);

static int launch_cycle(const OlafStepArgs& a, cudaStream_t st) {
  olaf_resolve_kernel<<<a.S, 32, olaf_step_resolve_smem(a.Q, a.U), st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((a.D + kPayloadThreads - 1) / kPayloadThreads, a.S);
  olaf_payload_kernel<<<grid, kPayloadThreads,
                        olaf_step_payload_smem(a.Q, a.U, a.K), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

size_t olaf_step_resolve_smem(int Q, int U) {
  return sizeof(int) * (10 * static_cast<size_t>(Q) + 2 * static_cast<size_t>(U));
}

size_t olaf_step_payload_smem(int Q, int U, int K) {
  return sizeof(int) * (3 * static_cast<size_t>(Q) + 1 + (U > 0 ? U : 1) + K);
}

// Both launches on `stream`; returns cudaGetLastError() after each (0 = ok).
int olaf_step_launch(const OlafStepArgs* args, void* stream) {
  return launch_cycle(*args, static_cast<cudaStream_t>(stream));
}

// The enqueue-only half of the cycle (olaf_combine.py::olaf_enqueue_pallas):
// the same resolve and payload launches with no drain (K = 0: no drained
// row is allocated, selected or written) and no transmission-control gate
// (u_send null: every row is sent; screen and capacity still apply).
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
