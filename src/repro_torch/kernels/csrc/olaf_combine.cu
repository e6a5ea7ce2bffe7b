// OLAF burst combine for Hopper: land a window of U weighted updates into
// the Q cluster slots of each of S switch queues (running mean).
//
//   new[s,q] = (slot[s,q]·count[s,q] + Σ_{u: cluster[s,u]=q} gate[s,u]·upd[s,u])
//              / max(count[s,q] + hits[s,q], 1),   hits[s,q] = Σ_{u: cluster=q} gate
//   new_count[s,q] = count[s,q] + hits[s,q]
//
// Replaces the Pallas TPU kernel repro/kernels/olaf_combine.py::
// olaf_combine_pallas (body _combine_kernel). The TPU kernel makes the
// segment sum a one-hot (Qt,U)x(U,Dt) MXU product per grid step; here the
// segment sum is taken directly, which needs no matrix unit:
//
//   one launch on a (ceil(D/256), S) grid. Each block loads its switch's
//   clusters, gates and counts into shared memory and builds a small CSR
//   there: for each slot, its contributing u in ascending order (gate != 0
//   and 0 <= cluster < Q). Each thread then owns one column d and walks the
//   Q slots: sum = Σ gate·upd in ascending u, out = (slot·count + sum) /
//   max(count + hits, 1), the reference's association. No atomics: the
//   result is the same bits on every run.
//
// A row weighs in only in the slot it names, so a non-finite element of
// one update reaches only that slot (the one-hot product of the reference
// spreads it, as 0·NaN, to every slot it multiplies). Every slot row is
// rewritten, as the reference does, so an untouched slot with count c
// becomes x·c/c and a reset slot (count 0) x·0.
//
// Bound: bytes. The function needs the contributing update rows, the slot
// rows whose old value weighs in, and the slot rows that change; this
// kernel also reads and writes every other slot row (chip_smoke.py counts
// both). About two flops per element moved.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;  // columns per block
}  // namespace

// Mirrors the ctypes.Structure in repro_torch/kernels/olaf_combine.py. All
// row-major, contiguous, on one device: slots/out (S,Q,D), counts/
// out_counts (S,Q), updates (S,U,D), clusters/gate (S,U).
struct OlafCombineArgs {
  int S, Q, U, D;
  const float* slots;
  const int* counts;
  const float* updates;
  const int* clusters;
  const int* gate;
  float* out;
  int* out_counts;
};

__global__ void olaf_combine_kernel(OlafCombineArgs a) {
  extern __shared__ int sh[];
  const int Q = a.Q, U = a.U, D = a.D;
  const int s = blockIdx.y;
  const int Ub = U > 0 ? U : 1;
  int* cnt = sh;          // (Q) counts
  int* hits = cnt + Q;    // (Q) Σ gate per slot
  int* off = hits + Q;    // (Q+1) CSR offsets
  int* cl = off + Q + 1;  // (U) cluster per update
  int* gt = cl + Ub;      // (U) gate per update
  int* lst = gt + Ub;     // (U) contributing u, grouped by slot

  const size_t q0 = static_cast<size_t>(s) * Q;
  const size_t u0 = static_cast<size_t>(s) * U;
  for (int i = threadIdx.x; i < Q; i += blockDim.x) cnt[i] = a.counts[q0 + i];
  for (int i = threadIdx.x; i < U; i += blockDim.x) {
    cl[i] = a.clusters[u0 + i];
    gt[i] = a.gate[u0 + i];
  }
  __syncthreads();
  // one thread per slot: its hits and number of contributing rows
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    int h = 0, n = 0;
    for (int u = 0; u < U; ++u) {
      if (cl[u] == q) {
        h += gt[u];
        n += gt[u] != 0 ? 1 : 0;
      }
    }
    hits[q] = h;
    off[q + 1] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    off[0] = 0;
    for (int q = 0; q < Q; ++q) off[q + 1] += off[q];
  }
  __syncthreads();
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    int k = off[q];
    for (int u = 0; u < U; ++u)
      if (cl[u] == q && gt[u] != 0) lst[k++] = u;
  }
  __syncthreads();
  if (blockIdx.x == 0)
    for (int q = threadIdx.x; q < Q; q += blockDim.x)
      a.out_counts[q0 + q] = cnt[q] + hits[q];

  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D) return;  // ragged edge of D
  const size_t Dz = static_cast<size_t>(D);
  const float* slot = a.slots + q0 * Dz + d;
  const float* upd = a.updates + u0 * Dz + d;
  float* out = a.out + q0 * Dz + d;
  for (int q = 0; q < Q; ++q) {
    // products rounded, then added in ascending u: no contraction, so the
    // plain version's index_add_ order gives the same sum
    float sum = 0.0f;
    for (int i = off[q]; i < off[q + 1]; ++i) {
      const int u = lst[i];
      sum = __fadd_rn(sum, __fmul_rn(static_cast<float>(gt[u]), upd[u * Dz]));
    }
    const float acc = __fadd_rn(__fmul_rn(slot[q * Dz], static_cast<float>(cnt[q])), sum);
    const int n = cnt[q] + hits[q];
    out[q * Dz] = __fdiv_rn(acc, static_cast<float>(n > 1 ? n : 1));
  }
}

extern "C" {

size_t olaf_combine_smem(int Q, int U) {
  const size_t Ub = U > 0 ? static_cast<size_t>(U) : 1;
  return sizeof(int) * (3 * static_cast<size_t>(Q) + 1 + 3 * Ub);
}

// One launch on `stream`; returns cudaGetLastError() (0 = ok).
int olaf_combine_launch(const OlafCombineArgs* args, void* stream) {
  const OlafCombineArgs a = *args;
  dim3 grid((a.D + kThreads - 1) / kThreads > 0 ? (a.D + kThreads - 1) / kThreads : 1, a.S);
  olaf_combine_kernel<<<grid, kThreads, olaf_combine_smem(a.Q, a.U),
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* olaf_combine_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
