// The preemption what-if as one CUDA kernel for Hopper (sm_90a), bound to
// PyTorch through a plain C entry loaded with ctypes
// (kubernetes_tpu_torch/ops/preempt.py builds and calls it).
//
// Replaces: the XLA program _preemption_stats
// (kubernetes_tpu/ops/preempt.py:85). It is not a Pallas kernel; it gets a
// hand-written kernel because its sums must come out bit-equal to the JAX
// package's on the CPU, and the plain PyTorch version's index_add_ adds by
// float atomics in an arbitrary order on the card.
//
// For each (failed pod p, node n), walk the candidate priority levels in
// order; at level l the victim class is every live existing pod (valid and
// alive) on n whose priority is below min(levels[l], prio_p). With the
// class removed, re-check the pod's resource fit and the node's pod count.
// The first level that fits (and whose node passes the pod's static
// predicates, static_ok) wins, and its stats are written:
//   plane 0  ok (1 / 0)
//   plane 1  victim count             (int, from the f32 count)
//   plane 2  victim priority max      (int; INT32_MIN for a node no row
//            points at, NEG for a node whose rows are all non-victims)
//   plane 3  victim priority sum      (f32, bit pattern in the int plane)
//   plane 4  victim gang weight sum   (f32, bit pattern; 0 without weights)
// A (p, n) that never fits writes ok = 0, zero stats and NEG.
//
// Bit-equality with the JAX program, which it is tested against:
//   * each sum runs over the node's rows in increasing row index m, as
//     XLA's segment_sum scatters on the CPU, and adds w * x for every row
//     of the node (w = 1 for a victim, 0 otherwise), victims or not;
//   * every f32 multiply and add is rounded on its own (__fmul_rn,
//     __fadd_rn, __fsub_rn): no FMA contraction;
//   * the fit test keeps the JAX op order, (requested - removed) + req
//     <= alloc on the checked columns (core columns always, extended ones
//     when requested), and pod_count - int(count) + 1 <= allowed_pods;
//   * the rows of a node (row_ptr / rows, a CSR built by the caller from
//     max(node, 0)) include the free, pad and removed rows, which are never
//     victims: they count toward the priority max as NEG. Free and pad rows
//     sit at node 0, removed rows keep their old node.
//
// One thread per (p, n), n fastest. Simple and correct first: the rows of
// a node are read by every thread of its column, uncoalesced, once per
// level visited.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_R = 16;  // resource columns held in registers
constexpr int32_t NEG = -2147483647;  // -(2**31) + 1
constexpr int32_t INT_MIN_ = -2147483647 - 1;

__global__ void __launch_bounds__(THREADS)
whatif_kernel(const float* __restrict__ alloc,      // [N, R]
              const float* __restrict__ requested,  // [N, R]
              const int* __restrict__ pod_count,    // [N]
              const int* __restrict__ allowed,      // [N]
              const float* __restrict__ ep_req,     // [M, R]
              const int* __restrict__ ep_prio,      // [M]
              const uint8_t* __restrict__ live,     // [M]
              const float* __restrict__ gang_w,     // [M] or null
              const int* __restrict__ row_ptr,      // [N + 1]
              const int* __restrict__ rows,         // [row_ptr[N]]
              const int* __restrict__ levels,       // [L]
              const float* __restrict__ pb_req,     // [P, R]
              const int* __restrict__ pb_prio,      // [P]
              const uint8_t* __restrict__ static_ok,  // [P, N]
              int P, int N, int R, int L, int r_fixed,
              int32_t* __restrict__ out) {  // [5, P, N]
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long PN = (long long)P * N;
  if (idx >= PN) return;
  const int p = (int)(idx / N);
  const int n = (int)(idx - (long long)p * N);
  int32_t ok = 0, victims = 0, pmax = NEG;
  float psum = 0.0f, gang = 0.0f;
  if (static_ok[idx]) {
    const int begin = row_ptr[n], end = row_ptr[n + 1];
    const int prio_p = pb_prio[p];
    const float* preq = pb_req + (long long)p * R;
    const float* nreq = requested + (long long)n * R;
    const float* nalloc = alloc + (long long)n * R;
    for (int l = 0; l < L; ++l) {
      const int thresh = min(levels[l], prio_p);
      float rem[MAX_R];
      for (int r = 0; r < R; ++r) rem[r] = 0.0f;
      float cnt = 0.0f, ps = 0.0f, g = 0.0f;
      int32_t mx = INT_MIN_;
      for (int k = begin; k < end; ++k) {
        const int m = rows[k];
        const int prio_m = ep_prio[m];
        const bool cls = live[m] && prio_m < thresh;
        const float w = cls ? 1.0f : 0.0f;
        const float* req_m = ep_req + (long long)m * R;
        for (int r = 0; r < R; ++r)
          rem[r] = __fadd_rn(rem[r], __fmul_rn(w, req_m[r]));
        cnt = __fadd_rn(cnt, w);
        ps = __fadd_rn(ps, __fmul_rn(w, (float)prio_m));
        if (gang_w != nullptr) g = __fadd_rn(g, __fmul_rn(w, gang_w[m]));
        mx = max(mx, cls ? prio_m : NEG);
      }
      bool fits = true;
      for (int r = 0; r < R; ++r) {
        const float used = __fadd_rn(__fsub_rn(nreq[r], rem[r]), preq[r]);
        const bool check = r < r_fixed || preq[r] > 0.0f;
        if (check && !(used <= nalloc[r])) fits = false;
      }
      fits = fits && (pod_count[n] - (int)cnt + 1 <= allowed[n]);
      if (fits) {  // the lowest feasible level wins
        ok = 1;
        victims = (int)cnt;
        pmax = mx;
        psum = ps;
        gang = g;
        break;
      }
    }
  }
  out[idx] = ok;
  out[PN + idx] = victims;
  out[2 * PN + idx] = pmax;
  out[3 * PN + idx] = __float_as_int(psum);
  out[4 * PN + idx] = __float_as_int(gang);
}

}  // namespace

extern "C" {

// The most resource columns the kernel holds (ops/preempt.py checks R
// against it before a launch).
int kpw_max_resources() { return MAX_R; }

// gang_w may be null (no gang weights: plane 4 is all zero). static_ok is
// uint8 [P, N] (a torch.bool tensor's storage); live uint8 [M]; every other
// array float32 or int32 and contiguous. Returns cudaGetLastError() after
// the launch.
int kpw_preempt_whatif(const float* alloc, const float* requested,
                       const int* pod_count, const int* allowed,
                       const float* ep_req, const int* ep_prio,
                       const uint8_t* live, const float* gang_w,
                       const int* row_ptr, const int* rows,
                       const int* levels, const float* pb_req,
                       const int* pb_prio, const uint8_t* static_ok, int P,
                       int N, int R, int L, int r_fixed, int32_t* out,
                       cudaStream_t stream) {
  if (P <= 0 || N <= 0) return 0;
  if (R > MAX_R || R < 0 || L < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)P * N;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  whatif_kernel<<<dim3((unsigned)blocks), dim3(THREADS), 0, stream>>>(
      alloc, requested, pod_count, allowed, ep_req, ep_prio, live, gang_w,
      row_ptr, rows, levels, pb_req, pb_prio, static_ok, P, N, R, L, r_fixed,
      out);
  return (int)cudaGetLastError();
}

const char* kpw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
