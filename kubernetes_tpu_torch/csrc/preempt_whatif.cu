// The preemption what-if as five small CUDA kernels for Hopper (sm_90a),
// bound to PyTorch through a plain C entry per step, loaded with ctypes
// (kubernetes_tpu_torch/ops/preempt.py builds and calls them).
//
// Replaces: the XLA program _preemption_stats
// (kubernetes_tpu/ops/preempt.py:85). It is not a Pallas kernel; it gets a
// hand-written kernel because its sums must come out bit-equal to the JAX
// package's on the CPU, and the plain PyTorch version's index_add_ adds by
// float atomics in an arbitrary order on the card.
//
// What it computes. For each (failed pod p, node n), walk the candidate
// priority levels in order; at level l the victim class is every live
// existing pod (valid and alive) on n whose priority is below
// thresh = min(levels[l], prio_p). With the class removed, re-check the
// pod's resource fit and the node's pod count. The first level that fits
// (on a node that passes the pod's static predicates, static_ok) wins, and
// its stats are written:
//   plane 0  ok (1 / 0)
//   plane 1  victim count             (int, from the f32 count)
//   plane 2  victim priority max      (int; INT32_MIN for a node no row
//            points at, NEG for a node with rows but no victim)
//   plane 3  victim priority sum      (f32, bit pattern in the int plane)
//   plane 4  victim gang weight sum   (f32, bit pattern; 0 without weights)
// A (p, n) that never fits writes ok = 0, zero stats and NEG.
//
// Bit-equality with the JAX program, which it is tested against:
//   * the JAX program adds w * x over EVERY row of a node in increasing
//     row index (XLA's segment_sum on the CPU), with w = 1 for a victim and
//     0 otherwise. Here each sum runs over the node's rows in the same
//     order, every f32 multiply and add rounded on its own (__fmul_rn,
//     __fadd_rn, __fsub_rn; no FMA contraction, no reassociation);
//   * the gang sum is a select, not a product: XLA evaluates the JAX
//     program's w * gang_w (w a converted bool) as select(w, gang_w, 0), so
//     a non-victim adds nothing even where its weight is not finite;
//   * rows that can never be victims (not live) are left out of a node's
//     list when their requests are finite: such a row adds 0 * x = +-0,
//     and a sum that starts at +0 never becomes -0, so adding +-0 changes
//     no bit. A non-live row with a non-finite request stays in the list
//     (0 * inf is NaN);
//   * the priority max of a node is the max over all its rows of
//     (victim ? prio : NEG), from INT32_MIN: a left-out row adds NEG, so
//     the walk starts at NEG when the node has a left-out row;
//   * the fit test keeps the JAX op order, (requested - removed) + req
//     <= alloc on the checked columns (core columns always, extended ones
//     when requested), and pod_count - int(count) + 1 <= allowed_pods.
//
// The steps, on one stream:
//   1. whatif_row_keys: a sort key per existing-pod row: its node when it
//      is kept, N + 1 + node when it is left out, 2N + 1 when it belongs to
//      no node (max(node, 0) >= N).
//   (the caller sorts the keys stably: torch.sort)
//   2. whatif_row_bounds: from the sorted keys, bounds [2N + 2] (the first
//      sorted position of each key) and the rows as int32: node n's kept
//      rows, in row order, are rows[bounds[n] .. bounds[n + 1]), and it has
//      a left-out row iff bounds[N + 2 + n] > bounds[N + 1 + n].
//   3. whatif_slots: the distinct thresholds min(levels[l], prio_p) of the
//      chunk, ascending (slot_values, S of them, S <= L + P - 1), and each
//      (p, l)'s slot (slot_of [P, L]). The victim class depends only on
//      (threshold, node), so its sums are taken once per slot, not once
//      per pod.
//   4. whatif_class_stats: one warp per (node, 32 slots) stages the node's
//      kept rows in shared memory; each lane adds them in order for its
//      slot, keeping the R request sums, the count, the priority sum, the
//      gang sum and the priority max in registers. It writes stats
//      [S, R + 4, N] (one plane per field, node fastest).
//   5. whatif_pick: one thread per 4 consecutive (p, n) entries walks the
//      levels through slot_of and the stats (a level whose slot equals the
//      level before's is skipped: same class, same answer) and writes the
//      five planes as 16-byte streaming stores (scalar stores when
//      P * N % 4 != 0 or a pointer is not aligned). When N % 4 == 0 the 4
//      entries share a pod: static_ok is read as 4 bytes and each slot
//      lookup and 16-byte stats load serves all four.
//
// What bounds it on the card: bytes. The [5, P, N] output (21 MB on the
// preempt drain's chunk, P = 128, N = 8192) is most of what the function
// must move; the class sums are a few rows a node and the stats table
// stays in the 50 MB L2. Tensor cores, wgmma and TMA have no place here:
// the sums are sequential by definition and must not be reassociated. The
// design keeps the walks short (kept rows only; before, node 0's threads
// walked ~12 700 free and pad rows in every level), the work per pod a
// lookup (one class pass per threshold, not per (pod, node, level)), the
// class walks out of device memory (rows staged in shared memory, one
// lane a threshold), and the pick's stores 16 bytes wide, so that the
// pick's streaming stores take most of the kernels' time (PERF.md, PR 5;
// kernel_variants.py times each choice undone).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_R = 16;  // resource columns (class sums held in registers)
constexpr int32_t NEG = -2147483647;  // -(2**31) + 1
constexpr int32_t INT_MIN_ = -2147483647 - 1;
// The design's four choices; kernel_variants.py turns each off in turn
// to time what it buys.
constexpr bool LIVE_ROWS_ONLY = true;  // false: every row in the lists
constexpr bool SHARE_SLOTS = true;     // false: one slot per (pod, level)
constexpr bool VECTOR_STORES = true;   // false: scalar stores in the pick
constexpr bool ROW_LOADS = true;       // false: the pick loads per entry

constexpr int ROW_THREADS = 256;
constexpr int SLOT_THREADS = 256;
constexpr int SLOT_SMEM = 48 * 1024;  // the slot kernel's shared memory
constexpr int STATS_WARPS = 4;  // nodes a block of whatif_class_stats
constexpr int STAGE = 128;      // rows a class-stats warp stages at once
constexpr int PICK_THREADS = 256;
constexpr int PICK_GROUPS = 1;  // groups of 4 entries a pick thread takes
// whatif_class_stats: blocks over slots (32 a block row) are added until
// about this many blocks run, at most MAX_SLOT_BLOCKS; a block walks the
// slots 32 y, 32 (y + gridDim.y), ...
constexpr int STATS_BLOCKS = 2048;
constexpr int MAX_SLOT_BLOCKS = 8;

__global__ void __launch_bounds__(ROW_THREADS)
whatif_row_keys(const int* __restrict__ ep_node,     // [M]
                const uint8_t* __restrict__ live,    // [M]
                const float* __restrict__ ep_req,    // [M, R]
                int M, int N, int R, int* __restrict__ keys) {  // [M]
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const int id = max(ep_node[m], 0);
  int key = 2 * N + 1;  // no node
  if (id < N) {
    bool kept = !LIVE_ROWS_ONLY || live[m] != 0;
    for (int r = 0; r < R && !kept; ++r)
      kept = !isfinite(ep_req[(long long)m * R + r]);
    key = kept ? id : N + 1 + id;
  }
  keys[m] = key;
}

// bounds[k] = the number of sorted keys below k, k in [0, 2N + 2), by a
// binary search; threads below M also copy the sort's int64 order to rows.
__global__ void __launch_bounds__(ROW_THREADS)
whatif_row_bounds(const int* __restrict__ skeys,      // [M] ascending
                  const int64_t* __restrict__ order,  // [M]
                  int M, int nb, int* __restrict__ bounds,  // [nb]
                  int* __restrict__ rows) {  // [M]
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) rows[i] = (int)order[i];
  if (i < nb) {
    int lo = 0, hi = M;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (skeys[mid] < i) lo = mid + 1;
      else hi = mid;
    }
    bounds[i] = lo;
  }
}

// One block. Candidate j is levels[j] (j < L) or pb_prio[j - L]. A
// candidate v is a threshold of some (p, l) iff some pod priority reaches
// it (a level) or some level reaches it (a priority). flags marks the first
// candidate of each distinct threshold; a candidate's rank is the number of
// distinct thresholds below it, which is the slot of the threshold it
// equals; and since the rank is monotone, the slot of min(level, prio) is
// min(rank(level), rank(prio)). The candidates, flags and ranks live in
// shared memory (`work`), or in global scratch when they do not fit.
__global__ void __launch_bounds__(SLOT_THREADS)
whatif_slots(const int* __restrict__ levels,   // [L]
             const int* __restrict__ pb_prio,  // [P]
             int P, int L,
             int* __restrict__ slot_values,  // [max slots]
             int* __restrict__ slot_of,      // [P, L]
             int* scratch,                   // [3 (L + P)] or null
             int* __restrict__ n_slots) {    // [1]
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x;
  if (!SHARE_SLOTS) {
    for (int i = t; i < P * L; i += blockDim.x) {
      const int p = i / L;
      slot_values[i] = min(levels[i - p * L], pb_prio[p]);
      slot_of[i] = i;
    }
    if (t == 0) *n_slots = P * L;
    return;
  }
  const int U = L + P;
  int* cand = scratch != nullptr ? scratch : reinterpret_cast<int*>(smem);
  int* flags = cand + U;
  int* ranks = flags + U;
  for (int j = t; j < U; j += blockDim.x)
    cand[j] = j < L ? levels[j] : pb_prio[j - L];
  __syncthreads();
  int top_level = INT_MIN_, top_prio = INT_MIN_;
  for (int j = 0; j < L; ++j) top_level = max(top_level, cand[j]);
  for (int j = L; j < U; ++j) top_prio = max(top_prio, cand[j]);
  for (int j = t; j < U; j += blockDim.x) {
    const int v = cand[j];
    bool first = j < L ? top_prio >= v : top_level >= v;
    for (int k = 0; k < j && first; ++k) first = cand[k] != v;
    flags[j] = first ? 1 : 0;
  }
  __syncthreads();
  for (int j = t; j < U; j += blockDim.x) {
    const int v = cand[j];
    int below = 0;
    for (int k = 0; k < U; ++k) below += flags[k] && cand[k] < v;
    ranks[j] = below;
    if (flags[j]) slot_values[below] = v;
  }
  __syncthreads();
  for (int i = t; i < P * L; i += blockDim.x) {
    const int p = i / L;
    slot_of[i] = min(ranks[i - p * L], ranks[L + p]);
  }
  if (t == 0) {
    int s = 0;
    for (int k = 0; k < U; ++k) s += flags[k];
    *n_slots = s;
  }
}

// One warp per (node, 32 slots): lane l owns slot s0 + l and keeps all
// R + 4 sums of its class in registers (RB >= R of them for the
// requests). The warp stages up to STAGE of the node's kept rows in
// shared memory — each lane loads rows lane, lane + 32, ...: one round of
// independent loads — as (priority, or INT32_MAX when the row is not live,
// so that one compare tells a victim; the priority as f32; the gang
// weight; the R requests); then every lane adds the staged rows in order,
// each row read by all lanes at once. A node with more rows is staged
// again for each STAGE of them, one with fewer once for all its slots.
template <int RB>
__global__ void __launch_bounds__(STATS_WARPS * 32)
whatif_class_stats(const float* __restrict__ ep_req,     // [M, R]
                   const int* __restrict__ ep_prio,      // [M]
                   const uint8_t* __restrict__ live,     // [M]
                   const float* __restrict__ gang_w,     // [M] or null
                   const int* __restrict__ bounds,       // [2N + 2]
                   const int* __restrict__ rows,         // [M]
                   const int* __restrict__ slot_values,  // [S]
                   const int* __restrict__ n_slots,      // [1]
                   int N, int R,
                   int32_t* __restrict__ stats) {  // [S, R + 4, N]
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = R + 3;  // words of a staged row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * STATS_WARPS + warp;
  if (n >= N) return;  // the whole warp
  int32_t* staged = reinterpret_cast<int32_t*>(smem) + warp * STAGE * W;
  const int S = *n_slots;
  const int begin = bounds[n], end = bounds[n + 1];
  const bool left_out = bounds[N + 2 + n] > bounds[N + 1 + n];
  const bool gang = gang_w != nullptr;
  const long long plane = (long long)(R + 4) * N;
  int held = -1;  // the first row of the staged rows
  for (int s0 = blockIdx.y * 32; s0 < S; s0 += gridDim.y * 32) {
    const int s = s0 + lane;
    const int thresh = s < S ? slot_values[s] : INT_MIN_;  // past S: none
    float req[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) req[r] = 0.0f;
    float cnt = 0.0f, psum = 0.0f, gsum = 0.0f;
    int32_t mx = left_out ? NEG : INT_MIN_;
    for (int k0 = begin; k0 < end; k0 += STAGE) {
      const int rows_here = min(STAGE, end - k0);
      if (k0 != held) {
        __syncwarp();  // every lane is done with the rows held before
        for (int i = lane; i < rows_here; i += 32) {
          const int m = rows[k0 + i];
          const int prio = ep_prio[m];
          int32_t* row = staged + i * W;
          row[0] = live[m] ? prio : 0x7fffffff;
          row[1] = __float_as_int((float)prio);
          row[2] = gang ? __float_as_int(gang_w[m]) : 0;
          for (int r = 0; r < R; ++r)
            row[3 + r] = __float_as_int(ep_req[(long long)m * R + r]);
        }
        __syncwarp();
        held = k0;
      }
      for (int i = 0; i < rows_here; ++i) {
        const int32_t* row = staged + i * W;
        const bool cls = row[0] < thresh;
        const float w = cls ? 1.0f : 0.0f;
#pragma unroll
        for (int r = 0; r < RB; ++r)
          if (r < R)
            req[r] = __fadd_rn(req[r],
                               __fmul_rn(w, __int_as_float(row[3 + r])));
        cnt = __fadd_rn(cnt, w);
        psum = __fadd_rn(psum, __fmul_rn(w, __int_as_float(row[1])));
        // the gang sum is a select: a non-victim adds nothing
        if (cls) gsum = __fadd_rn(gsum, __int_as_float(row[2]));
        mx = max(mx, cls ? row[0] : NEG);
      }
    }
    if (s < S) {
      int32_t* out = stats + s * plane + n;
#pragma unroll
      for (int r = 0; r < RB; ++r)
        if (r < R) out[(long long)r * N] = __float_as_int(req[r]);
      out[(long long)R * N] = __float_as_int(cnt);
      out[(long long)(R + 1) * N] = __float_as_int(psum);
      out[(long long)(R + 2) * N] = __float_as_int(gsum);
      out[(long long)(R + 3) * N] = mx;
    }
  }
}

// The fit test of (p, n) against slot s's class: (requested - removed)
// + req <= alloc on the checked columns, then the pod count.
__device__ __forceinline__ bool fits_class(
    const float* __restrict__ preq, const float* __restrict__ nreq,
    const float* __restrict__ nalloc, const int32_t* __restrict__ st, int N,
    int R, int r_fixed, int pod_count, int allowed) {
  for (int r = 0; r < R; ++r) {
    const float q = preq[r];
    const float used =
        __fadd_rn(__fsub_rn(nreq[r], __int_as_float(st[r * N])), q);
    if ((r < r_fixed || q > 0.0f) && !(used <= nalloc[r])) return false;
  }
  return pod_count - (int)__int_as_float(st[R * N]) + 1 <= allowed;
}

// The 4 entries i0 .. i0 + 3 of the [P, N] result (those below P * N):
// res[plane][j] for the five planes.
__device__ __forceinline__ void pick4(
    const float* __restrict__ alloc, const float* __restrict__ requested,
    const int* __restrict__ pod_count, const int* __restrict__ allowed,
    const float* __restrict__ pb_req, const uint8_t* __restrict__ static_ok,
    const int* __restrict__ slot_of, const int32_t* __restrict__ stats,
    long long i0, long long PN, int N, int R, int L, int r_fixed, int rows4,
    int32_t (&res)[5][4]) {
  const long long plane = (long long)(R + 4) * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    res[0][j] = 0;
    res[1][j] = 0;
    res[2][j] = NEG;
    res[3][j] = 0;
    res[4][j] = 0;
  }
  if (rows4) {
    // the 4 entries are nodes n0 .. n0 + 3 of pod p's row: one slot
    // lookup and one 16-byte load a stats field serve all four
    const int p = (int)(i0 / N);
    const int n0 = (int)(i0 - (long long)p * N);
    const uint32_t ok4 = *reinterpret_cast<const uint32_t*>(static_ok + i0);
    int todo = 0;  // bit j: entry j walks on
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if ((ok4 >> (8 * j)) & 0xffu) todo |= 1 << j;
    const float* preq = pb_req + (long long)p * R;
    int prev = -1;
    for (int l = 0; l < L && todo; ++l) {
      const int s = slot_of[p * L + l];
      if (s == prev) continue;  // the same class did not fit
      prev = s;
      const int32_t* st = stats + s * plane + n0;
      int fit = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (((todo >> j) & 1) &&
            fits_class(preq, requested + (long long)(n0 + j) * R,
                       alloc + (long long)(n0 + j) * R, st + j, N, R,
                       r_fixed, pod_count[n0 + j], allowed[n0 + j]))
          fit |= 1 << j;
      if (fit) {  // the lowest feasible level wins
        const int4 cnt = *reinterpret_cast<const int4*>(st + R * N);
        const int4 ps = *reinterpret_cast<const int4*>(st + (R + 1) * N);
        const int4 gs = *reinterpret_cast<const int4*>(st + (R + 2) * N);
        const int4 mx = *reinterpret_cast<const int4*>(st + (R + 3) * N);
        const int c[4] = {cnt.x, cnt.y, cnt.z, cnt.w};
        const int a[4] = {ps.x, ps.y, ps.z, ps.w};
        const int b[4] = {gs.x, gs.y, gs.z, gs.w};
        const int d[4] = {mx.x, mx.y, mx.z, mx.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if ((fit >> j) & 1) {
            res[0][j] = 1;
            res[1][j] = (int)__int_as_float(c[j]);
            res[2][j] = d[j];
            res[3][j] = a[j];
            res[4][j] = b[j];
          }
        todo &= ~fit;
      }
    }
    return;
  }
  for (int j = 0; j < 4; ++j) {
    const long long i = i0 + j;
    if (i >= PN || !static_ok[i]) continue;
    const int p = (int)(i / N);
    const int n = (int)(i - (long long)p * N);
    const float* preq = pb_req + (long long)p * R;
    int prev = -1;
    for (int l = 0; l < L; ++l) {
      const int s = slot_of[p * L + l];
      if (s == prev) continue;  // the same class did not fit
      prev = s;
      const int32_t* st = stats + s * plane + n;
      if (fits_class(preq, requested + (long long)n * R,
                     alloc + (long long)n * R, st, N, R, r_fixed,
                     pod_count[n], allowed[n])) {
        res[0][j] = 1;  // the lowest feasible level wins
        res[1][j] = (int)__int_as_float(st[R * N]);
        res[2][j] = st[(R + 3) * N];
        res[3][j] = st[(R + 1) * N];
        res[4][j] = st[(R + 2) * N];
        break;
      }
    }
  }
}

__global__ void __launch_bounds__(PICK_THREADS)
whatif_pick(const float* __restrict__ alloc,      // [N, R]
            const float* __restrict__ requested,  // [N, R]
            const int* __restrict__ pod_count,    // [N]
            const int* __restrict__ allowed,      // [N]
            const float* __restrict__ pb_req,     // [P, R]
            const uint8_t* __restrict__ static_ok,  // [P, N]
            const int* __restrict__ slot_of,      // [P, L]
            const int32_t* __restrict__ stats,    // [S, R + 4, N]
            int P, int N, int R, int L, int r_fixed, int vec, int rows4,
            int32_t* __restrict__ out) {  // [5, P, N]
  const long long PN = (long long)P * N;
  const long long stride = 4LL * gridDim.x * blockDim.x;
  for (long long i0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
       i0 < PN; i0 += stride) {
    int32_t res[5][4];
    pick4(alloc, requested, pod_count, allowed, pb_req, static_ok, slot_of,
          stats, i0, PN, N, R, L, r_fixed, rows4, res);
    if (vec) {
      for (int k = 0; k < 5; ++k)
        __stcs(reinterpret_cast<int4*>(out + k * PN + i0),
               make_int4(res[k][0], res[k][1], res[k][2], res[k][3]));
    } else {
      for (int j = 0; j < 4 && i0 + j < PN; ++j)
        for (int k = 0; k < 5; ++k) out[k * PN + i0 + j] = res[k][j];
    }
  }
}

int blocks_for(long long threads, int per_block) {
  return (int)((threads + per_block - 1) / per_block);
}

int clamp_int(int v, int lo, int hi) { return v < lo ? lo : v > hi ? hi : v; }

}  // namespace

extern "C" {

// The most resource columns the kernels hold (ops/preempt.py checks R
// against it before a launch).
int kpw_max_resources() { return MAX_R; }

// The most threshold slots a chunk of P pods and L levels can need: the
// size of slot_values and of the stats table's first axis.
int kpw_max_slots(int P, int L) { return SHARE_SLOTS ? L + P : P * L; }

// Every entry returns cudaGetLastError() after its launches (0 on
// success). Arrays are contiguous: float32 or int32 unless named; live
// and static_ok are uint8 (a torch.bool tensor's storage); gang_w may be
// null (no gang weights: plane 4 is all zero).

// Step 1: keys [M] int32 for the stable sort.
int kpw_row_keys(const int* ep_node, const uint8_t* live, const float* ep_req,
                 int M, int N, int R, int* keys, cudaStream_t stream) {
  if (M <= 0) return 0;
  if (N < 0 || N > (1 << 29) || R < 0) return (int)cudaErrorInvalidValue;
  whatif_row_keys<<<dim3(blocks_for(M, ROW_THREADS)), dim3(ROW_THREADS), 0,
                    stream>>>(ep_node, live, ep_req, M, N, R, keys);
  return (int)cudaGetLastError();
}

// Step 2: bounds [2N + 2] and rows [M] int32 from the sorted keys and the
// sort's int64 order.
int kpw_row_bounds(const int* skeys, const int64_t* order, int M, int N,
                   int* bounds, int* rows, cudaStream_t stream) {
  if (M < 0 || N < 0 || N > (1 << 29)) return (int)cudaErrorInvalidValue;
  const int nb = 2 * N + 2;
  const int threads = M > nb ? M : nb;
  whatif_row_bounds<<<dim3(blocks_for(threads, ROW_THREADS)),
                      dim3(ROW_THREADS), 0, stream>>>(skeys, order, M, nb,
                                                      bounds, rows);
  return (int)cudaGetLastError();
}

// Step 3: slot_values [kpw_max_slots(P, L)], slot_of [P, L], n_slots [1];
// scratch holds 3 (L + P) ints (used when they do not fit in 48 KB of
// shared memory).
int kpw_threshold_slots(const int* levels, const int* pb_prio, int P, int L,
                        int* slot_values, int* slot_of, int* scratch,
                        int* n_slots, cudaStream_t stream) {
  if (P <= 0 || L < 0) return (int)cudaErrorInvalidValue;
  const long long bytes = 3LL * (L + P) * (long long)sizeof(int);
  const bool in_smem = bytes <= SLOT_SMEM;
  whatif_slots<<<dim3(1), dim3(SLOT_THREADS), in_smem ? (size_t)bytes : 0,
                 stream>>>(levels, pb_prio, P, L, slot_values, slot_of,
                           in_smem ? nullptr : scratch, n_slots);
  return (int)cudaGetLastError();
}

// Steps 4 and 5 on a built row list and slot table: stats is scratch of
// [max_slots, R + 4, N] int32, out the [5, P, N] int32 result.
int kpw_class_stats_and_pick(
    const float* alloc, const float* requested, const int* pod_count,
    const int* allowed, const float* ep_req, const int* ep_prio,
    const uint8_t* live, const float* gang_w, const int* bounds,
    const int* rows, const int* slot_values, const int* n_slots,
    const int* slot_of, const float* pb_req, const uint8_t* static_ok, int P,
    int N, int R, int L, int r_fixed, int max_slots, int32_t* stats,
    int32_t* out, cudaStream_t stream) {
  if (P <= 0 || N <= 0) return 0;
  if (R > MAX_R || R < 0 || L < 0 || max_slots < 0)
    return (int)cudaErrorInvalidValue;
  const int bx = blocks_for(N, STATS_WARPS);
  const int by = clamp_int(blocks_for(STATS_BLOCKS, bx), 1,
                           clamp_int(blocks_for(max_slots, 32), 1,
                                     MAX_SLOT_BLOCKS));
  const size_t stage_bytes = (size_t)STATS_WARPS * STAGE * (R + 3) * 4;
  // the request sums in registers: RB of them, the fewest that hold R
  auto stats_kernel = R <= 4   ? whatif_class_stats<4>
                      : R <= 8 ? whatif_class_stats<8>
                               : whatif_class_stats<MAX_R>;
  stats_kernel<<<dim3(bx, by), dim3(STATS_WARPS * 32), stage_bytes,
                 stream>>>(ep_req, ep_prio, live, gang_w, bounds, rows,
                           slot_values, n_slots, N, R, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long PN = (long long)P * N;
  const long long threads = (PN + 3) / 4;
  const int pick_blocks = blocks_for(threads, PICK_THREADS * PICK_GROUPS);
  if (pick_blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  const int vec = VECTOR_STORES && PN % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int rows4 = ROW_LOADS && N % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(static_ok) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(stats) % 16 == 0;
  whatif_pick<<<dim3(pick_blocks), dim3(PICK_THREADS), 0, stream>>>(
      alloc, requested, pod_count, allowed, pb_req, static_ok, slot_of, stats,
      P, N, R, L, r_fixed, vec, rows4, out);
  return (int)cudaGetLastError();
}

const char* kpw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
