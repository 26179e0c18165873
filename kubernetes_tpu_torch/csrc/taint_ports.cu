// PodToleratesNodeTaints + PodFitsHostPorts as one CUDA kernel for Hopper
// (sm_90a), bound to PyTorch through a plain C entry loaded with ctypes
// (kubernetes_tpu_torch/ops/taint_ports.py builds and calls it).
//
// Replaces: the Pallas TPU kernel _taint_ports_kernel / taint_ports_masks
// (kubernetes_tpu/ops/pallas_kernels.py:41, :98). Semantics: reference
// predicates.go:1504 (taints, restricted to an effect set) and :991 (host
// ports), as the plain version in ops/taint_ports.py spells them out.
//
// What bounds it on this card:
//   * at the round's shape (P = W*128 pod rows against the N-node bucket,
//     16384 x 8192 at full width) it is a write stream: two uint8 [P, N]
//     outputs, 268 MB, against a few int32 per node and per pod. Most pods
//     carry no toleration and no host port and most nodes no relevant
//     taint, so almost every output byte needs no compare at all;
//   * on a dense world (most pods with live tolerations, most nodes with
//     relevant taints) it is bound by integer operations: ~8 per (relevant
//     node taint, live pod toleration) pair and 2 per (live pod port, live
//     node port) pair, on the SM's 64 INT32 lanes.
//
// What the design does about it:
//   1. Pod pre-pass in shared memory. A block walks the pod axis in chunks
//      of PB rows; for each chunk four warps stage the rows' live
//      tolerations (op != TOL_PAD) and live host ports (> 0), compacted,
//      with a count per row. Pads may sit anywhere in a row. A row's slots
//      are loaded four at a time with no branch between the loads, so a
//      chunk costs one trip to memory, not one per slot; the chunk after
//      the one being computed is staged into a second buffer, so one
//      __syncthreads per chunk suffices. Every thread of a warp works on
//      the same pod row, so the branches on a row's counts (no toleration:
//      skip the taint test; no port: skip the port test; 1-4 live entries:
//      a loop unrolled for exactly that many, held in registers) are
//      uniform across the warp.
//   2. Node pre-pass. Each thread owns VN = 16 nodes. The relevant taints
//      (effect in eff_mask) and live host ports of its nodes are compacted
//      into one flat list per thread, each entry tagged with its node, in
//      shared planes laid out [entry][thread] so a warp's reads of one
//      entry are conflict-free. Taint entries that repeat a (key, value,
//      effect) are merged into one whose tag holds all their nodes' bits
//      (nodes of a pool carry the same taints). The per-row tests walk
//      these lists once: the work is the thread's count of distinct
//      relevant taints, not 16 times the most any one of its nodes has,
//      and lanes do not diverge on per-node counts. What stays in
//      registers is the two list lengths and the 16-byte "no relevant
//      taint" word: a node with no relevant taint writes taints = 1
//      without touching the pod's tolerations, and a pod with no
//      toleration writes that word as it is.
//   3. Wide stores. A thread writes one 16-byte word per pod row per
//      output (streaming stores: the round reads them much later); a warp
//      writes 512 contiguous bytes per store instruction. Rows that are
//      not 16-byte aligned (N % 16 != 0, e.g. N = 5000 or 5003) and the
//      ragged node edge take 8-, 4- or 1-byte stores chosen per row; the
//      inputs are not padded.
//   4. Block shape. 256 threads: TX threads across nodes (32, one warp per
//      pod row; 16 when the node tile would not fit in shared memory,
//      e.g. T = 16 taint and PP = 64 port slots) times 256/TX pod rows.
//      Blocks are persistent along the pod axis: the grid has
//      ceil(N / (TX*VN)) node tiles and only as many pod-chunk walkers
//      per tile as fill the SMs at the kernel's occupancy (cudaOccupancy
//      API), so each node tile is staged once per block, not once per pod
//      chunk. The shared-memory plan is kept under a quarter of the SM's
//      228 KB at the round's widths (T = 4, TL = 4, PP = 8, PQ = 4:
//      56 960 B), so 4 blocks (32 warps) share an SM: the dense world's
//      compare loops use the warps to hide shared-memory latency (at 3
//      blocks an SM they ran slower, the store path a little faster:
//      kernel_variants.py). At P = 16384,
//      N = 8192: 16 tiles x 32 walkers of 8 chunks, one wave on 132 SMs.
//      At P = 128, N = 5000: 10 tiles x 2 chunks, bound by launch latency,
//      not by the card. Twice the walkers balance the dense world's
//      compute better but stage every node tile twice; the round's inputs
//      are the case this is tuned for.
// No wgmma, TMA or tensor cores: integer compares, no matrix product.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // per block
constexpr int VN = 16;        // consecutive nodes per thread
constexpr int PB = 64;        // pod rows per staged chunk
constexpr int GROUP = 4;      // slots loaded together while staging
constexpr int MERGE_MAX = 64;  // longest taint list whose repeats are merged
constexpr int SHARED_OPT_IN = 232448;  // bytes an sm_90 block may opt into
constexpr int TOL_PAD = -1;
constexpr int TOL_EXISTS = 1;

__host__ __device__ inline int round16(int b) { return (b + 15) & ~15; }

// The shared-memory plan of a block with tx threads across nodes; each
// comment names the region that ends at that offset.
struct Layout {
  int nb, off_pp, off_cnt, off_nt, off_kv, off_ee, off_ep, off_epi, off_ncnt,
      bytes;
  __host__ __device__ Layout(int tx, int T, int PP, int TL, int PQ) {
    nb = tx * VN;
    off_pp = 2 * PB * TL * 16;                   // int4 tolerations
    off_cnt = off_pp + 2 * PB * PQ * 4;          // int ports
    off_nt = off_cnt + 2 * 2 * PB * 2;           // uint16 counts
    off_kv = round16(off_nt + tx * 4);           // int list lengths
    off_ee = off_kv + nb * T * 8;                // int2 taint key, value
    off_ep = off_ee + nb * T * 4;                // int effect | node bit
    off_epi = off_ep + nb * PP * 4;              // int node port
    off_ncnt = round16(off_epi + nb * PP);       // uint8 its node
    bytes = off_ncnt + 2 * nb;                   // uint8 node counts
  }
};

__device__ inline bool tolerates(const int4& tol, int key, int val, int eff) {
  return ((tol.x == 0) | (tol.x == key)) &
         ((tol.z == TOL_EXISTS) | (tol.y == val)) &
         ((tol.w == 0) | (tol.w == eff));
}

// bits 0..3 of m -> bytes 0..3 of a word, each 0 or 1
__device__ inline uint32_t spread4(uint32_t m) {
  return ((m & 0xfu) * 0x00204081u) & 0x01010101u;
}

__device__ inline uint4 spread16(uint32_t m) {
  return make_uint4(spread4(m), spread4(m >> 4), spread4(m >> 8),
                    spread4(m >> 12));
}

__device__ inline int byte_of(const uint4& w, int i) {
  const uint32_t x = i < 4 ? w.x : i < 8 ? w.y : i < 12 ? w.z : w.w;
  return (x >> ((i & 3) * 8)) & 0xff;
}

// The nodes (bits) of a thread's taint list that none of the row's L
// live tolerations tolerates; L = 0: the row has lt > 4, read from
// shared memory. An entry's effect is its low 16 bits, its node's bit
// the high 16.
template <int L>
__device__ inline unsigned untolerated(const int4* tol, int lt,
                                       const int2* kv, const int* ee, int n,
                                       int TX) {
  int4 t[L > 0 ? L : 1];
#pragma unroll
  for (int l = 0; l < L; ++l) t[l] = tol[l];
  unsigned untol = 0;
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const int2 k = kv[j * TX];
    const unsigned e = ee[j * TX];
    const int eff = e & 0xffffu;
    bool m = false;
    if (L > 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) m |= tolerates(t[l], k.x, k.y, eff);
    } else {
      for (int l = 0; l < lt && !m; ++l) m = tolerates(tol[l], k.x, k.y, eff);
    }
    untol |= m ? 0u : e >> 16;
  }
  return untol;
}

// The nodes (bits) of a thread's port list that one of the row's L live
// ports asks for; L = 0: the row has lq > 4.
template <int L>
__device__ inline unsigned clashing(const int* want, int lq, const int* ep,
                                    const uint8_t* node, int n, int TX) {
  int q[L > 0 ? L : 1];
#pragma unroll
  for (int l = 0; l < L; ++l) q[l] = want[l];
  unsigned clash = 0;
#pragma unroll 2
  for (int j = 0; j < n; ++j) {
    const int port = ep[j * TX];
    bool c = false;
    if (L > 0) {
#pragma unroll
      for (int l = 0; l < L; ++l) c |= port == q[l];
    } else {
      for (int l = 0; l < lq && !c; ++l) c = port == want[l];
    }
    clash |= (c ? 1u : 0u) << node[j * TX];
  }
  return clash;
}

// One row's VN bytes at dst; nvalid < VN at the ragged node edge.
__device__ inline void store_row(uint8_t* dst, const uint4& w, int nvalid) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (nvalid >= VN) {
    if ((a & 15) == 0) {
      __stcs(reinterpret_cast<uint4*>(dst), w);  // streamed: read much later
      return;
    }
    if ((a & 7) == 0) {
      reinterpret_cast<uint2*>(dst)[0] = make_uint2(w.x, w.y);
      reinterpret_cast<uint2*>(dst)[1] = make_uint2(w.z, w.w);
      return;
    }
    if ((a & 3) == 0) {
      uint32_t* d = reinterpret_cast<uint32_t*>(dst);
      d[0] = w.x;
      d[1] = w.y;
      d[2] = w.z;
      d[3] = w.w;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < VN; ++i) {
    if (i < nvalid) dst[i] = (uint8_t)byte_of(w, i);
  }
}

__global__ void __launch_bounds__(THREADS)
taint_ports_kernel(const int* __restrict__ tk, const int* __restrict__ tv,
                   const int* __restrict__ te, const int* __restrict__ nports,
                   const int* __restrict__ pk, const int* __restrict__ pv,
                   const int* __restrict__ po, const int* __restrict__ pe,
                   const int* __restrict__ pports,
                   uint8_t* __restrict__ taints_out,
                   uint8_t* __restrict__ ports_out,
                   int P, int N, int T, int TL, int PP, int PQ,
                   unsigned eff_mask) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TX = blockDim.x;
  const Layout L(TX, T, PP, TL, PQ);
  int4* s_tol = reinterpret_cast<int4*>(smem);            // [2][PB][TL]
  int* s_pp = reinterpret_cast<int*>(smem + L.off_pp);    // [2][PB][PQ]
  uint16_t* s_lt = reinterpret_cast<uint16_t*>(smem + L.off_cnt);  // [2][PB]
  uint16_t* s_lq = s_lt + 2 * PB;                                   // [2][PB]
  int* s_nt = reinterpret_cast<int*>(smem + L.off_nt);              // [TX]
  int2* s_kv = reinterpret_cast<int2*>(smem + L.off_kv);  // [VN*T][TX]
  int* s_ee = reinterpret_cast<int*>(smem + L.off_ee);    // [VN*T][TX]
  int* s_ep = reinterpret_cast<int*>(smem + L.off_ep);    // [VN*PP][TX]
  uint8_t* s_epi = smem + L.off_epi;                      // [VN*PP][TX]
  uint8_t* s_tc = smem + L.off_ncnt;                      // [TX][VN]
  uint8_t* s_pc = s_tc + L.nb;                            // [TX][VN]

  const int tid = threadIdx.y * TX + threadIdx.x;
  const int nbase = blockIdx.x * L.nb;
  const int chunks = (P + PB - 1) / PB;

  // four warps stage one chunk: tolerations of row tid, ports of row
  // tid - PB; each compacted, with its count
  auto stage = [&](int ch, int buf) {
    const int p0 = ch * PB;
    const int np = min(PB, P - p0);
    if (tid < np) {
      const long g = (long)(p0 + tid) * TL;
      int4* row = s_tol + (buf * PB + tid) * TL;
      int c = 0;
      for (int l0 = 0; l0 < TL; l0 += GROUP) {
        int4 x[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j) {
          const bool in = l0 + j < TL;
          x[j] = in ? make_int4(pk[g + l0 + j], pv[g + l0 + j],
                                po[g + l0 + j], pe[g + l0 + j])
                    : make_int4(0, 0, TOL_PAD, 0);
        }
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (x[j].z != TOL_PAD) row[c++] = x[j];
      }
      s_lt[buf * PB + tid] = c;
    } else if (tid >= PB && tid < PB + np) {
      const int r = tid - PB;
      const long g = (long)(p0 + r) * PQ;
      int* row = s_pp + (buf * PB + r) * PQ;
      int c = 0;
      for (int q0 = 0; q0 < PQ; q0 += GROUP) {
        int x[GROUP];
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          x[j] = q0 + j < PQ ? pports[g + q0 + j] : 0;
#pragma unroll
        for (int j = 0; j < GROUP; ++j)
          if (x[j] > 0) row[c++] = x[j];
      }
      s_lq[buf * PB + r] = c;
    }
  };

  // node pre-pass, first half: how many relevant taints and live ports
  // each node of the tile has
  for (int ln = tid; ln < L.nb; ln += THREADS) {
    const int n = nbase + ln;
    int c = 0, pc = 0;
    if (n < N) {
      for (int t = 0; t < T; ++t) {
        const int e = te[(long)n * T + t];
        c += e >= 0 && e < 32 && ((eff_mask >> e) & 1u);
      }
      for (int s = 0; s < PP; ++s) pc += nports[(long)n * PP + s] > 0;
    }
    s_tc[ln] = (uint8_t)c;
    s_pc[ln] = (uint8_t)pc;
  }
  int ch = blockIdx.y;
  if (ch < chunks) stage(ch, 0);
  __syncthreads();
  // second half: each node's entries at its place in its thread's list
  for (int ln = tid; ln < L.nb; ln += THREADS) {
    const int n = nbase + ln;
    if (n >= N) continue;
    const int lx = ln / VN, li = ln % VN;
    int c = 0, pc = 0;
    for (int i = 0; i < li; ++i) {
      c += s_tc[lx * VN + i];
      pc += s_pc[lx * VN + i];
    }
    for (int t = 0; t < T; ++t) {
      const long g = (long)n * T + t;
      const int e = te[g];
      if (e < 0 || e >= 32 || !((eff_mask >> e) & 1u)) continue;
      s_kv[c * TX + lx] = make_int2(tk[g], tv[g]);
      s_ee[c * TX + lx] = (int)((unsigned)e | (1u << (li + 16)));
      ++c;
    }
    for (int s = 0; s < PP; ++s) {
      const int port = nports[(long)n * PP + s];
      if (port <= 0) continue;  // a pad never equals a live pod port
      s_ep[pc * TX + lx] = port;
      s_epi[pc * TX + lx] = (uint8_t)li;
      ++pc;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x;
  const int n0 = nbase + tx * VN;
  const int nvalid = N - n0;  // <= 0: this thread stores nothing
  const uint4 tcnt = reinterpret_cast<const uint4*>(s_tc)[tx];
  const uint4 pcnt = reinterpret_cast<const uint4*>(s_pc)[tx];
  int n_taints = 0, n_ports = 0;
  unsigned tfree = 0;
#pragma unroll
  for (int i = 0; i < VN; ++i) {
    n_taints += byte_of(tcnt, i);
    n_ports += byte_of(pcnt, i);
    tfree |= (byte_of(tcnt, i) == 0 ? 1u : 0u) << i;
  }
  const uint4 t_free = spread16(tfree);
  // Entries of a column that repeat a (key, value, effect) are merged
  // into its first occurrence, whose node bits take theirs: nodes carry
  // the same taints far more often than not. The column's 256/TX threads
  // each take every (256/TX)-th entry and look for an earlier equal one;
  // then the column's first thread compacts what is left.
  if (n_taints <= MERGE_MAX) {
    for (int j = threadIdx.y; j < n_taints; j += blockDim.y) {
      const int2 k = s_kv[j * TX + tx];
      const int e = s_ee[j * TX + tx];
      for (int i = 0; i < j; ++i) {
        const int2 ki = s_kv[i * TX + tx];
        if (ki.x == k.x && ki.y == k.y &&
            ((s_ee[i * TX + tx] ^ e) & 0xffff) == 0) {
          atomicOr(&s_ee[i * TX + tx], e & ~0xffff);
          atomicAnd(&s_ee[j * TX + tx], 0xffff);
          break;
        }
      }
    }
  }
  __syncthreads();
  if (threadIdx.y == 0) {
    int d = 0;
    for (int j = 0; j < n_taints; ++j) {
      const int e = s_ee[j * TX + tx];
      if ((e & ~0xffff) == 0) continue;  // merged into an earlier entry
      s_kv[d * TX + tx] = s_kv[j * TX + tx];
      s_ee[d * TX + tx] = e;
      ++d;
    }
    s_nt[tx] = d;
  }
  __syncthreads();
  n_taints = s_nt[tx];
  const uint4 ones = make_uint4(0x01010101u, 0x01010101u, 0x01010101u,
                                0x01010101u);
  // this thread's column of each entry plane
  const int2* kv = s_kv + tx;
  const int* ee = s_ee + tx;
  const int* ep = s_ep + tx;
  const uint8_t* epi = s_epi + tx;

  for (int buf = 0; ch < chunks; ch += gridDim.y, buf ^= 1) {
    if (ch + (int)gridDim.y < chunks) stage(ch + gridDim.y, buf ^ 1);
    const int p0 = ch * PB;
    const int np = min(PB, P - p0);
    for (int r = threadIdx.y; r < np; r += blockDim.y) {
      const int lt = s_lt[buf * PB + r];
      const int lq = s_lq[buf * PB + r];
      uint4 tw = t_free, pw = ones;
      if (lt > 0) {
        const int4* tol = s_tol + (buf * PB + r) * TL;
        unsigned untol;
        switch (lt) {
          case 1: untol = untolerated<1>(tol, lt, kv, ee, n_taints, TX);
                  break;
          case 2: untol = untolerated<2>(tol, lt, kv, ee, n_taints, TX);
                  break;
          case 3: untol = untolerated<3>(tol, lt, kv, ee, n_taints, TX);
                  break;
          case 4: untol = untolerated<4>(tol, lt, kv, ee, n_taints, TX);
                  break;
          default: untol = untolerated<0>(tol, lt, kv, ee, n_taints, TX);
        }
        tw = spread16(~untol);
      }
      if (lq > 0) {
        const int* want = s_pp + (buf * PB + r) * PQ;
        unsigned clash;
        switch (lq) {
          case 1: clash = clashing<1>(want, lq, ep, epi, n_ports, TX);
                  break;
          case 2: clash = clashing<2>(want, lq, ep, epi, n_ports, TX);
                  break;
          case 3: clash = clashing<3>(want, lq, ep, epi, n_ports, TX);
                  break;
          case 4: clash = clashing<4>(want, lq, ep, epi, n_ports, TX);
                  break;
          default: clash = clashing<0>(want, lq, ep, epi, n_ports, TX);
        }
        pw = spread16(~clash);
      }
      if (nvalid > 0) {
        const long o = (long)(p0 + r) * N + n0;
        store_row(taints_out + o, tw, nvalid);
        store_row(ports_out + o, pw, nvalid);
      }
    }
    __syncthreads();
  }
}

// The launch: (tiles, walkers) blocks of (TX, 256/TX) threads. Node
// tiles across x; along y, as many pod-chunk walkers as fill the SMs at
// the kernel's occupancy, with the chunks spread evenly over them.
struct Plan {
  dim3 grid, block;
  int bytes, per_sm;
  cudaError_t err;
};

// Threads across nodes in a block: the widest whose shared memory fits
// in what an sm_90 block may opt into, or 0.
int block_width(int T, int PP, int TL, int PQ) {
  for (int tx : {32, 16})
    if (Layout(tx, T, PP, TL, PQ).bytes <= SHARED_OPT_IN) return tx;
  return 0;
}

Plan plan(int P, int N, int T, int TL, int PP, int PQ) {
  Plan pl{};
  const int tx = block_width(T, PP, TL, PQ);
  if (tx == 0) {
    pl.err = cudaErrorInvalidValue;
    return pl;
  }
  const Layout L(tx, T, PP, TL, PQ);
  pl.bytes = L.bytes;
  if (L.bytes > 48 * 1024) {
    pl.err = cudaFuncSetAttribute(taint_ports_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  L.bytes);
    if (pl.err != cudaSuccess) return pl;
  }
  int dev = 0, sms = 0;
  if ((pl.err = cudaGetDevice(&dev)) != cudaSuccess) return pl;
  pl.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (pl.err != cudaSuccess) return pl;
  pl.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &pl.per_sm, taint_ports_kernel, THREADS, L.bytes);
  if (pl.err != cudaSuccess) return pl;
  if (pl.per_sm < 1) {
    pl.err = cudaErrorInvalidConfiguration;
    return pl;
  }
  const int tiles = (N + L.nb - 1) / L.nb;
  const int chunks = (P + PB - 1) / PB;
  int walkers = (sms * pl.per_sm + tiles - 1) / tiles;
  walkers = walkers < 1 ? 1 : walkers > chunks ? chunks : walkers;
  const int per_walker = (chunks + walkers - 1) / walkers;
  walkers = (chunks + per_walker - 1) / per_walker;
  pl.grid = dim3(tiles, walkers);
  pl.block = dim3(tx, THREADS / tx);
  return pl;
}

}  // namespace

extern "C" {

// Threads across nodes in a block at these slot counts (32 or 16), or 0
// when no block shape fits in shared memory: ops/taint_ports.py checks it
// before a launch.
int ktt_block_width(int T, int PP, int TL, int PQ) {
  return block_width(T, PP, TL, PQ);
}

// The launch ktt_taint_ports makes at these sizes, for the record:
// out = {grid x, grid y, block x, block y, shared bytes, blocks per SM}.
int ktt_launch_plan(int P, int N, int T, int TL, int PP, int PQ, int* out) {
  const Plan pl = plan(P, N, T, TL, PP, PQ);
  const int v[6] = {(int)pl.grid.x, (int)pl.grid.y, (int)pl.block.x,
                    (int)pl.block.y, pl.bytes, pl.per_sm};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return (int)pl.err;
}

// taints_out / ports_out: uint8 [P, N] (a torch.bool tensor's storage).
// Node features are [N, T] / [N, PP], pod features [P, TL] / [P, PQ], all
// int32 and contiguous. Returns cudaGetLastError() after the launch (or
// the error of a set-up call before it).
int ktt_taint_ports(const int* tk, const int* tv, const int* te,
                    const int* nports, const int* pk, const int* pv,
                    const int* po, const int* pe, const int* pports,
                    uint8_t* taints_out, uint8_t* ports_out, int P, int N,
                    int T, int TL, int PP, int PQ, unsigned eff_mask,
                    cudaStream_t stream) {
  if (P <= 0 || N <= 0) return 0;
  const Plan pl = plan(P, N, T, TL, PP, PQ);
  if (pl.err != cudaSuccess) return (int)pl.err;
  taint_ports_kernel<<<pl.grid, pl.block, pl.bytes, stream>>>(
      tk, tv, te, nports, pk, pv, po, pe, pports, taints_out, ports_out, P, N,
      T, TL, PP, PQ, eff_mask);
  return (int)cudaGetLastError();
}

const char* ktt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
