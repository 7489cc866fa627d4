// The ICV injection's backward for Hopper (sm_90a): dh and the shift's
// gradient, reduced to the shift's own shape, in one launch.
//
// Replaces: licv_vqa_tpu/ops/icv_inject.py::_bwd (:113-133) with
// _reduce_to_shape (:136), which JAX leaves to XLA's fusion.  Per row of
// D, with s = h + v, r = |h| / |s| and gs = g.s:
//     ds = r * (g - s * gs / |s|^2),   dh = ds + (gs / |s|) * h / |h|,
// the three row sums (h.h, s.s, g.s) in f32 from one read of the row.  The
// shift's gradient is ds summed to the shift's shape: over every row for a
// (D,) shift, over a batch row's S rows for a (B, D) or (B, 1, D) one, not
// at all for a per-position (B, S, D) one.
//
// What bounds it on the H100: memory.  It reads h and g and writes dh (6
// bytes an element in bf16), reads the shift and writes its gradient, and
// does ~16 flops an element.  The design keeps every intermediate out of
// device memory but one f32 D-row a cluster:
//
// - A block of 256 threads takes a run of rows of one segment (the rows
//   one gradient row sums), RB rows at a time (2 in bf16, 1 in f32), each
//   thread 16-byte loads of its EPT columns of each row, all RB rows'
//   loads in flight together; the row sums by warp shuffles and one
//   shared-memory exchange; dh written at once; ds added into the
//   thread's f32 registers (per_pos: written at once in the shift's
//   dtype).
// - The blocks of a segment form thread-block clusters of up to 8.  Each
//   block sends its columns' sums to the block that owns that slice of D
//   (distributed shared memory); after a cluster barrier each block sums
//   its slice over the ranks in order and writes it as the cluster's f32
//   partial.  The last cluster of a segment to finish (an atomic ticket
//   after a fence) has each of its blocks sum its slice of the segment's
//   cluster partials in cluster order and write the gradient in the
//   shift's dtype, and resets the ticket, so the counters need no zeroing
//   launch.  No float atomics: the sums run in a fixed order and two calls
//   give equal bits.  One cluster a segment writes the gradient at once.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;

template <class T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N elements of T as raw 32-bit words (N * sizeof(T) bytes: 8, 16 or 32)
template <class T, int N>
struct Raw {
  static constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];

  // the N elements at p, aligned to their size (up to 16 bytes)
  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kWords == 2) {
      const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = r.x;
      w[1] = r.y;
    } else {
#pragma unroll
      for (int c = 0; c < kWords / 4; ++c) {
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + c);
        w[4 * c] = r.x;
        w[4 * c + 1] = r.y;
        w[4 * c + 2] = r.z;
        w[4 * c + 3] = r.w;
      }
    }
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
  }

  // element i, widened to f32
  __device__ __forceinline__ float operator[](int i) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[i]);
    } else {
      return __uint_as_float(i & 1 ? w[i / 2] & 0xFFFF0000u : w[i / 2] << 16);
    }
  }
};

// v's N values rounded to T and stored at p (aligned to their size)
template <class T, int N>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[N]) {
  constexpr int kWords = N * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
  T* e = reinterpret_cast<T*>(w);
#pragma unroll
  for (int i = 0; i < N; ++i) e[i] = from_f32<T>(v[i]);
  if constexpr (kWords == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int c = 0; c < kWords / 4; ++c) {
      reinterpret_cast<uint4*>(p)[c] = make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2],
                                                  w[4 * c + 3]);
    }
  }
}

struct Params {
  const void* h;       // (rows, D), T
  const void* v;       // the shift, read at b * v_sb + pos * v_ss (elements), V
  const void* g;       // (rows, D), T
  void* dh;            // (rows, D), T
  void* ds;            // the gradient: (segments, D), or (rows, D) per position, V
  float* part;         // (clusters, D) f32: each cluster's partial
  int* tickets;        // one a segment, zero between calls
  int S, D;
  long long v_sb, v_ss;
  int seg_rows, rows_per_block, blocks_per_seg;
  int reduce;          // 0: per-position gradient, written row by row
};

// T: h, g and dh; V: the shift and its gradient; EPT: a thread's columns
// (D <= 256 * EPT), in 16-byte chunks of VEC elements of T
// two blocks an SM (registers capped to fit): about 96 KB of rows in
// flight an SM
template <class T, class V, int EPT>
__global__ void __launch_bounds__(kThreads, 2)
icv_inject_bwd_kernel(const Params p) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CH = EPT / VEC;  // a thread's chunks
  constexpr int RB = 4 / sizeof(T);  // rows a step
  __shared__ float red[2][kWarps][3 * RB];
  extern __shared__ float recv[];  // [cluster][D / cluster]: the slices sent here
  __shared__ int last_flag;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int seg = blockIdx.x / p.blocks_per_seg;
  const int blk = blockIdx.x % p.blocks_per_seg;
  const long long seg0 = static_cast<long long>(seg) * p.seg_rows;
  const long long start = seg0 + static_cast<long long>(blk) * p.rows_per_block;
  const long long end = min(start + p.rows_per_block, seg0 + p.seg_rows);

  // every block of the cluster has started before any writes into another
  // (the wait is just before the first such write)
  if (p.reduce) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const T* h = static_cast<const T*>(p.h);
  const T* g = static_cast<const T*>(p.g);
  const V* v = static_cast<const V*>(p.v);
  T* dh = static_cast<T*>(p.dh);

  // the thread's chunk c covers columns (c * 256 + tid) * VEC ..
  float acc[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) acc[e] = 0.f;

  int parity = 0;
  for (long long r0 = start; r0 < end; r0 += RB, parity ^= 1) {
    // the step's rows, raw: all their loads in flight before any is used
    Raw<T, VEC> hr[RB][CH], gr[RB][CH];
    Raw<V, VEC> vr[RB][CH];
    float sums[3 * RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const long long row = r0 + r;
      const long long b = row / p.S, pos = row % p.S;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = (c * kThreads + tid) * VEC;
        if (row < end && col < p.D) {
          hr[r][c].load(h + row * p.D + col);
          gr[r][c].load(g + row * p.D + col);
          vr[r][c].load(v + b * p.v_sb + pos * p.v_ss + col);
        } else {
          hr[r][c].zero();
          gr[r][c].zero();
          vr[r][c].zero();
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      float hh = 0.f, ss = 0.f, gs = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float hv = hr[r][c][i], sv = hv + vr[r][c][i];
          hh = fmaf(hv, hv, hh);
          ss = fmaf(sv, sv, ss);
          gs = fmaf(gr[r][c][i], sv, gs);
        }
      sums[3 * r] = hh;
      sums[3 * r + 1] = ss;
      sums[3 * r + 2] = gs;
    }
    // the row sums over the block: the warp's by shuffles, then the
    // warps' in order through shared memory (double-buffered by step)
#pragma unroll
    for (int i = 0; i < 3 * RB; ++i) {
#pragma unroll
      for (int o = 16; o > 0; o /= 2) sums[i] += __shfl_xor_sync(0xffffffffu, sums[i], o);
    }
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < 3 * RB; ++i) red[parity][warp][i] = sums[i];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const long long row = r0 + r;
      if (row >= end) break;
      float hh = 0.f, ss = 0.f, gs = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        hh += red[parity][w][3 * r];
        ss += red[parity][w][3 * r + 1];
        gs += red[parity][w][3 * r + 2];
      }
      const float n_h = sqrtf(hh), n_s = sqrtf(ss);
      const float ratio = n_h / n_s, k_s = gs / ss, k_h = gs / n_s;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int col = (c * kThreads + tid) * VEC;
        if (col >= p.D) continue;
        float d_s[VEC], d_h[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float hv = hr[r][c][i], sv = hv + vr[r][c][i];
          d_s[i] = ratio * (gr[r][c][i] - sv * k_s);
          d_h[i] = d_s[i] + k_h * (hv / n_h);
          acc[c * VEC + i] += d_s[i];
        }
        store_vec<T, VEC>(dh + row * p.D + col, d_h);
        if (!p.reduce) store_vec<V, VEC>(static_cast<V*>(p.ds) + row * p.D + col, d_s);
      }
    }
  }
  if (!p.reduce) return;

  // the cluster's sum of its blocks' columns: slice q of D (width W, whole
  // chunks) is summed by rank q
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int W = (p.D / VEC + cl - 1) / cl * VEC;
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int col = (c * kThreads + tid) * VEC;
    if (col >= p.D) continue;
    const int owner = col / W;
    float* slot = cluster.map_shared_rank(recv, owner) + rank * W + (col - owner * W);
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      *reinterpret_cast<float4*>(slot + i) =
          make_float4(acc[c * VEC + i], acc[c * VEC + i + 1], acc[c * VEC + i + 2],
                      acc[c * VEC + i + 3]);
    }
  }
  cluster.sync();
  const int clusters = p.blocks_per_seg / cl;
  const int cluster_id = blockIdx.x / cl;  // the segment's clusters are consecutive
  const int c_lo = rank * W, c_hi = min(p.D, c_lo + W);
  V* const out = static_cast<V*>(p.ds) + static_cast<long long>(seg) * p.D;
  if (clusters == 1) {
    for (int col = c_lo + tid; col < c_hi; col += kThreads) {
      float s = 0.f;
      for (int q = 0; q < cl; ++q) s += recv[q * W + col - c_lo];  // in rank order
      out[col] = from_f32<V>(s);
    }
    return;
  }
  float* const mine = p.part + static_cast<long long>(cluster_id) * p.D;
  for (int col = c_lo + tid; col < c_hi; col += kThreads) {
    float s = 0.f;
    for (int q = 0; q < cl; ++q) s += recv[q * W + col - c_lo];  // in rank order
    mine[col] = s;
  }
  cluster.sync();  // the cluster's partial written (release, cluster scope)
  if (rank == 0 && tid == 0) {
    __threadfence();  // ... and visible to the device before the ticket
    const int last = atomicAdd(p.tickets + seg, 1) == clusters - 1;
    if (last) atomicExch(p.tickets + seg, 0);  // the last: ready for the next call
    for (int q = 0; q < cl; ++q) *cluster.map_shared_rank(&last_flag, q) = last;
  }
  cluster.sync();
  if (!last_flag) return;
  // the last cluster: each block its slice over the segment's clusters, in
  // order.  Thread (u, half) loads quad u's columns of half the partials,
  // all loads in flight together; the halves are added in order.
  const float* const first = p.part + static_cast<long long>(seg) * clusters * p.D;
  const int quads = (c_hi - c_lo) / 4;  // whole: D and W are multiples of 4
  const int u0 = tid % (kThreads / 2), half = tid / (kThreads / 2);
  const int per_half = (clusters + 1) / 2;
  __shared__ float4 upper[kThreads / 2];
  for (int ub = 0; ub < quads; ub += kThreads / 2) {
    const int u = ub + u0;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (u < quads) {
      const float* const col = first + c_lo + 4 * u;
      const int q_end = min(clusters, (half + 1) * per_half);
#pragma unroll 16
      for (int q = half * per_half; q < q_end; ++q) {
        const float4 part = __ldcg(reinterpret_cast<const float4*>(col + static_cast<long long>(q) * p.D));
        sum.x += part.x;
        sum.y += part.y;
        sum.z += part.z;
        sum.w += part.w;
      }
    }
    if (half == 1) upper[u0] = sum;
    __syncthreads();
    if (half == 0 && u < quads) {
      const float4 hi = upper[u0];
      const float v4[4] = {sum.x + hi.x, sum.y + hi.y, sum.z + hi.z, sum.w + hi.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) out[c_lo + 4 * u + i] = from_f32<V>(v4[i]);
    }
    __syncthreads();
  }
}

template <class T, class V, int EPT>
int launch(const Params& p, int blocks, int cluster, cudaStream_t stream) {
  auto kernel = icv_inject_bwd_kernel<T, V, EPT>;
  constexpr int VEC = 16 / sizeof(T);
  const int W = (p.D / VEC + cluster - 1) / cluster * VEC;
  const int smem = p.reduce ? cluster * W * 4 : 0;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <class T, class V>
int launch_d(const Params& p, int blocks, int cluster, cudaStream_t stream) {
  if (p.D <= kThreads * 8) return launch<T, V, 8>(p, blocks, cluster, stream);
  return launch<T, V, 16>(p, blocks, cluster, stream);
}

}  // namespace

// The clusters of `cluster` blocks the card runs at once for D, h's and the
// shift's types (cudaOccupancyMaxActiveClusters), or a negative
// cudaError_t: the plan sizes its grid to one wave of them.
extern "C" int icv_inject_bwd_max_clusters(int D, int cluster, int h_f32, int v_f32) {
  const int vec = h_f32 ? 4 : 8;
  const int W = (D / vec + cluster - 1) / cluster * vec;
  const int smem = cluster * W * 4;
  auto query = [&](auto kernel) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
        cudaSuccess) {
      return -static_cast<int>(cudaGetLastError());
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attrs[1];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    return err == cudaSuccess ? n : -static_cast<int>(err);
  };
  auto pick = [&](auto t, auto v) {
    using T = decltype(t);
    using V = decltype(v);
    return D <= kThreads * 8 ? query(icv_inject_bwd_kernel<T, V, 8>)
                             : query(icv_inject_bwd_kernel<T, V, 16>);
  };
  if (h_f32) return v_f32 ? pick(float{}, float{}) : pick(float{}, __nv_bfloat16{});
  return v_f32 ? pick(__nv_bfloat16{}, float{}) : pick(__nv_bfloat16{}, __nv_bfloat16{});
}

// Plain C entry point (loaded with ctypes).  h_f32 / v_f32 pick f32 over
// bf16 for h, g, dh and for the shift and its gradient.  The grid is
// `segments * blocks_per_seg` blocks in clusters of `cluster` (which
// divides blocks_per_seg; 1 without a reduction); block j of a segment
// takes its rows from j * rows_per_block.  `part` holds a D-row of f32 for
// each cluster, `tickets` one zeroed int a segment (left zero).  Launches
// on `stream`, does not synchronise, allocates nothing, and returns a
// cudaError_t; operands it does not take (D not a multiple of 16 bytes of
// h's type or above 4096, every model's width, unaligned pointers) return
// cudaErrorInvalidValue without launching.
extern "C" int icv_inject_bwd(const void* h, const void* v, const void* g, void* dh, void* ds,
                              void* part, void* tickets, int S, int D, long long v_sb,
                              long long v_ss, int segments, int seg_rows, int rows_per_block,
                              int blocks_per_seg, int cluster, int reduce, int h_f32, int v_f32,
                              void* stream) {
  // a thread's chunk: 16 bytes of h's type, and as many elements of the shift
  const int vec = h_f32 ? 4 : 8;
  const long long v_bytes = v_f32 ? 4 : 2;
  const long long v_align = vec * v_bytes < 16 ? vec * v_bytes : 16;
  const uintptr_t hgd = reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(g) |
                        reinterpret_cast<uintptr_t>(dh);
  const uintptr_t vd = reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(ds);
  if (D < 1 || D % vec || D > kThreads * 16 || hgd % 16 || vd % v_align ||
      (v_sb * v_bytes) % v_align || (v_ss * v_bytes) % v_align || cluster < 1 ||
      cluster > kMaxCluster || blocks_per_seg % cluster || segments < 1 ||
      (!reduce && cluster != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Params p{h, v, g, dh, ds, static_cast<float*>(part), static_cast<int*>(tickets), S, D,
                 v_sb, v_ss, seg_rows, rows_per_block, blocks_per_seg, reduce};
  const int blocks = segments * blocks_per_seg;
  const cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (h_f32) {
    return v_f32 ? launch_d<float, float>(p, blocks, cluster, cs)
                 : launch_d<float, __nv_bfloat16>(p, blocks, cluster, cs);
  }
  return v_f32 ? launch_d<__nv_bfloat16, float>(p, blocks, cluster, cs)
               : launch_d<__nv_bfloat16, __nv_bfloat16>(p, blocks, cluster, cs);
}
