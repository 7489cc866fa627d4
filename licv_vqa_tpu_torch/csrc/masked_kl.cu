// The masked temperature-KL's per-row forward and backward for Hopper
// (sm_90a).
//
// Replaces: licv_vqa_tpu/ops/masked_kl_kernel.py::masked_kl_pallas (:128),
// its pallas_calls _kl_fwd_kernel (:43, launched at :83) and _kl_bwd_kernel
// (:50, launched at :104).  Per row of V f32 logits s (student) and t
// (teacher), with p = softmax(s), q = softmax(t):
//     KL = sum_j q_j (log(q_j + eps) - log(p_j + eps)),
//     dKL/ds_i = p_i C - q_i p_i / (p_i + eps),   C = sum_j q_j p_j / (p_j + eps),
//     dKL/dt_j = q_j (A_j - sum_i q_i A_i),
//     A_i = log(q_i + eps) - log(p_i + eps) + q_i / (q_i + eps),
// the backward's rows scaled by their cotangent g.  A row of weight w = 0
// (outside the answer mask) adds nothing to the masked mean and gets a zero
// cotangent, so neither kernel reads it: the forward writes its KL and
// log-sum-exps as 0, the backward writes zero gradients.
//
// What bounds it on the H100: memory.  The forward reads both operands of
// each weighted row once (8 bytes an element); the backward reads them and
// writes both gradients (16 bytes an element; 8 for a zero-weight row).
// The design keeps each row on chip between the passes that need it:
//
// - A row is split over a thread-block cluster of k blocks (k from the
//   card's occupancy, at most 8), each block a slice of W columns (a
//   multiple of 4).  The grid is persistent: as many clusters as the card
//   runs at once, each taking every C-th weighted row (C clusters) and
//   every C-th zero-weight one, so the rows of the answer mask spread over
//   the card however they lie.
// - A block copies its slice of both operands of a row from device memory
//   into shared memory once, by cp.async, in chunks of kChunk columns, one
//   16-byte quad of each operand a thread a chunk (at the slice's ends,
//   where a row is not 16-byte aligned, 4-byte copies: at V = 32002 a row
//   starts on an 8-byte boundary only); shared index i holds column
//   c0 + i - m, m being the row's misalignment in columns, so that the
//   16-byte copies land 16-byte aligned.  Each thread works on the chunk
//   it copied as soon as its own copies land.  (A second buffer, with the
//   next row's copies in flight while this one is worked on, halved the
//   clusters the card runs at once and was slower.)
// - Forward: each thread keeps a running (max, sum exp) of both operands
//   over its quads (one exp an element an operand, one a chunk to
//   rescale), storing exp(x - its running max) in place; the block merges
//   the threads' pairs, the blocks send their pairs to every block of the
//   cluster through distributed shared memory, and each block merges the
//   k pairs in rank order into the row's log-sum-exps (every block the
//   same bits).  Each block then sums q (log(q + eps) - log(p + eps)) over
//   its slice, p and q being the stored exps times exp(max - lse), and
//   rank 0 sums the k partials in rank order and writes the KL and both
//   log-sum-exps.
// - Backward: from the forward's log-sum-exps, each thread turns its
//   quads into p and q in place as they land (one exp each) and stores A
//   beside them (two logs, one division), summing q p / (p + eps) and q A;
//   the cluster sums the k pairs in rank order, and each block then writes
//   its slice of both gradients from shared memory, a 16-byte store a
//   quad.  The zero-weight rows' slices are written as zeros after the
//   weighted rows.
// No atomics: every sum runs in a fixed order, and two calls give equal
// bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kChunk = 4 * kThreads;  // shared indices a chunk: a quad a thread
constexpr int kMaxChunks = 16;        // W + 3 <= kMaxChunks * kChunk
constexpr int kMaxRows = 256;         // rows of each kind a cluster takes

struct Params {
  const float* s;    // (N, V) student rows, pitch V
  const float* t;    // (N, V) teacher rows, pitch V
  const float* w;    // (N,) row weights: 0 = not read
  float* kl;         // (N,) forward: the row's KL
  float* lse_s;      // (N,) forward writes, backward reads
  float* lse_t;
  const float* g;    // (N,) backward: the row's cotangent
  float* ds;         // (N, V) backward: the gradients
  float* dt;
  int n, V;
  int W;             // a block's slice of columns (a multiple of 4)
  int clusters;      // the grid's clusters
  float eps;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// wait until at most `pending` of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void wait_pending(int pending) {
  if constexpr (N > 0) {
    if (pending >= N) {
      asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
      return;
    }
    wait_pending<N - 1>(pending);
  } else {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
  }
}

// The block's slice of one row: columns [c0, c0 + len), held at shared
// indices [lo, hi) = [m, m + len); thread t's quad of chunk j is at shared
// index j * kChunk + 4t.
struct Slice {
  long long row0;  // the row's first element
  int c0, lo, hi;

  __device__ Slice(const Params& p, long long row, int rank) {
    row0 = row * p.V;
    c0 = rank * p.W;
    lo = static_cast<int>(row0 % 4);
    hi = lo + max(0, min(p.V - c0, p.W));
  }

  __device__ __forceinline__ int quad(int j) const { return j * kChunk + 4 * threadIdx.x; }

  // the element of `rows` (pitch V) at shared index 0
  __device__ __forceinline__ const float* at0(const float* rows) const {
    return rows + row0 + c0 - lo;
  }
  __device__ __forceinline__ float* at0(float* rows) const { return rows + row0 + c0 - lo; }

  // copy this thread's quad of chunk j of `rows` into `dst`
  __device__ __forceinline__ void load(float* dst, const float* rows, int j) const {
    const float* g = at0(rows);
    const int i = quad(j);
    if (i >= lo && i + 4 <= hi) {
      cp_async16(dst + i, g + i);  // index and address both 16-byte aligned
    } else {
      for (int e = max(i, lo); e < min(i + 4, hi); ++e) cp_async4(dst + e, g + e);
    }
  }

  // every chunk of the row's slices of both operands into `xs` and `xt`, a
  // copy group a chunk
  template <int NCH>
  __device__ __forceinline__ void load_all(float* xs, float* xt, const Params& p) const {
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      load(xs, p.s, j);
      load(xt, p.t, j);
      asm volatile("cp.async.commit_group;" ::: "memory");
    }
  }

  __device__ __forceinline__ bool in(int i) const { return i >= lo && i < hi; }

  // the quad at shared index i (a multiple of 4) of `x`: v[e] = x[i + e],
  // `fill` outside the slice; one 16-byte access where the quad lies in it
  __device__ __forceinline__ void get(const float* x, int i, float fill, float (&v)[4]) const {
    if (i >= lo && i + 4 <= hi) {
      const float4 q = *reinterpret_cast<const float4*>(x + i);
      v[0] = q.x;
      v[1] = q.y;
      v[2] = q.z;
      v[3] = q.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = in(i + e) ? x[i + e] : fill;
    }
  }

  // v into the quad at index i of `x` (shared memory, or a row through
  // at0), the elements in the slice only
  __device__ __forceinline__ void put(float* x, int i, const float (&v)[4]) const {
    if (i >= lo && i + 4 <= hi) {
      *reinterpret_cast<float4*>(x + i) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (in(i + e)) x[i + e] = v[e];
      }
    }
  }
};

// N values reduced over the block: each warp by shuffles, then the warps'
// in order (the same order every call).  `red` holds kWarps * N floats;
// every thread gets the result.
template <int N, class Op>
__device__ __forceinline__ void block_reduce(float (&v)[N], float* red, Op op) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o /= 2) v[k] = op(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  }
  __syncthreads();  // red is free (an earlier reduction has been read)
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    v[k] = red[k];
    for (int q = 1; q < kWarps; ++q) v[k] = op(v[k], red[q * N + k]);
  }
}

struct Sum {
  __device__ float operator()(float a, float b) const { return a + b; }
};

// exp(a - b), 0 where a is -inf (a max over no element); ex2.approx, within
// a few ulps of expf at the arguments here (|a - b| of tens)
__device__ __forceinline__ float exp_diff(float a, float b) {
  return a == -INFINITY ? 0.f : __expf(a - b);
}

// the (max, sum exp) pair (m, l) merged with (m2, l2): the same bits
// whichever of the two comes first
__device__ __forceinline__ void merge_pair(float& m, float& l, float m2, float l2) {
  const float top = fmaxf(m, m2);
  l = l * exp_diff(m, top) + l2 * exp_diff(m2, top);
  m = top;
}

// N (max, sum exp) pairs merged over the block: each warp by shuffles,
// then the warps' in order.  `red` holds kWarps * 2N floats; every thread
// gets the result.
template <int N>
__device__ __forceinline__ void block_merge_pairs(float (&m)[N], float (&l)[N], float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o /= 2) {
      merge_pair(m[k], l[k], __shfl_xor_sync(0xffffffffu, m[k], o),
                 __shfl_xor_sync(0xffffffffu, l[k], o));
    }
  }
  __syncthreads();  // red is free (an earlier reduction has been read)
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      red[(warp * N + k) * 2] = m[k];
      red[(warp * N + k) * 2 + 1] = l[k];
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    m[k] = red[2 * k];
    l[k] = red[2 * k + 1];
    for (int q = 1; q < kWarps; ++q) {
      merge_pair(m[k], l[k], red[(q * N + k) * 2], red[(q * N + k) * 2 + 1]);
    }
  }
}

// the cluster barrier's two halves: arrive.relaxed early (the cluster's
// blocks have started before any writes into another's shared memory),
// wait just before the first such write
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// The rows cluster c takes: the weighted rows whose rank among the
// weighted rows is c modulo the grid's clusters, into `rw`, and likewise
// the zero-weight rows into `rz`, each in row order.  Returns their counts.
__device__ int2 cluster_rows(const Params& p, int c, int* rw, int* rz) {
  __shared__ int counts[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned below = (1u << lane) - 1u;
  int base_w = 0, base_z = 0;
  for (int r0 = 0; r0 < p.n; r0 += kThreads) {
    const int r = r0 + threadIdx.x;
    const bool weighted = r < p.n && p.w[r] != 0.f;
    const bool zero = r < p.n && !weighted;
    const unsigned bw = __ballot_sync(0xffffffffu, weighted);
    const unsigned bz = __ballot_sync(0xffffffffu, zero);
    if (lane == 0) {
      counts[0][warp] = __popc(bw);
      counts[1][warp] = __popc(bz);
    }
    __syncthreads();
    int off_w = base_w, off_z = base_z;
    for (int q = 0; q < kWarps; ++q) {
      if (q < warp) {
        off_w += counts[0][q];
        off_z += counts[1][q];
      }
      base_w += counts[0][q];
      base_z += counts[1][q];
    }
    __syncthreads();  // the counts are read before the next tile's
    const int m = weighted ? off_w + __popc(bw & below) : off_z + __popc(bz & below);
    if ((weighted || zero) && m % p.clusters == c) (weighted ? rw : rz)[m / p.clusters] = r;
  }
  __syncthreads();  // the lists written
  const auto mine = [&](int total) { return total > c ? (total - c - 1) / p.clusters + 1 : 0; };
  return make_int2(mine(base_w), mine(base_z));
}

// NCH: the chunks a slice spans (W + 3 <= NCH * kChunk)
template <int NCH>
__global__ void __launch_bounds__(kThreads)
masked_kl_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];  // [s, t][W + 4]
  __shared__ float red[kWarps * 4];
  __shared__ float4 pairs[2][kMaxCluster];  // a row's (max_s, sum_s, max_t, sum_t) by rank
  __shared__ float parts[2][kMaxCluster];   // rank 0: a row's KL partials by rank
  __shared__ int rows_w[kMaxRows], rows_z[kMaxRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();
  const int2 mine = cluster_rows(p, blockIdx.x / k, rows_w, rows_z);
  if (rank == 0) {  // zero-weight rows: KL and log-sum-exps 0
    for (int i = threadIdx.x; i < mine.y; i += kThreads) {
      p.kl[rows_z[i]] = p.lse_s[rows_z[i]] = p.lse_t[rows_z[i]] = 0.f;
    }
  }
  float* const xs = smem;
  float* const xt = smem + p.W + 4;
  cluster_wait();

  // rank 0 writes a row's KL once its partials are in, at the next row's
  // first cluster barrier (the last row's at one after the loop)
  long long done_row = -1;
  float done_lse[2];
  const auto write_done = [&](int i) {
    if (rank == 0 && threadIdx.x == 0 && done_row >= 0) {
      float kl = 0.f;
      for (int q = 0; q < k; ++q) kl += parts[i & 1][q];  // in rank order
      p.kl[done_row] = kl;
      p.lse_s[done_row] = done_lse[0];
      p.lse_t[done_row] = done_lse[1];
    }
  };
  for (int i = 0; i < mine.x; ++i) {
    const long long row = rows_w[i];
    const Slice sl(p, row, rank);
    sl.load_all<NCH>(xs, xt, p);

    // the thread's running (max, sum exp) of each operand; its running max
    // after chunk j, which its stored exps of chunk j are relative to
    float run[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f};
    float chunk_max[2][NCH];
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      wait_pending<NCH>(NCH - 1 - j);  // this thread's copies of chunk j landed
      const int at = sl.quad(j);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        float* const x = o ? xt : xs;
        float v[4];
        sl.get(x, at, -INFINITY, v);  // outside the slice: exp 0
        const float m = fmaxf(fmaxf(run[o], fmaxf(v[0], v[1])), fmaxf(v[2], v[3]));
        float s = sum[o] * exp_diff(run[o], m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = exp_diff(v[e], m);
          s += v[e];
        }
        sl.put(x, at, v);
        sum[o] = s;
        run[o] = chunk_max[o][j] = m;
      }
    }
    // the block's pairs from its threads'
    block_merge_pairs(run, sum, red);

    // every rank's pair into every rank's shared memory, then each merges
    // them in rank order
    float4* const row_pairs = pairs[i & 1];
    if (threadIdx.x < k) {
      *cluster.map_shared_rank(row_pairs + rank, static_cast<int>(threadIdx.x)) =
          make_float4(run[0], sum[0], run[1], sum[1]);
    }
    cluster.sync();
    write_done(i - 1);  // the previous row's partials arrived before this barrier
    float m_s = -INFINITY, m_t = -INFINITY;
    for (int q = 0; q < k; ++q) {
      m_s = fmaxf(m_s, row_pairs[q].x);
      m_t = fmaxf(m_t, row_pairs[q].z);
    }
    float l_s = 0.f, l_t = 0.f;
    for (int q = 0; q < k; ++q) {
      l_s += row_pairs[q].y * expf(row_pairs[q].x - m_s);
      l_t += row_pairs[q].w * expf(row_pairs[q].z - m_t);
    }
    const float lse_s = m_s + logf(l_s), lse_t = m_t + logf(l_t);

    // p and q are the stored exps times exp(their running max - lse)
    float acc[1] = {0.f};
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int at = sl.quad(j);
      const float scale_s = exp_diff(chunk_max[0][j], lse_s);
      const float scale_t = exp_diff(chunk_max[1][j], lse_t);
      float es[4], et[4];
      sl.get(xs, at, 0.f, es);
      sl.get(xt, at, 0.f, et);  // outside the slice: q = 0 adds 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = es[e] * scale_s, qv = et[e] * scale_t;
        acc[0] += qv * (__logf(qv + p.eps) - __logf(pv + p.eps));
      }
    }
    block_reduce(acc, red, Sum());
    if (threadIdx.x == 0) *cluster.map_shared_rank(parts[i & 1] + rank, 0) = acc[0];
    done_row = row;
    done_lse[0] = lse_s;
    done_lse[1] = lse_t;
  }
  if (mine.x > 0) {
    cluster.sync();
    write_done(mine.x - 1);
  }
}

template <int NCH>
__global__ void __launch_bounds__(kThreads)
masked_kl_bwd_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];  // [s then p, t then q, A][W + 4]
  __shared__ float red[kWarps * 2];
  __shared__ float2 pairs[2][kMaxCluster];  // a row's (sum q p/(p+eps), sum q A) by rank
  __shared__ int rows_w[kMaxRows], rows_z[kMaxRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();
  const int2 mine = cluster_rows(p, blockIdx.x / k, rows_w, rows_z);
  float* const xs = smem;
  float* const xt = smem + p.W + 4;
  float* const xa = smem + 2 * (p.W + 4);
  cluster_wait();

  const float eps = p.eps;
  for (int i = 0; i < mine.x; ++i) {
    const long long row = rows_w[i];
    const Slice sl(p, row, rank);
    sl.load_all<NCH>(xs, xt, p);
    const float lse_s = p.lse_s[row], lse_t = p.lse_t[row], g = p.g[row];
    float acc[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      wait_pending<NCH>(NCH - 1 - j);  // this thread's copies of chunk j landed
      const int at = sl.quad(j);
      float pv[4], qv[4], a[4];
      sl.get(xs, at, -INFINITY, pv);
      sl.get(xt, at, -INFINITY, qv);  // outside the slice: p = q = 0 add 0
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = __expf(pv[e] - lse_s);
        qv[e] = __expf(qv[e] - lse_t);
        a[e] = __logf(qv[e] + eps) - __logf(pv[e] + eps) + __fdividef(qv[e], qv[e] + eps);
        acc[0] += qv[e] * __fdividef(pv[e], pv[e] + eps);
        acc[1] += qv[e] * a[e];
      }
      sl.put(xs, at, pv);
      sl.put(xt, at, qv);
      sl.put(xa, at, a);
    }
    block_reduce(acc, red, Sum());
    float2* const row_pairs = pairs[i & 1];
    if (threadIdx.x < k) {
      *cluster.map_shared_rank(row_pairs + rank, static_cast<int>(threadIdx.x)) =
          make_float2(acc[0], acc[1]);
    }
    cluster.sync();
    float c_sum = 0.f, ea = 0.f;
    for (int q = 0; q < k; ++q) {  // in rank order
      c_sum += row_pairs[q].x;
      ea += row_pairs[q].y;
    }
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int at = sl.quad(j);
      float pv[4], qv[4], a[4], d_s[4], d_t[4];
      sl.get(xs, at, 0.f, pv);  // outside the slice: not stored
      sl.get(xt, at, 0.f, qv);
      sl.get(xa, at, 0.f, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        d_s[e] = g * (pv[e] * c_sum - qv[e] * __fdividef(pv[e], pv[e] + eps));
        d_t[e] = g * (qv[e] * (a[e] - ea));
      }
      sl.put(sl.at0(p.ds), at, d_s);
      sl.put(sl.at0(p.dt), at, d_t);
    }
  }
  // zero-weight rows, after the weighted ones (their stores drain as the
  // kernel ends): zero gradients, the rows unread
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < mine.y; ++i) {
    const Slice sl(p, rows_z[i], rank);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      sl.put(sl.at0(p.ds), sl.quad(j), zero);
      sl.put(sl.at0(p.dt), sl.quad(j), zero);
    }
  }
}

using Kernel = void (*)(Params);

// the kernel whose NCH is the fewest chunks of a W-column slice, or null
Kernel kernel_for(int backward, int W) {
  const int need = (W + 3 + kChunk - 1) / kChunk;
  if (need <= 1) return backward ? masked_kl_bwd_kernel<1> : masked_kl_fwd_kernel<1>;
  if (need <= 2) return backward ? masked_kl_bwd_kernel<2> : masked_kl_fwd_kernel<2>;
  if (need <= 4) return backward ? masked_kl_bwd_kernel<4> : masked_kl_fwd_kernel<4>;
  if (need <= 8) return backward ? masked_kl_bwd_kernel<8> : masked_kl_fwd_kernel<8>;
  if (need <= kMaxChunks) return backward ? masked_kl_bwd_kernel<16> : masked_kl_fwd_kernel<16>;
  return nullptr;
}

// both operands' slices, and the backward's A
int smem_bytes(int W, int backward) { return (backward ? 3 : 2) * (W + 4) * 4; }

cudaLaunchConfig_t config(int blocks, int cluster, int smem, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The clusters of `cluster` blocks, each a slice of W columns, that the card
// runs at once for the forward (backward = 0) or the backward
// (cudaOccupancyMaxActiveClusters), or a negative cudaError_t: the wrapper
// picks the cluster size from them.
extern "C" int masked_kl_max_clusters(int W, int cluster, int backward) {
  const Kernel kernel = kernel_for(backward, W);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(W, backward);
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem) !=
      cudaSuccess) {
    return -static_cast<int>(cudaGetLastError());
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(cluster, cluster, smem, nullptr, &attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// Plain C entry points (loaded with ctypes).  N rows of V f32 columns,
// contiguous, 16-byte aligned; w, lse_s, lse_t, kl and g (N,) f32.  The grid
// is `clusters` clusters of `cluster` blocks (at most what the card runs at
// once: the grid is persistent), block r of a cluster the columns
// [r * W, (r + 1) * W) of its rows (W a multiple of 4, cluster * W >= V),
// each cluster at most kMaxRows rows of each weight kind.  Each launches on
// `stream`, does not synchronise, allocates nothing and returns a
// cudaError_t; operands it does not take return cudaErrorInvalidValue
// without launching.
namespace {

int launch(bool backward, const Params& p, int cluster, void* stream) {
  const uintptr_t rows = reinterpret_cast<uintptr_t>(p.s) | reinterpret_cast<uintptr_t>(p.t) |
                         reinterpret_cast<uintptr_t>(p.ds) | reinterpret_cast<uintptr_t>(p.dt);
  const Kernel kernel = kernel_for(backward, p.W);
  if (p.n < 1 || p.V < 1 || p.W < 4 || p.W % 4 || cluster < 1 || cluster > kMaxCluster ||
      static_cast<long long>(cluster) * p.W < p.V ||
      static_cast<long long>(cluster - 1) * p.W >= p.V || rows % 16 || kernel == nullptr ||
      p.clusters < 1 || (p.n + p.clusters - 1) / p.clusters > kMaxRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = smem_bytes(p.W, backward);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      config(p.clusters * cluster, cluster, smem, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int masked_kl_fwd(const float* s, const float* t, const float* w, float* kl,
                             float* lse_s, float* lse_t, int n, int V, int W, int cluster,
                             int clusters, float eps, void* stream) {
  const Params p{s, t, w, kl, lse_s, lse_t, nullptr, nullptr, nullptr, n, V, W, clusters, eps};
  return launch(false, p, cluster, stream);
}

extern "C" int masked_kl_bwd(const float* s, const float* t, const float* w,
                             const float* lse_s, const float* lse_t, const float* g, float* ds,
                             float* dt, int n, int V, int W, int cluster, int clusters, float eps,
                             void* stream) {
  // the log-sum-exps are read only
  const Params p{s, t, w, nullptr, const_cast<float*>(lse_s), const_cast<float*>(lse_t), g, ds,
                 dt, n, V, W, clusters, eps};
  return launch(true, p, cluster, stream);
}
