// K9: the shape solve's centred normal equations under per-call fit weights.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_wgram_kernel
// (API wgram_moments). Per-call vertex weights ω (V, B) break the static
// joint-pair moments of the unweighted solve, so the normal equations are
// rebuilt from each vertex's beta-Jacobian. For each vertex v < V and batch
// column b, with Rbar / tbar the skinning-blended [R|t] entries:
//     pos_a    = Rbar[a, :] . homog_v + tbar_a,   b_a = tgt_a - pos_a
//     jac[a,e] = sum_j w_vj T4[a*E+e, j] + sum_c Rbar[a, c] SD_v[c, e] - mu[a*E+e]
// and with scale_mode 1 (scale_target) or 2 (scale_fit) one more column,
// -tgt_a or pos_a, minus mu_s[a]. It accumulates over v
//     G[e, f] = sum ω sum_a jac[a,e] jac[a,f]   (upper triangle once, mirrored)
//     SA[a*E1+e] = sum ω jac[a,e],  r[e] = sum ω sum_a jac[a,e] b_a,
//     Sb[a] = sum ω b_a,  W = sum ω.
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column): the
// [R|t] and translation-Jacobian blends (12 + 3E FMAs per joint that skins
// the vertex), 9E of the shape directions and ~3 N (N + 1) / 2 of the sums
// (N = E1 + 4, below): at SMPL-X (E = 16, 3 joints per vertex) ~1,000 FMAs,
// ~85 GFLOP at B = 4096, against ~0.9 GB of targets, template and weights.
//
// Design.
// - The blend runs over each segment's active joints only. The host covers
//   the vertices < V with segments of at most 32 vertices, each inside one
//   body part (grouped by dominant joint), and lists for each segment every
//   joint with a nonzero weight on any of its vertices (BlendSegments in
//   ops/lbs_kernels.py). The terms left out are products with exact zeros.
//   A segment with many active joints (up to all of them, dense weights)
//   runs the same loop over a longer list.
// - One augmented Gram per batch column. Each (vertex, axis a) point gives a
//   row x = sqrt(ω) [jac[a, 0..E1), b_a, 1{a=0}, 1{a=1}, 1{a=2}] of N = E1 + 4
//   entries (padded to NP, a multiple of 4); sum x^T x over the rows holds
//   G, r (column E1), SA (columns E1 + 1 + a), Sb (row E1 against those) and
//   W (a diagonal indicator entry). The TPU kernel's sqrt(ω) factorisation:
//   ω >= 0 (fit confidences), and (sqrt ω)^2 differs from ω by rounding.
// - A block owns TBW batch columns (8, fewer where shared memory requires),
//   one warp each, and a split of the segments. Every joint's [R|t] and T4
//   entries for its columns are staged once in shared memory, as the
//   parent design did; the segments' lists index into them. Blocks of
//   E <= 12 take at most 128 registers; wider ones up to 255 (their three
//   axes' blends in registers at once, no spills), one block to an SM.
// - Per segment each warp builds its column's 96 rows (a lane per vertex:
//   the three axes' blends in registers, joint by joint, each float4 of the
//   shape directions read once for the three rows, float4 stores) in a
//   stage of its own, then runs a register-tiled symmetric rank update on
//   them: each lane owns a 4 x 4 block of the upper triangle of the Gram
//   (and a share of the rows), reading two float4 per row for 16 FMAs, the
//   lanes sharing their float4 (broadcasts). A warp needs no block barrier
//   between the two.
// - The next segment's vertex and joint lists, shape directions, weights,
//   and its points' template, targets and ω are gathered by cp.async while
//   this segment's arithmetic runs (double buffers, a ring of three for the
//   lists): one block barrier per segment. Scattered 4-byte gathers are what
//   the parent design's loads cost most, so the copies are 16 bytes where
//   the layout allows (a vertex's 4 or 8 batch columns of a point array
//   where B % 4 == 0; its shape-direction rows where E % 4 == 0, 8 bytes
//   where E is even).
// - Sums are per segment, added to the running sums once per segment (short
//   f32 chains), the row groups summed in order at the end, each split
//   writes its partial once, and a second kernel sums the splits in order.
//   No atomics: runs repeat bit for bit. Rows past a segment, of vertices at
//   or past V and columns past B carry sqrt(ω) = 0 and add nothing.
#include "sgemm_tile.cuh"  // cp.async

namespace {

constexpr int TV = 32;        // vertices per segment at most: a warp's lanes
constexpr int ROWS = 3 * TV;  // rows of a segment: (vertex, axis)
constexpr int MAX_NT = 256;   // threads per block at most (TBW = 8 warps)

// The sizes of one call, the same on the host and the device.
struct Dims {
  int E, E1, N, NP, nb, nT;
  int RS;   // row stride of a warp's stage: NP, made 4 mod 8 (float4 stores by 32 lanes)
  int EA;   // shape entries per axis: E rounded up to 4
  int AS;   // floats per (column, joint, axis) of the joint stage: [Rbar row | tbar | T4 row]
  int MS;   // floats per (column, axis) of the means: mu row (EA), then mu_s
  int SDS;  // floats per vertex of the shape-direction stage: 3 EA, made 4 mod 8
};

__host__ __device__ inline Dims dims_of(int E, int scale) {
  Dims d;
  d.E = E;
  d.E1 = E + (scale ? 1 : 0);
  d.N = d.E1 + 4;
  d.NP = (d.N + 3) / 4 * 4;
  d.nb = d.NP / 4;
  d.nT = d.nb * (d.nb + 1) / 2;
  d.RS = d.NP % 8 == 4 ? d.NP : d.NP + 4;
  d.EA = (E + 3) / 4 * 4;
  d.AS = 4 + d.EA;
  d.MS = d.EA + 4;
  d.SDS = 3 * d.EA % 8 == 4 ? 3 * d.EA : 3 * d.EA + 4;
  return d;
}

// Shared-memory floats of a block of TBW columns; maxA the longest joint
// list, cap the segments of a split at most.
__host__ __device__ inline size_t smem_floats(const Dims& d, int J, int TBW, int maxA, int cap) {
  return (size_t)TBW * J * 3 * d.AS + (size_t)TBW * 3 * d.MS + (size_t)TBW * ROWS * d.RS +
         (size_t)2 * TV * d.SDS + (size_t)2 * 7 * TV * (TBW + 4) + (size_t)2 * maxA * TV +
         3 * TV + 3 * maxA + 2 * (cap + 1);
}

__device__ inline float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// The upper-triangle block (eb, fb), eb <= fb, of index t in row-major order.
__host__ __device__ inline void block_of(int t, int nb, int& eb, int& fb) {
  eb = 0;
  while (t >= nb - eb) {
    t -= nb - eb;
    ++eb;
  }
  fb = eb + t;
}

__device__ __forceinline__ void cp_async_i4(int* dst, const int* src, bool live) {
  sgemm::cp_async4(reinterpret_cast<float*>(dst), reinterpret_cast<const float*>(src), live);
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src, bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(live ? 8 : 0)
               : "memory");
}

// EP: shape entries per axis held in registers (>= E); MT: tasks per lane.
template <int EP, int MT>
__global__ void __launch_bounds__(MAX_NT, EP <= 12 ? 2 : 1)
wgram_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
             const float* __restrict__ homog, const float* __restrict__ t4,
             const float* __restrict__ w, const float* __restrict__ sd,
             const float* __restrict__ mu, const float* __restrict__ omega,
             const float* __restrict__ mu_s, const int* __restrict__ verts,
             const int* __restrict__ seg_offset, const int* __restrict__ joints,
             const int* __restrict__ joint_offset, float* __restrict__ part, int J, int E,
             int B, int V, int Vp, int scale_mode, int n_seg, int maxA, int KG, int vec_pt,
             int vec_sd) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims_of(E, scale_mode);
  const int TBW = blockDim.x / 32, nthr = blockDim.x;
  const int tid = threadIdx.x, lane = tid % 32, col = tid / 32;
  const int b0 = blockIdx.x * TBW, b = b0 + col;
  const int split = blockIdx.y, n_splits = gridDim.y;
  const int s_beg = (int)((long long)n_seg * split / n_splits);
  const int ns = (int)((long long)n_seg * (split + 1) / n_splits) - s_beg;
  const int cap = (n_seg + n_splits - 1) / n_splits;

  float* const js = smem;                             // [TBW][J][3][AS]
  float* const mus = js + TBW * J * 3 * d.AS;         // [TBW][3][MS]
  float* const stage = mus + TBW * 3 * d.MS;          // [TBW][ROWS][RS]
  float* const sds = stage + TBW * ROWS * d.RS;       // [2][TV][SDS]
  const int PS = TBW + 4;                             // vertex stride of the point stage
  float* const pts = sds + 2 * TV * d.SDS;            // [2][7][TV][PS]: homog, tgt, ω
  float* const ws = pts + 2 * 7 * TV * PS;            // [2][maxA][TV]
  int* const rows = reinterpret_cast<int*>(ws + 2 * maxA * TV);  // [3][TV]
  int* const jl = rows + 3 * TV;                      // [3][maxA]
  int* const offs_v = jl + 3 * maxA;                  // [cap + 1]: the split's segment bounds
  int* const offs_j = offs_v + cap + 1;               // [cap + 1]: its joint-list bounds

  for (int i = tid; i <= ns; i += nthr) {
    offs_v[i] = seg_offset[s_beg + i];
    offs_j[i] = joint_offset[s_beg + i];
  }
  // Every joint's [R|t] row a and T4 rows a*E .. a*E+E (zero past E), per
  // column (zero past B); read column fastest.
  for (int idx = tid; idx < TBW * J * 3 * d.AS; idx += nthr) {
    const int c = idx % TBW, rest = idx / TBW;
    const int r = rest % d.AS, aj = rest / d.AS;  // aj = j * 3 + a
    const int a = aj % 3, j = aj / 3, bb = b0 + c;
    float val = 0.f;
    if (bb < B) {
      if (r < 4) val = pj[((size_t)(a * 4 + r) * J + j) * B + bb];
      else if (r - 4 < E) val = t4[((size_t)(a * E + r - 4) * J + j) * B + bb];
    }
    js[((c * J + j) * 3 + a) * d.AS + r] = val;
  }
  for (int idx = tid; idx < TBW * 3 * d.MS; idx += nthr) {
    const int c = idx % TBW, rest = idx / TBW;
    const int e = rest % d.MS, a = rest / d.MS, bb = b0 + c;
    float val = 0.f;
    if (bb < B) {
      if (e < E) val = mu[(size_t)(a * E + e) * B + bb];
      else if (e == d.EA && scale_mode) val = mu_s[(size_t)a * B + bb];
    }
    mus[(c * 3 + a) * d.MS + e] = val;
  }
  __syncthreads();  // the split's bounds

  // Segment k's vertex and joint lists into slot k % 3 of the ring.
  auto issue_lists = [&](int k) {
    if (k >= ns) return;
    const int v0 = offs_v[k], n = offs_v[k + 1] - v0;
    const int j0 = offs_j[k], nA = offs_j[k + 1] - j0;
    for (int i = tid; i < TV; i += nthr)
      cp_async_i4(rows + (k % 3) * TV + i, i < n ? verts + v0 + i : verts, i < n);
    for (int i = tid; i < nA; i += nthr) cp_async_i4(jl + (k % 3) * maxA + i, joints + j0 + i, true);
  };
  // Segment k's shape directions, weights, and the template, targets and ω
  // of its points into buffer k % 2 (its lists landed), 16 bytes a copy
  // where E (shape directions) or B (points) and the alignment allow.
  auto issue_data = [&](int k) {
    if (k >= ns) return;
    const int n = offs_v[k + 1] - offs_v[k], nA = offs_j[k + 1] - offs_j[k];
    const int* rr = rows + (k % 3) * TV;
    const int* jj_of = jl + (k % 3) * maxA;
    float* sb = sds + (k % 2) * TV * d.SDS;
    float* pb = pts + (k % 2) * 7 * TV * PS;
    float* wb = ws + (k % 2) * maxA * TV;
    if (vec_sd) {  // vec_sd floats a copy: 4 or 2
      const int QE = E / vec_sd;
      for (int idx = tid; idx < TV * 3 * QE; idx += nthr) {
        const int vv = idx / (3 * QE), rem = idx % (3 * QE);
        const int c = rem / QE, q = rem % QE;
        const bool live = vv < n;
        float* dst = sb + vv * d.SDS + c * d.EA + vec_sd * q;
        const float* src = live ? sd + ((size_t)c * Vp + rr[vv]) * E + vec_sd * q : sd;
        if (vec_sd == 4) sgemm::cp_async16(dst, src, live);
        else cp_async8(dst, src, live);
      }
    } else {
      for (int idx = tid; idx < TV * 3 * d.EA; idx += nthr) {
        const int vv = idx / (3 * d.EA), rem = idx % (3 * d.EA);
        const int c = rem / d.EA, e = rem % d.EA;
        const bool live = vv < n && e < E;
        sgemm::cp_async4(sb + vv * d.SDS + rem,
                         live ? sd + ((size_t)c * Vp + rr[vv]) * E + e : sd, live);
      }
    }
    // Point arrays a (0-2 homog, 3-5 tgt, 6 ω) of vertex vv, columns b0 + ...:
    // rows past the segment or past V are zero.
    auto point_src = [&](int a, int v) -> const float* {
      return a < 3 ? homog + ((size_t)a * Vp + v) * B
                   : (a < 6 ? tgt + ((size_t)(a - 3) * V + v) * B : omega + (size_t)v * B);
    };
    if (vec_pt) {
      const int QB = TBW / 4;
      for (int idx = tid; idx < 7 * TV * QB; idx += nthr) {
        const int q = idx % QB, av = idx / QB;
        const int vv = av % TV, a = av / TV;
        const int v = vv < n ? rr[vv] : 0;
        const bool live = vv < n && v < V && b0 + 4 * q < B;
        sgemm::cp_async16(pb + (a * TV + vv) * PS + 4 * q,
                          live ? point_src(a, v) + b0 + 4 * q : homog, live);
      }
    } else {
      for (int idx = tid; idx < 7 * TV * TBW; idx += nthr) {
        const int c = idx % TBW, av = idx / TBW;
        const int vv = av % TV, a = av / TV;
        const int v = vv < n ? rr[vv] : 0;
        const bool live = vv < n && v < V && b0 + c < B;
        sgemm::cp_async4(pb + (a * TV + vv) * PS + c, live ? point_src(a, v) + b0 + c : homog,
                         live);
      }
    }
    for (int idx = tid; idx < nA * TV; idx += nthr) {
      const int jj = idx / TV, vv = idx % TV;
      const bool live = vv < n;
      sgemm::cp_async4(wb + idx, live ? w + (size_t)rr[vv] * J + jj_of[jj] : w, live);
    }
  };
  // This lane's tasks: task = g * nT + block, g the row group.
  const int RG = ROWS / KG;
  int t_e[MT], t_f[MT];
  bool t_live[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int task = lane + 32 * m;
    t_live[m] = task < KG * d.nT;
    const int tt = t_live[m] ? task : 0;
    int eb, fb;
    block_of(tt % d.nT, d.nb, eb, fb);
    const int r0 = (tt / d.nT) * RG * d.RS;
    t_e[m] = r0 + 4 * eb;
    t_f[m] = r0 + 4 * fb;
  }
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int k = 0; k < 16; ++k) acc[m][k] = 0.f;

  float* const st = stage + col * ROWS * d.RS;  // this warp's rows
  const float* const jsc = js + col * J * 3 * d.AS;
  issue_lists(0);
  sgemm::cp_async_commit();
  sgemm::cp_async_wait<0>();
  __syncthreads();
  issue_data(0);
  issue_lists(1);
  sgemm::cp_async_commit();
  sgemm::cp_async_wait<0>();
  __syncthreads();
  for (int k = 0; k < ns; ++k) {
    issue_data(k + 1);
    issue_lists(k + 2);
    sgemm::cp_async_commit();
    // This lane's point: template, target and ω (zero outside the segment,
    // past V or past B).
    float pt[7];
#pragma unroll
    for (int a = 0; a < 7; ++a) pt[a] = pts[(((k % 2) * 7 + a) * TV + lane) * PS + col];
    const int nA = offs_j[k + 1] - offs_j[k];
    const float* sdv = sds + (k % 2) * TV * d.SDS + lane * d.SDS;
    const float* wb = ws + (k % 2) * maxA * TV + lane;
    const int* jlk = jl + (k % 3) * maxA;
    const float som = sqrtf(pt[6]);

    // The blends of the three axes over the segment's active joints (each
    // joint's weight and list entry read once), then each float4 of the shape
    // directions read once for the three axes' rows.
    float bl[3][4], tb[3][EP];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int k = 0; k < 4; ++k) bl[a][k] = 0.f;
#pragma unroll
      for (int e = 0; e < EP; ++e) tb[a][e] = 0.f;
    }
    for (int jj = 0; jj < nA; ++jj) {
      const float wv = wb[jj * TV];
      const float* p = jsc + jlk[jj] * 3 * d.AS;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float4 r = ld4(p + a * d.AS);
        bl[a][0] = fmaf(wv, r.x, bl[a][0]);
        bl[a][1] = fmaf(wv, r.y, bl[a][1]);
        bl[a][2] = fmaf(wv, r.z, bl[a][2]);
        bl[a][3] = fmaf(wv, r.w, bl[a][3]);
#pragma unroll
        for (int q = 0; q < EP / 4; ++q) {
          if (4 * q < E) {
            const float4 t = ld4(p + a * d.AS + 4 + 4 * q);
            tb[a][4 * q] = fmaf(wv, t.x, tb[a][4 * q]);
            tb[a][4 * q + 1] = fmaf(wv, t.y, tb[a][4 * q + 1]);
            tb[a][4 * q + 2] = fmaf(wv, t.z, tb[a][4 * q + 2]);
            tb[a][4 * q + 3] = fmaf(wv, t.w, tb[a][4 * q + 3]);
          }
        }
      }
    }
    float* const row0 = st + lane * 3 * d.RS;  // the lane's rows (vertex, a) at row0 + a RS
    const float* const muc = mus + col * 3 * d.MS;
#pragma unroll
    for (int q = 0; q < EP / 4; ++q) {
      if (4 * q < E) {
        const float4 s0 = ld4(sdv + 4 * q), s1 = ld4(sdv + d.EA + 4 * q);
        const float4 s2 = ld4(sdv + 2 * d.EA + 4 * q);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float4 m = ld4(muc + a * d.MS + 4 * q);
          float4 x;
          x.x = som * fmaf(bl[a][0], s0.x, fmaf(bl[a][1], s1.x, fmaf(bl[a][2], s2.x, tb[a][4 * q] - m.x)));
          x.y = som * fmaf(bl[a][0], s0.y, fmaf(bl[a][1], s1.y, fmaf(bl[a][2], s2.y, tb[a][4 * q + 1] - m.y)));
          x.z = som * fmaf(bl[a][0], s0.z, fmaf(bl[a][1], s1.z, fmaf(bl[a][2], s2.z, tb[a][4 * q + 2] - m.z)));
          x.w = som * fmaf(bl[a][0], s0.w, fmaf(bl[a][1], s1.w, fmaf(bl[a][2], s2.w, tb[a][4 * q + 3] - m.w)));
          *reinterpret_cast<float4*>(row0 + a * d.RS + 4 * q) = x;
        }
      }
    }
    // Entries E .. NP of each row: the scale column, the residual, the axis
    // indicators, zeros (over the float4 tail past E).
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = fmaf(bl[a][0], pt[0], fmaf(bl[a][1], pt[1], fmaf(bl[a][2], pt[2], bl[a][3])));
      const float tga = pt[3 + a];
      float* row = row0 + a * d.RS;
      for (int e = E; e < d.NP; ++e) {
        float val = 0.f;
        if (e == E && scale_mode) val = som * ((scale_mode == 1 ? -tga : pos) - muc[a * d.MS + d.EA]);
        else if (e == d.E1) val = som * (tga - pos);
        else if (e == d.E1 + 1 + a) val = som;
        row[e] = val;
      }
    }
    __syncwarp();

    // The symmetric rank update of this warp's column over the segment.
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (!t_live[m]) continue;
      float tmp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) tmp[i] = 0.f;
      const float* xe = st + t_e[m];
      const float* xf = st + t_f[m];
#pragma unroll 4
      for (int r = 0; r < RG; ++r) {
        const float4 p = ld4(xe + r * d.RS), q = ld4(xf + r * d.RS);
        const float pe[4] = {p.x, p.y, p.z, p.w}, qf[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) tmp[i * 4 + j] = fmaf(pe[i], qf[j], tmp[i * 4 + j]);
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[m][i] += tmp[i];
    }
    __syncwarp();  // the warp is done with its rows
    sgemm::cp_async_wait<0>();
    __syncthreads();  // segment k + 1's data and k + 2's lists have landed
  }

  // Sum the row groups in order and write the split's partial
  // part[split][block * 16 + k][b]; the warp's rows are free now.
  float* red = st;  // [KG nT][16]
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    const int task = lane + 32 * m;
    if (t_live[m])
#pragma unroll
      for (int i = 0; i < 16; ++i) red[task * 16 + i] = acc[m][i];
  }
  __syncwarp();
  if (b < B)
    for (int idx = lane; idx < d.nT * 16; idx += 32) {
      float sum = 0.f;
      for (int g = 0; g < KG; ++g) sum += red[g * d.nT * 16 + idx];
      part[((size_t)split * d.nT * 16 + idx) * B + b] = sum;
    }
}

// Entry (n1, n2) of the augmented Gram in the partial layout (block * 16 + k).
__device__ inline int aug_index(int n1, int n2, int nb) {
  if (n1 > n2) {
    const int t = n1;
    n1 = n2;
    n2 = t;
  }
  const int eb = n1 / 4, fb = n2 / 4;
  const int t = eb * nb - eb * (eb - 1) / 2 + (fb - eb);
  return t * 16 + (n1 % 4) * 4 + n2 % 4;
}

// Sums the split partials in split order and scatters them: G mirrored.
__global__ void wgram_split_sum_kernel(const float* __restrict__ part, float* __restrict__ G,
                                       float* __restrict__ SA, float* __restrict__ r,
                                       float* __restrict__ Sb, float* __restrict__ W,
                                       int n_splits, int E, int scale, int B) {
  const Dims d = dims_of(E, scale);
  const int E1 = d.E1;
  const int n_out = E1 * E1 + 3 * E1 + E1 + 3 + 1;
  const size_t n = (size_t)n_out * B, stride = (size_t)d.nT * 16 * B;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int o = (int)(idx / B);
    const size_t bb = idx % B;
    float* dst;
    int src;
    if (o < E1 * E1) {
      dst = G + (size_t)o * B;
      src = aug_index(o / E1, o % E1, d.nb);
    } else if (o < E1 * E1 + 3 * E1) {
      const int q = o - E1 * E1;  // SA[a * E1 + e]
      dst = SA + (size_t)q * B;
      src = aug_index(q % E1, E1 + 1 + q / E1, d.nb);
    } else if (o < E1 * E1 + 4 * E1) {
      const int e = o - E1 * E1 - 3 * E1;
      dst = r + (size_t)e * B;
      src = aug_index(e, E1, d.nb);
    } else if (o < E1 * E1 + 4 * E1 + 3) {
      const int a = o - E1 * E1 - 4 * E1;
      dst = Sb + (size_t)a * B;
      src = aug_index(E1, E1 + 1 + a, d.nb);
    } else {
      dst = W;
      src = aug_index(E1 + 1, E1 + 1, d.nb);
    }
    float sum = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) sum += part[sp * stride + (size_t)src * B + bb];
    dst[bb] = sum;
  }
}

constexpr size_t SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a block may use

template <int EP, int MT>
cudaError_t launch_wgram(const float* tgt, const float* pj, const float* homog, const float* t4,
                         const float* w, const float* sd, const float* mu, const float* omega,
                         const float* mu_s, const int* verts, const int* seg_offset,
                         const int* joints, const int* joint_offset, float* part, int J, int E,
                         int B, int V, int Vp, int scale_mode, int n_seg, int n_splits,
                         int maxA, int KG, int TBW, int vec_pt, int vec_sd, size_t smem,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wgram_kernel<EP, MT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((B + TBW - 1) / TBW, n_splits);
  wgram_kernel<EP, MT><<<grid, 32 * TBW, smem, stream>>>(
      tgt, pj, homog, t4, w, sd, mu, omega, mu_s, verts, seg_offset, joints, joint_offset, part,
      J, E, B, V, Vp, scale_mode, n_seg, maxA, KG, vec_pt, vec_sd);
  return cudaGetLastError();
}

}  // namespace

// tgt (3, V, B), pj (12, J, B), homog (3, Vp, B), t4 (3E, J, B), w (Vp, J),
// sd (3, Vp, E), mu (3E, B), omega (V, B), mu_s (3, B) when scale_mode; the
// segment cover: verts, seg_offset (n_seg + 1; at most 32 vertices each),
// joints, joint_offset (n_seg + 1), max_joints the longest list ->
// G (E1^2, B), SA (3E1, B), r (E1, B), Sb (3, B), W (1, B), E1 = E +
// (scale_mode != 0). The launch plan (lbs_kernels.wgram_plan): TBW columns
// per block (2, 4 or 8), MT tasks per lane (1 or 2), KG row groups (dividing
// 96, KG nT <= 32 MT), n_splits; part is scratch of n_splits * part_floats * B
// floats, part_floats = 16 nT. A plan that disagrees with this layout, E
// outside 1..32 or a block past the shared memory is refused.
SMPL_API int wgram_launch(const float* tgt, const float* pj, const float* homog,
                          const float* t4, const float* w, const float* sd, const float* mu,
                          const float* omega, const float* mu_s, const int* verts,
                          const int* seg_offset, const int* joints, const int* joint_offset,
                          float* part, float* G, float* SA, float* r, float* Sb, float* W, int J,
                          int E, int B, int V, int Vp, int scale_mode, int n_seg, int n_splits,
                          int max_joints, int TBW, int MT, int KG, int part_floats,
                          cudaStream_t stream) {
  if (E < 1 || E > 32 || n_seg < 1 || n_splits < 1 || (scale_mode && mu_s == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d = dims_of(E, scale_mode);
  const int EP = E <= 12 ? 12 : (E <= 20 ? 20 : 32);
  const int maxA = max_joints < 1 ? 1 : max_joints;
  const int cap = (n_seg + n_splits - 1) / n_splits;
  const size_t smem = sizeof(float) * smem_floats(d, J, TBW, maxA, cap);
  if (part_floats != 16 * d.nT || (TBW != 2 && TBW != 4 && TBW != 8) || (MT != 1 && MT != 2) ||
      KG < 1 || ROWS % KG != 0 || KG * d.nT > 32 * MT || smem > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;
  const int vec_pt = TBW >= 4 && B % 4 == 0 && sgemm::aligned16(tgt) &&
                     sgemm::aligned16(homog) && sgemm::aligned16(omega);
  const bool aligned8 = (reinterpret_cast<uintptr_t>(sd) & 7) == 0;
  const int vec_sd = E % 4 == 0 && sgemm::aligned16(sd) ? 4 : (E % 2 == 0 && aligned8 ? 2 : 0);
  cudaError_t err = cudaSuccess;
#define WGRAM_CASE(ep, mt)                                                                     \
  if (EP == ep && MT == mt)                                                                    \
    err = launch_wgram<ep, mt>(tgt, pj, homog, t4, w, sd, mu, omega, mu_s, verts, seg_offset,  \
                               joints, joint_offset, part, J, E, B, V, Vp, scale_mode, n_seg,  \
                               n_splits, maxA, KG, TBW, vec_pt, vec_sd, smem, stream);
  WGRAM_CASE(12, 1)
  WGRAM_CASE(12, 2)
  WGRAM_CASE(20, 1)
  WGRAM_CASE(20, 2)
  WGRAM_CASE(32, 1)
  WGRAM_CASE(32, 2)
#undef WGRAM_CASE
  if (err != cudaSuccess) return (int)err;
  const size_t n = (size_t)(d.E1 * d.E1 + 4 * d.E1 + 4) * B;
  const int threads = 256;
  wgram_split_sum_kernel<<<(int)((n + threads - 1) / threads), threads, 0, stream>>>(
      part, G, SA, r, Sb, W, n_splits, E, scale_mode ? 1 : 0, B);
  return (int)cudaGetLastError();
}
