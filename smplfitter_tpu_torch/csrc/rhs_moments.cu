// K2: fused residual projection of the shape solve, in five forms.
//
// Replaces the TPU kernel smplfitter_tpu/ops/lbs_kernels.py:_rhs_kernel
// (launcher _rhs_moments_impl; APIs rhs_moments_h, rhs_moments,
// rhs_moments(scale=True) and rhs_moments_cached with and without scale). Per
// vertex and batch column: the posed template homog_c = consts_c . feat, the
// LBS position pos = blended [R|t] . homog, the residual b = tgt - pos, and
// its two vertex reductions
//     y[a, j, :] = sum_v w[v, j] b_a(v)                        (3, J, B)
//     r[e, :]    = sum_v sum_c SD[c, v, e] (Rbar_v^T b_v)_c     (E, B)
// where Rbar_v is the rotation part of the blended transform. The forms are
// compile-time variants of one kernel:
//   - emit-homog (EMIT): also writes homog (3, V_pad, B) for this iteration's
//     cached recon kernel (K4);
//   - plain: y and r only; no homog store;
//   - scale (SCALE): also the target-side moments of the scale column,
//     yt[a, j] = sum_v w[v, j] t_a(v), rt[e] = sum_v sum_c SD[c, v, e]
//     (Rbar_v^T t_v)_c and sc = [sum |t|^2, sum t.pos, sum |pos|^2] (3, B);
//   - cached (CACHED, plain or with SCALE): reads homog (3, V_pad, B), the
//     posed template that K7 (posed_template.cu) computed once per solve,
//     instead of running the F-deep homog dot. The large-F models (SMPL-X
//     F = 487, SMPL+H F = 460) take it;
//   - fit-weighted (W, with any of the above): a fitter's static fit weights,
//     the column ω (V_pad, 1), multiply b, and in the scale form t and the
//     three second moments, so every sum is ω-weighted (the JAX package's
//     static-ω form; per-call weights take K9, wgram.cu).
//
// What bounds it on an H100. The template-dot forms: f32 arithmetic, 3F FMAs
// per (vertex, column) of the dot against 21 per joint that skins the vertex
// (position and Rbar^T b), 3 per joint of y and 3E of r; at SMPL b4096 (F =
// 208, E = 10) about 0.6 ms of the 67 TFLOP/s rate. The cached forms: bytes,
// the targets and the posed template read once, 2 x 3 x V x B floats (1.03 GB
// at SMPL-X b4096, 0.31 ms at 3.35 TB/s), against about 150 FMAs per (vertex,
// column). Left now: the template dot's f32 issue (one block per SM), and in
// the cached forms the loads' latency between a tile's phases.
//
// Design: the vertices are walked through a cover (BlendSegments in
// ops/lbs_kernels.py: segments of at most 32 vertices of one body part, each
// with its active joints; every vertex below `covers` once, covers >= Vt). A
// block owns (a run of segments, 128 batch columns); each segment is one
// 32-row tile of template_tile.cuh, each thread 4 vertices x 4 columns:
// - the posed template by that header's register-tiled dot and cp.async ring
//   (or, cached, by float4 loads of homog), the position by its blend over
//   the segment's active joints, then b and g = Rbar^T b in registers, the
//   projection a second pass over the same joints;
// - y only for the segment's active joints, r with the tile's shape
//   directions staged k-major in shared memory ([c][e][vertex], by 4-byte
//   cp.async under the blend) and read as float4 of 4 vertices. A warp holds
//   the tile's 32 vertices of 16 columns (lane = 4 tm + column group), so the
//   vertex sum of each (row, column) is an in-register sum over the thread's
//   4 vertices and a reduce-scatter over the warp's 8 vertex groups (7
//   shuffles per 8 values: 2 joints or 2 shape rows x 4 columns), after which
//   each lane owns one (row, column);
// - r (and rt, sc) stay in registers over the block's run, one owner lane
//   per entry, stored once into the block's slice of the per-split partials
//   in device memory; the lists differ between segments, so y goes into the
//   partial after each tile (read-modify-write by the owner lane, tiles
//   ordered by block barriers; the slice stays in L2). A second kernel sums
//   the partials over splits in a fixed order. No atomics: a call repeats
//   bit for bit.
// The scale form runs the reductions a second time on the (weighted)
// targets, re-read. The target's vertex edge (Vt <= V_pad rows) and the
// batch edge are masked by global index; rows from `covers` to V_pad of the
// emitted homog (zero template rows) are cleared with one 2D memset.
#include "template_tile.cuh"

namespace {

using tmpl::NT;
using tmpl::TB;
using tmpl::TV;

constexpr int MAXE = 32;      // E <= 32
constexpr int EP = MAXE / 2;  // shape-row pairs
constexpr int SDL = TV + 4;   // row stride of the staged shape directions

// Output rows of the partials: y (3J), r (E) [, yt (3J), rt (E), sc (3)].
__host__ __device__ inline int rhs_rows(int J, int E, bool scale) {
  return scale ? 6 * J + 2 * E + 3 : 3 * J + E;
}

using tmpl::reduce_scatter8;

// part[row0 + a*J + j, col] += sum over the tile's vertices of w[v, j] f_a(v)
// for the segment's active joints jl[0 .. nA), two joints per pass; the lane
// of vertex group tm owns joint 2p + tm / 4 and column bc + tm % 4.
__device__ inline void add_joint_rows(float* part, int row0, const float (&f)[3][4][4],
                                      const float* __restrict__ w,
                                      const int* __restrict__ jl, int nA, int J, int B, int bc,
                                      const int vid[4], int tm) {
  const int col = bc + (tm & 3);
  for (int jj = 0; jj < nA; jj += 2) {
    const int ja = __ldg(jl + jj), jb = jj + 1 < nA ? __ldg(jl + jj + 1) : -1;
    float wa[4], wb[4];
    tmpl::joint_weights(wa, w, vid, J, ja);
    if (jb >= 0) {
      tmpl::joint_weights(wb, w, vid, J, jb);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) wb[i] = 0.f;
    }
    const int j = (tm & 4) ? jb : ja;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float x[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sa = fmaf(wa[i], f[a][i][k], sa);
          sb = fmaf(wb[i], f[a][i][k], sb);
        }
        x[k] = sa;
        x[4 + k] = sb;
      }
      const float s = reduce_scatter8(x, tm);
      if (j >= 0 && col < B) part[(size_t)(row0 + a * J + j) * B + col] += s;
    }
  }
}

// acc[p] += sum over the tile's vertices of sum_c SD[c, v, e] g_c(v), e =
// 2p + tm / 4, column bc + tm % 4 (the lane's own entries), with the tile's
// shape directions in sd_s[(c * E + e) * SDL + vertex row].
__device__ inline void add_shape_rows(float (&acc)[EP], const float (&g)[3][4][4],
                                      const float* sd_s, int E, int tm) {
#pragma unroll
  for (int p = 0; p < EP; ++p) {
    if (2 * p >= E) break;  // uniform across the block
    float x[8];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int e = 2 * p + q;
#pragma unroll
      for (int k = 0; k < 4; ++k) x[4 * q + k] = 0.f;
      if (e >= E) continue;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4 s4 = *reinterpret_cast<const float4*>(sd_s + (c * E + e) * SDL + 4 * tm);
        const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) x[4 * q + k] = fmaf(sv[i], g[c][i][k], x[4 * q + k]);
      }
    }
    acc[p] += reduce_scatter8(x, tm);
  }
}

// Loads the targets of the thread's 4 vertices x 4 columns: t[a][i][k], zero
// outside the target's rows and the batch.
template <bool VEC>
__device__ inline void load_targets(float (&t)[3][4][4], const float* __restrict__ tgt,
                                    const int vid[4], int Vt, int B, int bc) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool row_ok = vid[i] >= 0 && vid[i] < Vt;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (row_ok) {
        tmpl::load4<VEC>(t[a][i], tgt + ((size_t)a * Vt + vid[i]) * B + bc, bc, B);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) t[a][i][k] = 0.f;
      }
    }
  }
}

template <bool EMIT, bool SCALE, bool CACHED, bool W, bool VEC>
__global__ void __launch_bounds__(NT, 1)
rhs_moments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                   const float* __restrict__ feat, const float* __restrict__ w,
                   const float* __restrict__ consts, const float* __restrict__ sd,
                   const float* __restrict__ om, float* __restrict__ homog,
                   const int* __restrict__ verts, const int* __restrict__ seg_offset,
                   const int* __restrict__ joints, const int* __restrict__ joint_offset,
                   float* __restrict__ part, int J, int B, int F, int E, int Vt, int Vp,
                   int n_seg, int segs_per_block) {
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);          // the dot's ring (not cached)
  float* const sd_s = ring + (CACHED ? 0 : tmpl::RING_FLOATS);  // [3][E][SDL]
  int* const rows_s = reinterpret_cast<int*>(sd_s + 3 * E * SDL);  // [run][TV]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = lane / 4;                    // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 4 * warp + lane % 4;         // column group: 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;
  const int s0 = blockIdx.y * segs_per_block;
  const int n_tiles = min(segs_per_block, n_seg - s0);
  const int R = rhs_rows(J, E, SCALE);
  float* const part_blk = part + (size_t)blockIdx.y * R * B;

  for (int i = threadIdx.x; i < n_tiles * TV; i += NT) {
    const int beg = seg_offset[s0 + i / TV], n = seg_offset[s0 + i / TV + 1] - beg;
    rows_s[i] = i % TV < n ? verts[beg + i % TV] : -1;
  }
  // The y (and yt) rows are sums over the run's tiles: zero them first.
  for (int idx = threadIdx.x; idx < 3 * J * TB * (SCALE ? 2 : 1); idx += NT) {
    const int row = idx / TB, b = b0 + idx % TB;
    if (b < B) part_blk[(size_t)(row < 3 * J ? row : row + E) * B + b] = 0.f;  // yt after r
  }
  __syncthreads();

  float racc[EP], rtacc[EP], sc[3][4];
#pragma unroll
  for (int p = 0; p < EP; ++p) racc[p] = rtacc[p] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) sc[0][k] = sc[1][k] = sc[2][k] = 0.f;

  auto epilogue = [&](int tile, const float (&h)[3][4][4]) {
    const int seg = s0 + tile;
    const int j0 = joint_offset[seg], nA = joint_offset[seg + 1] - j0;
    const int* jl = joints + j0;
    int vid[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) vid[i] = rows_s[tile * TV + 4 * tm + i];
    // The tile's shape directions, k-major, copied under the blend below.
    for (int idx = threadIdx.x; idx < 3 * E * TV; idx += NT) {
      const int e = idx % E, c = (idx / E) % 3, vv = idx / (3 * E);
      const int v = rows_s[tile * TV + vv];
      sgemm::cp_async4(sd_s + (c * E + e) * SDL + vv,
                       v >= 0 ? sd + ((size_t)c * Vp + v) * E + e : sd, v >= 0);
    }
    sgemm::cp_async_commit();
    if (EMIT) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (vid[i] < 0) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          tmpl::store4<VEC>(homog + ((size_t)c * Vp + vid[i]) * B + bc, h[c][i], bc, B);
      }
    }
    float om_v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) om_v[i] = W ? (vid[i] >= 0 && vid[i] < Vt ? om[vid[i]] : 0.f) : 1.f;

    // b = (t - pos) ω, zero outside the target's rows; the scale form's sums.
    float b[3][4][4], t[3][4][4];
    tmpl::blend_pos<VEC>(b, h, pj, w, jl, nA, J, B, bc, vid);
    load_targets<VEC>(t, tgt, vid, Vt, B, bc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool row_ok = vid[i] >= 0 && vid[i] < Vt;
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float tval = t[a][i][k];
          const float pval = row_ok ? b[a][i][k] : 0.f;
          if (SCALE) {
            const float tw = W ? tval * om_v[i] : tval;
            sc[0][k] = fmaf(tw, tval, sc[0][k]);
            sc[1][k] = fmaf(tw, pval, sc[1][k]);
            sc[2][k] = fmaf(W ? pval * om_v[i] : pval, pval, sc[2][k]);
          }
          b[a][i][k] = W ? (tval - pval) * om_v[i] : tval - pval;
        }
    }
    float g[3][4][4];
    tmpl::blend_project<VEC>(g, b, pj, w, jl, nA, J, B, bc, vid);
    sgemm::cp_async_wait<0>();
    __syncthreads();  // the shape directions are in; the previous tile's y is added
    add_joint_rows(part_blk, 0, b, w, jl, nA, J, B, bc, vid, tm);
    add_shape_rows(racc, g, sd_s, E, tm);
    if (SCALE) {
      load_targets<VEC>(t, tgt, vid, Vt, B, bc);
      if (W) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int a = 0; a < 3; ++a)
#pragma unroll
            for (int k = 0; k < 4; ++k) t[a][i][k] *= om_v[i];
      }
      tmpl::blend_project<VEC>(g, t, pj, w, jl, nA, J, B, bc, vid);
      add_joint_rows(part_blk, 3 * J + E, t, w, jl, nA, J, B, bc, vid, tm);
      add_shape_rows(rtacc, g, sd_s, E, tm);
    }
  };

  if constexpr (CACHED) {
    for (int tile = 0; tile < n_tiles; ++tile) {
      float h[3][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = rows_s[tile * TV + 4 * tm + i];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (v >= 0) {
            tmpl::load4<VEC>(h[c][i], homog + ((size_t)c * Vp + v) * B + bc, bc, B);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) h[c][i][k] = 0.f;
          }
        }
      }
      epilogue(tile, h);
      __syncthreads();  // the shape directions are read before the next tile's copy
    }
  } else {
    const tmpl::Ring<VEC> rg(ring, rows_s, feat, consts, F, B, Vp, b0);
    tmpl::walk_tiles(rg, n_tiles, tm, tn, epilogue);
  }

  // The lane's own entries: r (rt) rows 2p + tm / 4 and sc rows tm / 4 of
  // column bc + tm % 4, over the 8 vertex groups for sc.
  const int col = bc + (tm & 3);
  if (col < B) {
#pragma unroll
    for (int p = 0; p < EP; ++p) {
      const int e = 2 * p + tm / 4;
      if (e < E) {
        part_blk[(size_t)(3 * J + e) * B + col] = racc[p];
        if (SCALE) part_blk[(size_t)(6 * J + E + e) * B + col] = rtacc[p];
      }
    }
  }
  if (SCALE) {
    float x[8], x2[8];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = sc[0][k];
      x[4 + k] = sc[1][k];
      x2[k] = sc[2][k];
      x2[4 + k] = 0.f;
    }
    const float s01 = reduce_scatter8(x, tm), s2 = reduce_scatter8(x2, tm);
    if (col < B) {
      const int s = tm / 4;
      part_blk[(size_t)(6 * J + 2 * E + s) * B + col] = s01;
      if (s == 0) part_blk[(size_t)(6 * J + 2 * E + 2) * B + col] = s2;
    }
  }
}

// Sums the per-split partials in split order into the outputs: rows [0, 3J)
// -> y, then E rows -> r, and in the scale form 3J rows -> yt, E -> rt, 3 -> sc.
__global__ void rhs_split_sum_kernel(const float* __restrict__ part, float* __restrict__ y,
                                     float* __restrict__ r_out, float* __restrict__ yt,
                                     float* __restrict__ rt, float* __restrict__ sc,
                                     int n_splits, int J, int E, int R, int B) {
  const size_t n = (size_t)R * B;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) s += part[(size_t)sp * n + idx];
    const int row = (int)(idx / B);
    const size_t b = idx % B;
    if (row < 3 * J) y[idx] = s;
    else if (row < 3 * J + E) r_out[(size_t)(row - 3 * J) * B + b] = s;
    else if (row < 6 * J + E) yt[(size_t)(row - 3 * J - E) * B + b] = s;
    else if (row < 6 * J + 2 * E) rt[(size_t)(row - 6 * J - E) * B + b] = s;
    else sc[(size_t)(row - 6 * J - 2 * E) * B + b] = s;
  }
}

struct Args {
  const float *tgt, *pj, *feat, *w, *consts, *sd, *om;
  float* homog;
  const int *verts, *seg_offset, *joints, *joint_offset;
  float* part;
  int J, B, F, E, Vt, Vp, n_seg, segs_per_block;
};

template <bool EMIT, bool SCALE, bool CACHED, bool W, bool VEC>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  auto kernel = rhs_moments_kernel<EMIT, SCALE, CACHED, W, VEC>;
  const size_t smem = sizeof(float) * ((CACHED ? 0 : tmpl::RING_FLOATS) + 3 * a.E * SDL) +
                      sizeof(int) * a.segs_per_block * TV;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.B + TB - 1) / TB, (a.n_seg + a.segs_per_block - 1) / a.segs_per_block);
  kernel<<<grid, NT, smem, stream>>>(a.tgt, a.pj, a.feat, a.w, a.consts, a.sd, a.om, a.homog,
                                     a.verts, a.seg_offset, a.joints, a.joint_offset, a.part,
                                     a.J, a.B, a.F, a.E, a.Vt, a.Vp, a.n_seg,
                                     a.segs_per_block);
  return cudaGetLastError();
}

// One form: unweighted (om null) or fit-weighted, float4 or 4-byte access.
template <bool EMIT, bool SCALE, bool CACHED>
cudaError_t launch_form(const Args& a, bool vec, cudaStream_t stream) {
  if (a.om == nullptr)
    return vec ? launch_variant<EMIT, SCALE, CACHED, false, true>(a, stream)
               : launch_variant<EMIT, SCALE, CACHED, false, false>(a, stream);
  return vec ? launch_variant<EMIT, SCALE, CACHED, true, true>(a, stream)
             : launch_variant<EMIT, SCALE, CACHED, true, false>(a, stream);
}

}  // namespace

// tgt (3, Vt, B), pj (12, J, B), feat (F, B), w (Vp, J), consts (>= 3, Vp, F),
// sd (3, Vp, E), om null or the static fit weights (Vp, 1), the cover (verts,
// seg_offset (n_seg + 1), joints, joint_offset (n_seg + 1); every vertex
// below `covers` once, segments of at most 32, covers >= Vt) -> r (E, B),
// y (3, J, B); homog (3, Vp, B) is written when emit_homog (rows from
// `covers` on zero) and read instead of feat and consts (which may be null)
// when cached; rt (E, B), yt (3, J, B), sc (3, B) when scale. emit_homog
// excludes scale and cached; unused outputs may be null. part is scratch of
// n_splits * R * B floats, R = 3J + E (scale: 6J + 2E + 3), n_splits =
// ceil(n_seg / segs_per_block). Requires E <= 32.
SMPL_API int rhs_moments_launch(const float* tgt, const float* pj, const float* feat,
                                const float* w, const float* consts, const float* sd,
                                const float* om, const int* verts, const int* seg_offset,
                                const int* joints, const int* joint_offset, float* r_out,
                                float* y, float* homog, float* rt, float* yt, float* sc,
                                float* part, int J, int B, int F, int E, int Vt, int Vp,
                                int n_seg, int segs_per_block, int covers, int emit_homog,
                                int scale, int cached, cudaStream_t stream) {
  if ((emit_homog && (scale || cached)) || E > MAXE || E < 1 || covers < Vt || n_seg < 1 ||
      segs_per_block < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  cudaError_t err;
  if (emit_homog && covers < Vp) {
    err = cudaMemset2DAsync(homog + (size_t)covers * B, sizeof(float) * (size_t)Vp * B, 0,
                            sizeof(float) * (size_t)(Vp - covers) * B, 3, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const Args a{tgt, pj, feat, w, consts, sd, om, (emit_homog || cached) ? homog : nullptr,
               verts, seg_offset, joints, joint_offset, part, J, B, F, E, Vt, Vp, n_seg,
               segs_per_block};
  const bool vec = B % 4 == 0 && sgemm::aligned16(pj) && sgemm::aligned16(tgt) &&
                   (cached || sgemm::aligned16(feat)) &&
                   (!(emit_homog || cached) || sgemm::aligned16(homog));
  if (emit_homog) err = launch_form<true, false, false>(a, vec, stream);
  else if (cached && scale) err = launch_form<false, true, true>(a, vec, stream);
  else if (cached) err = launch_form<false, false, true>(a, vec, stream);
  else if (scale) err = launch_form<false, true, false>(a, vec, stream);
  else err = launch_form<false, false, false>(a, vec, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_splits = (n_seg + segs_per_block - 1) / segs_per_block;
  const int R = rhs_rows(J, E, scale);
  const size_t n = (size_t)R * B;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads);
  rhs_split_sum_kernel<<<blocks, threads, 0, stream>>>(part, y, r_out, yt, rt, sc, n_splits, J,
                                                       E, R, B);
  return (int)cudaGetLastError();
}
