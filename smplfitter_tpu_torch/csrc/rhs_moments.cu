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
// 208, E = 10) about 0.6 ms of the 67 TFLOP/s rate. The dot is issue-bound
// (FMAs, the shared loads that feed them, the ring's 4-byte gathers); the
// epilogue is latency-bound (global loads of the joints' [R|t] and the
// targets, shuffles, the y partial's read-modify-write), so run one after
// the other on the same warps the SM's FMA pipes idle through every
// epilogue (SMPL b131072: dot 33.6 ms + epilogue 26.1 ms of 59.7). The
// cached forms: bytes, the targets and the posed template read once, 2 x 3
// x V x B floats (1.03 GB at SMPL-X b4096, 0.31 ms at 3.35 TB/s), against
// about 150 FMAs per (vertex, column). Left now: in the overlapped loop the
// dot warps' own rate (alone 39-40 ms at SMPL b131072, against 33.6 in the
// serial loop's 8 warps of up to 255 registers), the epilogue warps' spills
// (136 registers), and in the cached forms the loads' latency between a
// tile's phases.
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
//   ordered by barriers; the slice stays in L2). A second kernel sums the
//   partials over splits in a fixed order. No atomics: a call repeats bit
//   for bit.
// The template-dot forms on runs of at least 4 segments take the overlapped
// loop: 16 warps a block, 8 running the template dot of tile t + 1 (the same
// ring, thread tile and k order, the operands one feature ahead of their
// FMAs) while the other 8 run tile t's epilogue, registers split between
// the two by setmaxnreg. Named barriers hand each tile's template over
// through a double-buffered stage in shared memory. The epilogue warps
// take the tiles in the run's order, so the sums are those of the serial
// loop. Shorter runs (small batches) have little to overlap and take the
// serial loop, each tile's dot then its epilogue on all 8 warps; so do the
// cached forms, which have no dot. ops/lbs_kernels.py counts each launch
// under the loop it took (K2_PIPELINE).
// The scale form runs the reductions a second time on the (weighted)
// targets, re-read. The target's vertex edge (Vt <= V_pad rows) and the
// batch edge are masked by global index; rows from `covers` to V_pad of the
// emitted homog (zero template rows) are cleared with one 2D memset.
#include "template_tile.cuh"

namespace {

using tmpl::NT;
using tmpl::TB;
using tmpl::TV;

using tmpl::EP;
using tmpl::MAXE;
using tmpl::SDL;

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

using tmpl::add_shape_rows;

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

// The overlapped loop (PIPE) runs 2 NT threads: warps 0-7 the template dot,
// warps 8-15 the epilogue, each thread of either role the same 4 vertices x
// 4 columns of a tile as in the serial loop (warp taken mod 8). The dot warps
// hand each tile's template to the epilogue warps through a double-buffered
// stage in shared memory and go on with the next tile's dot.
constexpr int NTP = 2 * NT;             // threads of the overlapped loop
constexpr int LDH = TB + 4;             // row stride of the template stage
constexpr int H_FLOATS = 3 * TV * LDH;  // one tile's template: [c][vertex row][LDH]
// Registers per thread of each role (setmaxnreg; 2 NT threads of 128 at entry:
// what the dot warps give back, the epilogue warps take). At SMPL b131072 an
// early form of this loop took 58.1, 55.9, 54.7 and 48.3 ms with 96, 104, 112
// and 120 for the dot warps: fewer starve the dot; the epilogue warps spill
// some at 136.
constexpr int DOT_REGS = 120;
constexpr int EPI_REGS = 136;
static_assert(DOT_REGS + EPI_REGS == 2 * 128, "the roles share the register file evenly");
// Named barriers (0 is __syncthreads).
constexpr int BAR_DOT = 1;    // the dot warps' ring steps (NT threads)
constexpr int BAR_FULL = 2;   // + buffer: a tile's template is handed over (NTP threads)
constexpr int BAR_EMPTY = 4;  // + buffer: a tile's template is taken (NTP threads)
constexpr int BAR_EPI = 6;    // the epilogue warps' own steps (NT threads)

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The dot warps' side of the overlapped loop: tmpl::walk_tiles's template dot
// of each tile through the ring (ordered among the dot warps alone), each
// tile's h then stored in stage buffer tile % 2 of h_s, once the epilogue
// warps have taken the tile two before, and announced to them. Every arrival
// is matched by a wait. Ends with no copy in flight.
template <bool VEC>
__device__ inline void dot_tiles(const tmpl::Ring<VEC>& rg, float* h_s, int n_tiles, int tm,
                                 int tn) {
  using namespace tmpl;
  float h[3][4][4];
  zero(h);
  const int nk = rg.nk;
  const int n_steps = n_tiles * nk;
#pragma unroll
  for (int st = 0; st < NSTG - 1; ++st) {
    if (st < n_steps) rg.issue(st);
    sgemm::cp_async_commit();
  }
  for (int step = 0; step < n_steps; ++step) {
    // Step `step` has landed; step - 1 is consumed, so its slot takes step + NSTG - 1.
    sgemm::cp_async_wait<NSTG - 2>();
    bar_sync(BAR_DOT, NT);
    if (step + NSTG - 1 < n_steps) rg.issue(step + NSTG - 1);
    sgemm::cp_async_commit();
    const float* as = rg.ring + (step % NSTG) * STG_FLOATS + 4 * tm;
    const float* bs = rg.ring + (step % NSTG) * STG_FLOATS + A_FLOATS + 4 * tn;
    // Each feature's operands are loaded one feature ahead of its FMAs: under
    // DOT_REGS the compiler hoists too few loads by itself (47.0 against
    // 49.2 ms at SMPL b131072).
    float4 f = *reinterpret_cast<const float4*>(bs);
    float4 cv[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) cv[c] = *reinterpret_cast<const float4*>(as + c * KT * LDA);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int kn = min(k + 1, KT - 1);
      const float4 fn = *reinterpret_cast<const float4*>(bs + kn * TB);
      float4 cn[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        cn[c] = *reinterpret_cast<const float4*>(as + (c * KT + kn) * LDA);
      const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float cw[4] = {cv[c].x, cv[c].y, cv[c].z, cv[c].w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) h[c][i][kk] = fmaf(cw[i], fv[kk], h[c][i][kk]);
      }
      f = fn;
#pragma unroll
      for (int c = 0; c < 3; ++c) cv[c] = cn[c];
    }
    if ((step + 1) % nk != 0) continue;
    const int tile = step / nk, buf = tile & 1;
    if (tile >= 2) bar_sync(BAR_EMPTY + buf, NTP);
    float* hb = h_s + buf * H_FLOATS;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(hb + (c * TV + 4 * tm + i) * LDH + 4 * tn) =
            make_float4(h[c][i][0], h[c][i][1], h[c][i][2], h[c][i][3]);
    bar_arrive(BAR_FULL + buf, NTP);
    zero(h);
  }
  sgemm::cp_async_wait<0>();
}

// tmpl::stage_shape_rows by `n_threads` threads, `tid` this one's place.
__device__ inline void stage_shape_rows_by(float* sd_s, const float* __restrict__ sd,
                                           const int* rows, int E, int Vp, int tid,
                                           int n_threads) {
  for (int idx = tid; idx < 3 * E * TV; idx += n_threads) {
    const int e = idx % E, c = (idx / E) % 3, vv = idx / (3 * E);
    const int v = rows[vv];
    sgemm::cp_async4(sd_s + (c * E + e) * SDL + vv,
                     v >= 0 ? sd + ((size_t)c * Vp + v) * E + e : sd, v >= 0);
  }
}

// Shared memory of a form, in floats: the dot's ring (none when cached), the
// template stage's two buffers (PIPE), the shape-direction stage [3][E][SDL],
// then the run's vertex rows [run][TV] (ints).
__host__ __device__ inline size_t rhs_smem_floats(bool cached, bool pipe, int E) {
  return (cached ? 0 : tmpl::RING_FLOATS) + (pipe ? 2 * H_FLOATS : 0) + 3 * E * SDL;
}

// The same with the run's vertex rows, in bytes; at most SMEM_MAX.
__host__ __device__ inline size_t rhs_smem_bytes(bool cached, bool pipe, int E,
                                                 int segs_per_block) {
  return sizeof(float) * rhs_smem_floats(cached, pipe, E) +
         sizeof(int) * (size_t)segs_per_block * TV;
}
constexpr size_t SMEM_MAX = 232448;  // an H100 block's shared memory

template <bool EMIT, bool SCALE, bool CACHED, bool W, bool VEC, bool PIPE>
__global__ void __launch_bounds__(PIPE ? NTP : NT, 1)
rhs_moments_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
                   const float* __restrict__ feat, const float* __restrict__ w,
                   const float* __restrict__ consts, const float* __restrict__ sd,
                   const float* __restrict__ om, float* __restrict__ homog,
                   const int* __restrict__ verts, const int* __restrict__ seg_offset,
                   const int* __restrict__ joints, const int* __restrict__ joint_offset,
                   float* __restrict__ part, int J, int B, int F, int E, int Vt, int Vp,
                   int n_seg, int segs_per_block) {
  static_assert(!(PIPE && CACHED), "the cached forms have no dot to overlap");
  constexpr int n_threads = PIPE ? NTP : NT;
  extern __shared__ float4 smem4[];
  float* const ring = reinterpret_cast<float*>(smem4);           // the dot's ring (not cached)
  float* const h_s = ring + (CACHED ? 0 : tmpl::RING_FLOATS);    // [2][H_FLOATS] (PIPE)
  float* const sd_s = h_s + (PIPE ? 2 * H_FLOATS : 0);           // [3][E][SDL]
  int* const rows_s = reinterpret_cast<int*>(sd_s + 3 * E * SDL);  // [run][TV]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tm = lane / 4;  // vertex group: tile rows 4 tm .. 4 tm + 3
  const int tn = 4 * (PIPE ? warp % (NT / 32) : warp) + lane % 4;  // columns 4 tn .. 4 tn + 3
  const int b0 = blockIdx.x * TB;
  const int bc = b0 + 4 * tn;
  const int s0 = blockIdx.y * segs_per_block;
  const int n_tiles = min(segs_per_block, n_seg - s0);
  const int R = rhs_rows(J, E, SCALE);
  float* const part_blk = part + (size_t)blockIdx.y * R * B;

  for (int i = threadIdx.x; i < n_tiles * TV; i += n_threads) {
    const int beg = seg_offset[s0 + i / TV], n = seg_offset[s0 + i / TV + 1] - beg;
    rows_s[i] = i % TV < n ? verts[beg + i % TV] : -1;
  }
  // The y (and yt) rows are sums over the run's tiles: zero them first.
  for (int idx = threadIdx.x; idx < 3 * J * TB * (SCALE ? 2 : 1); idx += n_threads) {
    const int row = idx / TB, b = b0 + idx % TB;
    if (b < B) part_blk[(size_t)(row < 3 * J ? row : row + E) * B + b] = 0.f;  // yt after r
  }
  __syncthreads();
  if constexpr (PIPE) {
    if (warp < NT / 32) {  // the dot warps
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(DOT_REGS));
      const tmpl::Ring<VEC> rg(ring, rows_s, feat, consts, F, B, Vp, b0);
      dot_tiles(rg, h_s, n_tiles, tm, tn);
      return;
    }
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(EPI_REGS));
  }
  // From here on, the serial loop's threads, or the overlapped loop's
  // epilogue warps (et: the thread's place among them).
  const int et = threadIdx.x - (PIPE ? NT : 0);

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
    if constexpr (PIPE) {
      stage_shape_rows_by(sd_s, sd, rows_s + tile * TV, E, Vp, et, NT);
    } else {
      tmpl::stage_shape_rows(sd_s, sd, rows_s + tile * TV, TV, E, Vp);
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
    // The shape directions are in; the previous tile's y is added.
    if constexpr (PIPE) {
      bar_sync(BAR_EPI, NT);
    } else {
      __syncthreads();
    }
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
  } else if constexpr (PIPE) {
    // Each tile's template from stage buffer tile % 2, given back as soon as
    // it is read. The wait for a tile also separates the epilogues: every
    // epilogue warp has finished the one before.
    for (int tile = 0; tile < n_tiles; ++tile) {
      const int buf = tile & 1;
      bar_sync(BAR_FULL + buf, NTP);
      const float* hb = h_s + buf * H_FLOATS;
      float h[3][4][4];
#pragma unroll
      for (int c = 0; c < 3; ++c)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 v =
              *reinterpret_cast<const float4*>(hb + (c * TV + 4 * tm + i) * LDH + 4 * tn);
          h[c][i][0] = v.x;
          h[c][i][1] = v.y;
          h[c][i][2] = v.z;
          h[c][i][3] = v.w;
        }
      if (tile + 2 < n_tiles) bar_arrive(BAR_EMPTY + buf, NTP);
      epilogue(tile, h);
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

template <bool EMIT, bool SCALE, bool CACHED, bool W, bool VEC, bool PIPE>
cudaError_t launch_variant(const Args& a, cudaStream_t stream) {
  auto kernel = rhs_moments_kernel<EMIT, SCALE, CACHED, W, VEC, PIPE>;
  const size_t smem = rhs_smem_bytes(CACHED, PIPE, a.E, a.segs_per_block);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.B + TB - 1) / TB, (a.n_seg + a.segs_per_block - 1) / a.segs_per_block);
  kernel<<<grid, PIPE ? NTP : NT, smem, stream>>>(
      a.tgt, a.pj, a.feat, a.w, a.consts, a.sd, a.om, a.homog, a.verts, a.seg_offset, a.joints,
      a.joint_offset, a.part, a.J, a.B, a.F, a.E, a.Vt, a.Vp, a.n_seg, a.segs_per_block);
  return cudaGetLastError();
}

// One loop of a form: unweighted (om null) or fit-weighted, float4 or 4-byte
// access.
template <bool EMIT, bool SCALE, bool CACHED, bool PIPE>
cudaError_t launch_loop(const Args& a, bool vec, cudaStream_t stream) {
  if (a.om == nullptr)
    return vec ? launch_variant<EMIT, SCALE, CACHED, false, true, PIPE>(a, stream)
               : launch_variant<EMIT, SCALE, CACHED, false, false, PIPE>(a, stream);
  return vec ? launch_variant<EMIT, SCALE, CACHED, true, true, PIPE>(a, stream)
             : launch_variant<EMIT, SCALE, CACHED, true, false, PIPE>(a, stream);
}

// One form: the template-dot forms by the overlapped loop or the serial one,
// the cached forms by the serial one.
template <bool EMIT, bool SCALE, bool CACHED>
cudaError_t launch_form(const Args& a, bool vec, bool overlap, cudaStream_t stream) {
  if constexpr (!CACHED) {
    if (overlap) return launch_loop<EMIT, SCALE, false, true>(a, vec, stream);
  }
  return launch_loop<EMIT, SCALE, CACHED, false>(a, vec, stream);
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
// ceil(n_seg / segs_per_block). overlap: the overlapped loop (not cached;
// shared memory at most SMEM_MAX). Requires E <= 32.
SMPL_API int rhs_moments_launch(const float* tgt, const float* pj, const float* feat,
                                const float* w, const float* consts, const float* sd,
                                const float* om, const int* verts, const int* seg_offset,
                                const int* joints, const int* joint_offset, float* r_out,
                                float* y, float* homog, float* rt, float* yt, float* sc,
                                float* part, int J, int B, int F, int E, int Vt, int Vp,
                                int n_seg, int segs_per_block, int covers, int emit_homog,
                                int scale, int cached, int overlap, cudaStream_t stream) {
  if ((emit_homog && (scale || cached)) || E > MAXE || E < 1 || covers < Vt || n_seg < 1 ||
      segs_per_block < 1 ||
      (overlap && (cached || rhs_smem_bytes(false, true, E, segs_per_block) > SMEM_MAX)))
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
  if (emit_homog) err = launch_form<true, false, false>(a, vec, overlap, stream);
  else if (cached && scale) err = launch_form<false, true, true>(a, vec, false, stream);
  else if (cached) err = launch_form<false, false, true>(a, vec, false, stream);
  else if (scale) err = launch_form<false, true, false>(a, vec, overlap, stream);
  else err = launch_form<false, false, false>(a, vec, overlap, stream);
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
