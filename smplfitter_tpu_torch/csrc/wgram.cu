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
// The TPU kernel weighted by sqrt(ω) on both Jacobian copies to save VMEM;
// here ω multiplies once, which differs by rounding only.
//
// What bounds it on an H100: f32 arithmetic. Per (vertex, column): 12J FMAs
// of the [R|t] blend, 3EJ of the translation Jacobian, 9E of the shape
// directions and 3 E1(E1+1)/2 + 7 E1 of the sums: at SMPL-X (J = 55, E = 16)
// ~3,900 FMAs, ~340 GFLOP at B = 4096, against ~0.9 GB of targets, template
// and weights.
//
// Design: a block owns 8 batch columns and a split of the vertex axis. The
// columns' [R|t] entries (12 J) and translation Jacobians (3E J) stay in
// shared memory for the whole split (112 KB at J = 55, E = 17), laid out
// (joint, column, entry) so that a thread reads its column's entries of one
// joint as float4 vectors; the J-deep blends then make one shared load per
// four FMAs. The block walks its split 32 vertices at a time, one (vertex,
// column) point per thread: each thread blends its point's 12 + 3E entries
// in registers (the skinning weights of the 32 vertices are staged in shared
// memory), forms the Jacobian and residual and stages them in shared memory,
// vertex-contiguous per column; then every thread adds the 32 vertices'
// contributions, read as float4 vectors, to the outputs it owns (a fixed set
// of (entry, column) pairs, at most 8), kept in registers over the split.
// Strides are padded so that the eight columns of a warp's loads fall in
// distinct banks. Each split writes its partials once (n_split, n_out, B); a
// second kernel sums them in split order. No atomics: runs repeat bit for
// bit. Rows at or past V and columns past B carry ω = 0 and add nothing.
#include <cuda_runtime.h>

#define SMPL_API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int NT = 256;            // threads per block
constexpr int TBW = 8;             // batch columns per block
constexpr int TVW = NT / TBW;      // vertices per pass (32)
constexpr int CS = TVW + 4;        // column stride of the staging tile (bank spread)
constexpr int RS = TBW * CS;       // row stride of the staging tile
constexpr int MAXOWN = 8;          // outputs per thread

__host__ __device__ inline int n_pairs(int E1) { return E1 * (E1 + 1) / 2; }
__host__ __device__ inline int n_outputs(int E1) { return n_pairs(E1) + 4 * E1 + 4; }

// Floats per (joint, column) of the translation Jacobians: 3E rounded up to
// a float4, and to 4 mod 8 so the eight columns of a load hit distinct banks.
__host__ __device__ inline int t4_stride(int E) {
  const int r = (3 * E + 3) / 4 * 4;
  return r % 8 == 0 ? r + 4 : r;
}

struct Smem {
  float *pj, *t4, *mu, *w, *sd, *stage;
};

__host__ __device__ inline size_t smem_floats(int J, int E, int E1) {
  return (size_t)12 * J * TBW + (size_t)t4_stride(E) * J * TBW + (size_t)(3 * E + 3) * TBW +
         (size_t)TVW * J + (size_t)TVW * 3 * E + (size_t)(3 * E1 + 4) * RS;
}

// Every part starts at a multiple of 4 floats (16 bytes) for float4 loads.
__device__ inline Smem carve(float* smem, int J, int E) {
  Smem s;
  s.pj = smem;                                // [J][TBW][12]
  s.t4 = s.pj + 12 * J * TBW;                 // [J][TBW][t4_stride(E)]
  s.mu = s.t4 + t4_stride(E) * J * TBW;       // [3E + 3][TBW]: mu rows, then mu_s
  s.w = s.mu + (3 * E + 3) * TBW;             // [TVW][J]
  s.sd = s.w + TVW * J;                       // [TVW][3E]
  s.stage = s.sd + TVW * 3 * E;               // [3 E1 + 4][TBW][CS]: jac, b, ω
  return s;
}

__device__ inline float4 ld4(const float* p, int q) {
  return reinterpret_cast<const float4*>(p)[q];
}

__device__ inline float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}

// The upper-triangle pair (e, f), e <= f, of index p in row-major order.
__device__ inline void pair_of(int p, int E1, int& e, int& f) {
  e = 0;
  while (p >= E1 - e) {
    p -= E1 - e;
    ++e;
  }
  f = e + p;
}

// One output entry's sum over the pass's TVW vertices of column c, four
// vertices per step.
__device__ inline float pass_sum(const float* stage, int entry, int c, int E1) {
  const int np = n_pairs(E1);
  const float* base = stage + c * CS;
  const float* om = base + (3 * E1 + 3) * RS;
  float s = 0.f;
  if (entry < np) {
    int e, f;
    pair_of(entry, E1, e, f);
    const float* je = base + e * RS;
    const float* jf = base + f * RS;
#pragma unroll 2
    for (int q = 0; q < TVW / 4; ++q) {
      float4 d;
      const float4 x0 = ld4(je, q), y0 = ld4(jf, q);
      const float4 x1 = ld4(je + E1 * RS, q), y1 = ld4(jf + E1 * RS, q);
      const float4 x2 = ld4(je + 2 * E1 * RS, q), y2 = ld4(jf + 2 * E1 * RS, q);
      d.x = fmaf(x2.x, y2.x, fmaf(x1.x, y1.x, x0.x * y0.x));
      d.y = fmaf(x2.y, y2.y, fmaf(x1.y, y1.y, x0.y * y0.y));
      d.z = fmaf(x2.z, y2.z, fmaf(x1.z, y1.z, x0.z * y0.z));
      d.w = fmaf(x2.w, y2.w, fmaf(x1.w, y1.w, x0.w * y0.w));
      s += dot4(ld4(om, q), d);
    }
  } else if (entry < np + 3 * E1) {  // SA[a*E1 + e]
    const float* j = base + (entry - np) * RS;
    for (int q = 0; q < TVW / 4; ++q) s += dot4(ld4(om, q), ld4(j, q));
  } else if (entry < np + 4 * E1) {  // r[e]
    const float* j = base + (entry - np - 3 * E1) * RS;
    const float* bres = base + 3 * E1 * RS;
    for (int q = 0; q < TVW / 4; ++q) {
      float4 d;
      const float4 x0 = ld4(j, q), y0 = ld4(bres, q);
      const float4 x1 = ld4(j + E1 * RS, q), y1 = ld4(bres + RS, q);
      const float4 x2 = ld4(j + 2 * E1 * RS, q), y2 = ld4(bres + 2 * RS, q);
      d.x = fmaf(x2.x, y2.x, fmaf(x1.x, y1.x, x0.x * y0.x));
      d.y = fmaf(x2.y, y2.y, fmaf(x1.y, y1.y, x0.y * y0.y));
      d.z = fmaf(x2.z, y2.z, fmaf(x1.z, y1.z, x0.z * y0.z));
      d.w = fmaf(x2.w, y2.w, fmaf(x1.w, y1.w, x0.w * y0.w));
      s += dot4(ld4(om, q), d);
    }
  } else if (entry < np + 4 * E1 + 3) {  // Sb[a]
    const float* bres = base + (3 * E1 + entry - np - 4 * E1) * RS;
    for (int q = 0; q < TVW / 4; ++q) s += dot4(ld4(om, q), ld4(bres, q));
  } else {  // W
    for (int q = 0; q < TVW / 4; ++q) {
      const float4 o = ld4(om, q);
      s += (o.x + o.y) + (o.z + o.w);
    }
  }
  return s;
}

template <int NQ>  // float4s of translation Jacobian per point: t4_stride(E) <= 4 NQ
__global__ void __launch_bounds__(NT, 1)
wgram_kernel(const float* __restrict__ tgt, const float* __restrict__ pj,
             const float* __restrict__ homog, const float* __restrict__ t4,
             const float* __restrict__ w, const float* __restrict__ sd,
             const float* __restrict__ mu, const float* __restrict__ omega,
             const float* __restrict__ mu_s, float* __restrict__ part, int J, int E, int B,
             int V, int Vp, int scale_mode, int tiles_per_block) {
  extern __shared__ __align__(16) float smem[];
  const int E1 = E + (scale_mode ? 1 : 0);
  const int n_out = n_outputs(E1);
  const int T4S = t4_stride(E);
  const Smem s = carve(smem, J, E);
  const int tid = threadIdx.x;
  const int col = tid % TBW, vl = tid / TBW;
  const int b0 = blockIdx.x * TBW;
  const int b = b0 + col;

  // The block's columns: [R|t] entries, translation Jacobians (zero past 3E),
  // centring means. Read in the global layout's order (column fastest).
  for (int idx = tid; idx < 12 * J * TBW; idx += NT) {
    const int c = idx % TBW, xj = idx / TBW;  // xj = x * J + j
    const int bb = b0 + c;
    s.pj[((xj % J) * TBW + c) * 12 + xj / J] = bb < B ? pj[(size_t)xj * B + bb] : 0.f;
  }
  for (int idx = tid; idx < T4S * J * TBW; idx += NT) {
    const int c = idx % TBW, rj = idx / TBW;  // rj = r * J + j
    const int r = rj / J, bb = b0 + c;
    s.t4[((rj % J) * TBW + c) * T4S + r] =
        (bb < B && r < 3 * E) ? t4[(size_t)rj * B + bb] : 0.f;
  }
  for (int idx = tid; idx < (3 * E + 3) * TBW; idx += NT) {
    const int row = idx / TBW, bb = b0 + idx % TBW;
    float m = 0.f;
    if (bb < B) {
      if (row < 3 * E) m = mu[(size_t)row * B + bb];
      else if (scale_mode) m = mu_s[(size_t)(row - 3 * E) * B + bb];
    }
    s.mu[idx] = m;
  }

  float acc[MAXOWN];
#pragma unroll
  for (int k = 0; k < MAXOWN; ++k) acc[k] = 0.f;

  for (int t = 0; t < tiles_per_block; ++t) {
    const int v0 = (blockIdx.y * tiles_per_block + t) * TVW;
    if (v0 >= V) break;  // uniform across the block
    __syncthreads();     // the previous pass is done with w, sd and stage
    for (int idx = tid; idx < TVW * J; idx += NT) {
      const int v = v0 + idx / J;
      s.w[idx] = v < V ? w[(size_t)v * J + idx % J] : 0.f;
    }
    for (int idx = tid; idx < TVW * 3 * E; idx += NT) {
      const int vv = idx / (3 * E), ce = idx % (3 * E);
      const int v = v0 + vv;
      s.sd[idx] = v < V ? sd[((size_t)(ce / E) * Vp + v) * E + ce % E] : 0.f;
    }
    __syncthreads();

    // This thread's point: blends, Jacobian and residual, staged. The
    // register arrays are indexed by compile-time constants only (a runtime
    // index would put them in local memory).
    const int v = v0 + vl;
    const bool ok = v < V && b < B;
    float bl[12], tb[4 * NQ];
#pragma unroll
    for (int x = 0; x < 12; ++x) bl[x] = 0.f;
#pragma unroll
    for (int r = 0; r < 4 * NQ; ++r) tb[r] = 0.f;
    const float* wrow = s.w + vl * J;
    for (int j = 0; j < J; ++j) {
      const float wv = wrow[j];
      const float* pjj = s.pj + (j * TBW + col) * 12;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 p = ld4(pjj, q);
        bl[4 * q] = fmaf(wv, p.x, bl[4 * q]);
        bl[4 * q + 1] = fmaf(wv, p.y, bl[4 * q + 1]);
        bl[4 * q + 2] = fmaf(wv, p.z, bl[4 * q + 2]);
        bl[4 * q + 3] = fmaf(wv, p.w, bl[4 * q + 3]);
      }
      const float* t4j = s.t4 + (j * TBW + col) * T4S;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        if (4 * q < 3 * E) {
          const float4 p = ld4(t4j, q);
          tb[4 * q] = fmaf(wv, p.x, tb[4 * q]);
          tb[4 * q + 1] = fmaf(wv, p.y, tb[4 * q + 1]);
          tb[4 * q + 2] = fmaf(wv, p.z, tb[4 * q + 2]);
          tb[4 * q + 3] = fmaf(wv, p.w, tb[4 * q + 3]);
        }
      }
    }
    float h[3], tg[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      h[c] = ok ? homog[((size_t)c * Vp + v) * B + b] : 0.f;
      tg[c] = ok ? tgt[((size_t)c * V + v) * B + b] : 0.f;
    }
    const float om = ok ? omega[(size_t)v * B + b] : 0.f;
    const float* sdv = s.sd + vl * 3 * E;
    float* st = s.stage + col * CS + vl;
    int a = 0, e = 0;  // r = a * E + e
#pragma unroll
    for (int r = 0; r < 4 * NQ; ++r) {
      if (r < 3 * E) {
        // Rbar[a, :], picked without a runtime index into bl.
        const float r0 = a == 0 ? bl[0] : (a == 1 ? bl[4] : bl[8]);
        const float r1 = a == 0 ? bl[1] : (a == 1 ? bl[5] : bl[9]);
        const float r2 = a == 0 ? bl[2] : (a == 1 ? bl[6] : bl[10]);
        float jv = tb[r] - s.mu[r * TBW + col];
        jv = fmaf(r0, sdv[e], jv);
        jv = fmaf(r1, sdv[E + e], jv);
        jv = fmaf(r2, sdv[2 * E + e], jv);
        st[(a * E1 + e) * RS] = jv;
        if (++e == E) {
          e = 0;
          ++a;
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float pos = fmaf(bl[a * 4], h[0], fmaf(bl[a * 4 + 1], h[1],
                        fmaf(bl[a * 4 + 2], h[2], bl[a * 4 + 3])));
      if (scale_mode)
        st[(a * E1 + E) * RS] = (scale_mode == 1 ? -tg[a] : pos) - s.mu[(3 * E + a) * TBW + col];
      st[(3 * E1 + a) * RS] = tg[a] - pos;
    }
    st[(3 * E1 + 3) * RS] = om;
    __syncthreads();

#pragma unroll
    for (int k = 0; k < MAXOWN; ++k) {
      const int idx = tid + k * NT;
      if (idx < n_out * TBW) acc[k] += pass_sum(s.stage, idx / TBW, idx % TBW, E1);
    }
  }

#pragma unroll
  for (int k = 0; k < MAXOWN; ++k) {
    const int idx = tid + k * NT;
    const int bb = b0 + idx % TBW;
    if (idx < n_out * TBW && bb < B)
      part[((size_t)blockIdx.y * n_out + idx / TBW) * B + bb] = acc[k];
  }
}

// Sums the split partials in split order and scatters them: G mirrored.
__global__ void wgram_split_sum_kernel(const float* __restrict__ part, float* __restrict__ G,
                                       float* __restrict__ SA, float* __restrict__ r,
                                       float* __restrict__ Sb, float* __restrict__ W,
                                       int n_splits, int E1, int B) {
  const int n_out = n_outputs(E1), np = n_pairs(E1);
  const size_t n = (size_t)n_out * B;
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < n;
       idx += (size_t)gridDim.x * blockDim.x) {
    float sum = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) sum += part[(size_t)sp * n + idx];
    const int entry = (int)(idx / B);
    const size_t bb = idx % B;
    if (entry < np) {
      int e, f;
      pair_of(entry, E1, e, f);
      G[(size_t)(e * E1 + f) * B + bb] = sum;
      G[(size_t)(f * E1 + e) * B + bb] = sum;
    } else if (entry < np + 3 * E1) {
      SA[(size_t)(entry - np) * B + bb] = sum;
    } else if (entry < np + 4 * E1) {
      r[(size_t)(entry - np - 3 * E1) * B + bb] = sum;
    } else if (entry < np + 4 * E1 + 3) {
      Sb[(size_t)(entry - np - 4 * E1) * B + bb] = sum;
    } else {
      W[bb] = sum;
    }
  }
}

template <int NQ>
cudaError_t launch_wgram(const float* tgt, const float* pj, const float* homog, const float* t4,
                         const float* w, const float* sd, const float* mu, const float* omega,
                         const float* mu_s, float* part, int J, int E, int B, int V, int Vp,
                         int scale_mode, int tiles_per_block, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(wgram_kernel<NQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (V + TVW - 1) / TVW;
  dim3 grid((B + TBW - 1) / TBW, (n_tiles + tiles_per_block - 1) / tiles_per_block);
  wgram_kernel<NQ><<<grid, NT, smem, stream>>>(tgt, pj, homog, t4, w, sd, mu, omega, mu_s,
                                                 part, J, E, B, V, Vp, scale_mode,
                                                 tiles_per_block);
  return cudaGetLastError();
}

}  // namespace

SMPL_API size_t wgram_smem_bytes(int J, int E, int scale) {
  return sizeof(float) * smem_floats(J, E, E + (scale ? 1 : 0));
}

// tgt (3, V, B), pj (12, J, B), homog (3, Vp, B), t4 (3E, J, B), w (Vp, J),
// sd (3, Vp, E), mu (3E, B), omega (V, B), mu_s (3, B) when scale_mode ->
// G (E1^2, B), SA (3E1, B), r (E1, B), Sb (3, B), W (1, B), E1 = E + (scale_mode
// != 0). part is scratch of n_splits * n_out * B floats, n_out =
// E1 (E1 + 1) / 2 + 4 E1 + 4, n_splits = ceil(ceil(V / 32) / tiles_per_block).
// Requires E <= 17 (and E1 (E1 + 1) / 2 + 4 E1 + 4 <= 256).
SMPL_API int wgram_launch(const float* tgt, const float* pj, const float* homog,
                          const float* t4, const float* w, const float* sd, const float* mu,
                          const float* omega, const float* mu_s, float* part, float* G,
                          float* SA, float* r, float* Sb, float* W, int J, int E, int B, int V,
                          int Vp, int scale_mode, int tiles_per_block, cudaStream_t stream) {
  const int E1 = E + (scale_mode ? 1 : 0);
  if (E > 17 || n_outputs(E1) * TBW > MAXOWN * NT || (scale_mode && mu_s == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = wgram_smem_bytes(J, E, scale_mode != 0);
  const cudaError_t err =
      t4_stride(E) <= 36
          ? launch_wgram<9>(tgt, pj, homog, t4, w, sd, mu, omega, mu_s, part, J, E, B, V, Vp,
                            scale_mode, tiles_per_block, smem, stream)
          : launch_wgram<13>(tgt, pj, homog, t4, w, sd, mu, omega, mu_s, part, J, E, B, V, Vp,
                             scale_mode, tiles_per_block, smem, stream);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (V + TVW - 1) / TVW;
  const int n_splits = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  const size_t n = (size_t)n_outputs(E1) * B;
  const int threads = 256;
  wgram_split_sum_kernel<<<(int)((n + threads - 1) / threads), threads, 0, stream>>>(
      part, G, SA, r, Sb, W, n_splits, E1, B);
  return (int)cudaGetLastError();
}
