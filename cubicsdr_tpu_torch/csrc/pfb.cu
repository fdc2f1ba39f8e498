// PFBCH2 polyphase analyzer — CUDA kernel for Hopper (sm_90a).
//
// Replaces: cubicsdr_tpu/ops/pallas/pfb.py, pfbch2_planar_pallas (the
// Pallas TPU kernel `_kernel`). Computes, for a planar complex stream
// z[hist + L] (hist = (2J-1)*D, D = M/2) and output step s:
//
//   u[rho, s] = sum_j h[rho, j] * z[(s + 2(J-1-j))*D + M-1-rho]   (FIR)
//   y[k, s]   = c_k * sum_rho W[k, rho] * u[rho, s]               (M*IDFT)
//   y[k, s]  *= (-1)^(k * (s + parity))                            (flip)
//
// with W = e^{+2 pi i k rho / M} and c_k = e^{-2 pi i k (D-1) / M}, exactly
// the XLA formulation of ChannelizerPFB2 (frames -> fir -> pc_idft_m ->
// pc_mul(c) -> sign). The step parity is read from device memory, so the
// carried stream parity works for odd step counts too.
//
// What bounds it on the H100: per output step it reads D complex samples
// (8*D bytes) and writes M complex outputs (8*M bytes). At M=16 that is
// 24.6 MB per 1,024,000-sample block, 7.3 us at 3.35 TB/s, against ~5 us
// of f32 work even as a dense DFT: DRAM traffic is the floor.
//
// Design (one kernel, `pfbch2_kernel<M, J>`, for every even M and J):
// - Persistent blocks walk tiles of T steps (T = 128, or 64/32 where a
//   large M would not leave two blocks per SM; `pfb_plan` in
//   ops/kernels/pfb.py picks it). Each tile's (T + 2J - 1)*D-sample window
//   of both planes is staged with 16-byte cp.async into a two-stage ring:
//   the next tile's window is in flight while this one computes, so the
//   DRAM read overlaps the FIR and the transform.
// - FIR in registers. For branch rho, u[rho, s] is a J-tap FIR on the
//   stride-D stream x_rho. A thread owns (rho, 8 consecutive steps): with
//   J = 8 (the channelizer's) it loads the 8 + 2J - 2 samples it needs and
//   its J taps into registers and does 16*J FMAs from them; other J walk
//   the taps in a runtime loop.
// - The branch sums go through a [T][M+1] float2 shared tile (odd row
//   stride: conflict free). The transform then runs in one of two forms,
//   both true f32 FMAs on the CUDA cores, never TF32, in another summation
//   order than the plain version's, within its 2e-4 tolerance:
//     * in registers, for power-of-two M up to 64 and other even M up
//       to 16 (J = 8; M is a template argument): one thread per step, its
//       M branch sums in registers, the constants folded on the host
//       (`pfb_transform_consts`) and held in the kernel's parameter space
//       (compile-time offsets, so each FMA reads its constant directly).
//       Power-of-two M runs a radix-2 decimation-in-time FFT with
//       twiddles e^{+2 pi i j/M} (j < M/2), then c_k: (M/2) log2 M
//       butterflies instead of M^2 complex MACs (M=16: 32 against 256).
//       Other M (6, 10, 12, 14: 2.4-7 MS/s sources) run the DFT with
//       F[k][rho] = c_k W[k][rho];
//     * every other M (18, 20, 40, ...; runtime M): a register-tiled
//       complex product with F[k][rho] = c_k W[k][rho], folded once per
//       block from the channelizer's (w, c) into shared memory. A warp
//       owns 4 outputs, each lane 2 steps (lane + 32 i): per branch 2
//       branch-sum loads and 4 broadcast F loads feed 8 complex MACs.
// - Large M (134-400: captures above 66 MS/s), where F (2 M^2 floats)
//   and a double-buffered window no longer fit one block: the window is
//   single-buffered (the next tile's loads are issued once the FIR has
//   read it, so they overlap the transform), and the transform is tiled
//   over blocks of KB output channels: each block folds its [KB][M] slice
//   of F from (w, c), which L2 holds, and then runs the product on it
//   (`pfb_plan` picks T, the stages and KB; the fold is 1/T of the
//   product's work). The summation order per output is unchanged.
// - The parity flip is applied at the store; each channel row is written
//   by consecutive threads on consecutive steps (coalesced).

#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kFR = 8;          // steps per FIR item
constexpr int kThreads = 128;
constexpr int kFastJ = 8;
constexpr int kMaxFft = 64;     // largest power-of-two M with the FFT form
constexpr int kMaxDft = 16;     // largest other M with the register DFT
constexpr int kMaxConsts = 2 * kMaxDft * kMaxDft;
constexpr int kQT = 4;          // outputs per warp item (product form)
constexpr int kST = 2;          // steps per lane (product form)
constexpr size_t kSmemMax = 232448;
constexpr int kMaxDevices = 64;

struct PfbConsts {
  float v[kMaxConsts];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ constexpr bool is_pow2(int m) {
  return m > 0 && (m & (m - 1)) == 0;
}
__host__ __device__ constexpr int bitrev(int i, int m) {
  int r = 0;
  for (int b = 1; b < m; b <<= 1) r = (r << 1) | ((i & b) ? 1 : 0);
  return r;
}

// One radix-2 DIT stage of butterfly span LEN over a[M] (bit-reversed
// input); twiddle w^j = e^{+2 pi i j/M} at k.v[2j], k.v[2j+1].
template <int M, int LEN>
__device__ __forceinline__ void fft_stages(float (&ar)[M], float (&ai)[M],
                                           const PfbConsts& k) {
  if constexpr (LEN <= M) {
    constexpr int half = LEN / 2;
    constexpr int stride = M / LEN;
#pragma unroll
    for (int i = 0; i < M; i += LEN) {
#pragma unroll
      for (int j = 0; j < half; ++j) {
        const int a = i + j, b = a + half, w = j * stride;
        float tr, ti;
        if (w == 0) {
          tr = ar[b];
          ti = ai[b];
        } else if (4 * w == M) {          // w^{M/4} = +i
          tr = -ai[b];
          ti = ar[b];
        } else {
          const float wr = k.v[2 * w], wi = k.v[2 * w + 1];
          tr = wr * ar[b] - wi * ai[b];
          ti = wr * ai[b] + wi * ar[b];
        }
        ar[b] = ar[a] - tr;
        ai[b] = ai[a] - ti;
        ar[a] = ar[a] + tr;
        ai[a] = ai[a] + ti;
      }
    }
    fft_stages<M, 2 * LEN>(ar, ai, k);
  }
}

// y[q] = c_q * sum_rho W[q, rho] u[rho], in place over (ar, ai), for
// power-of-two M: bit reversal (register renaming), the FFT, then c_q at
// k.v[M + 2q].
template <int M>
__device__ __forceinline__ void fft_transform(float (&ar)[M], float (&ai)[M],
                                              const PfbConsts& k) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const int j = bitrev(i, M);
    if (j > i) {
      const float tr = ar[i], ti = ai[i];
      ar[i] = ar[j];
      ai[i] = ai[j];
      ar[j] = tr;
      ai[j] = ti;
    }
  }
  fft_stages<M, 2>(ar, ai, k);
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const float cr = k.v[M + 2 * q], ci = k.v[M + 2 * q + 1];
    const float yr = ar[q] * cr - ai[q] * ci;
    const float yi = ar[q] * ci + ai[q] * cr;
    ar[q] = yr;
    ai[q] = yi;
  }
}

// y[q] = sum_rho F[q, rho] u[rho] for other even M, F (c_k folded in)
// row-major at k.v[2(q*M + rho)], in place over (ar, ai).
template <int M>
__device__ __forceinline__ void dft_transform(float (&ar)[M], float (&ai)[M],
                                              const PfbConsts& k) {
  float yr[M], yi[M];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    float sr = 0.f, si = 0.f;
#pragma unroll
    for (int rho = 0; rho < M; ++rho) {
      const float fr = k.v[2 * (q * M + rho)];
      const float fi = k.v[2 * (q * M + rho) + 1];
      sr = fmaf(fr, ar[rho], sr);
      sr = fmaf(-fi, ai[rho], sr);
      si = fmaf(fr, ai[rho], si);
      si = fmaf(fi, ar[rho], si);
    }
    yr[q] = sr;
    yi[q] = si;
  }
#pragma unroll
  for (int q = 0; q < M; ++q) {
    ar[q] = yr[q];
    ai[q] = yi[q];
  }
}

struct Geo {
  long z_len;
  int M, J, D, T;
  int win;        // floats per plane of a staged window
  int n_steps, n_tiles;
  int stages;     // staged windows: 2 (ring) or 1 (reloaded after the FIR)
  int KB;         // rows of F held at once (product form; M: folded once)
};

// Stage tile `tile`'s window of both planes into win_re/win_im.
__device__ __forceinline__ void stage_window(const float* z_re,
                                             const float* z_im, const Geo& g,
                                             int tile, float* win_re,
                                             float* win_im) {
  const long base = (long)tile * g.T * g.D;   // 16-byte aligned: T*D*4
  for (int c = threadIdx.x; c < g.win / 4; c += blockDim.x) {
    const long p0 = base + 4L * c;
    long valid = g.z_len - p0;
    valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
    const long e = valid ? p0 : 0;
    cp_async16(win_re + 4 * c, z_re + e, (int)valid * 4);
    cp_async16(win_im + 4 * c, z_im + e, (int)valid * 4);
  }
  cp_async_commit();
}

// M_ > 0: M at compile time, transform in registers (FFT for power-of-two
// M, else DFT); M_ = 0: runtime M, product form.
// J_ > 0: the FIR's tap count at compile time; J_ = 0: runtime J.
template <int M_, int J_>
__global__ void __launch_bounds__(kThreads)
pfbch2_kernel(const float* __restrict__ z_re, const float* __restrict__ z_im,
              const float* __restrict__ h,       // [M, J]
              const float* __restrict__ w_re,    // [M, M]
              const float* __restrict__ w_im,
              const float* __restrict__ c_re,    // [M]
              const float* __restrict__ c_im,
              const int* __restrict__ parity,
              float* __restrict__ out_re,        // [M, n_steps]
              float* __restrict__ out_im, Geo g, const PfbConsts k) {
  const int M = M_ > 0 ? M_ : g.M;
  const int J = J_ > 0 ? J_ : g.J;
  const int D = M / 2;
  const int T = g.T;
  const int U1 = M + 1;
  extern __shared__ __align__(16) float smem[];
  float* win = smem;                          // [stages][re, im][win]
  float2* u = reinterpret_cast<float2*>(smem + 2 * g.stages * g.win);
  float2* F = u + T * U1;                     // [KB][M], product form
  float* sh = reinterpret_cast<float*>(F + (M_ > 0 ? 0 : g.KB * M));  // [M][J]

  int tile = blockIdx.x;
  if (tile >= g.n_tiles) return;
  stage_window(z_re, z_im, g, tile, win, win + g.win);
  for (int i = threadIdx.x; i < M * J; i += blockDim.x) sh[i] = h[i];
  // F rows [k0, k0 + nk) into F[0 .. nk).
  auto fold = [&](int k0, int nk) {
    for (int i = threadIdx.x; i < nk * M; i += blockDim.x) {
      const int q = k0 + i / M;
      const float cr = c_re[q], ci = c_im[q];
      const float wr = w_re[k0 * M + i], wi = w_im[k0 * M + i];
      F[i] = make_float2(cr * wr - ci * wi, cr * wi + ci * wr);
    }
  };
  if constexpr (M_ == 0) {
    if (g.KB == M) fold(0, M);
  }
  const int par = *parity;

  for (int it = 0;; ++it) {
    const int next = tile + gridDim.x;
    if (g.stages == 2 && next < g.n_tiles) {
      float* w = win + ((it + 1) & 1) * 2 * g.win;
      stage_window(z_re, z_im, g, next, w, w + g.win);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* xr = win + (g.stages == 2 ? (it & 1) : 0) * 2 * g.win;
    const float* xi = xr + g.win;

    // FIR: item = (rho, 8 steps), rho fastest.
    for (int item = threadIdx.x; item < M * (T / kFR); item += blockDim.x) {
      const int rho = item % M;
      const int s0 = (item / M) * kFR;
      const float* pr = xr + s0 * D + M - 1 - rho;   // x_rho[s0]
      const float* pi = xi + s0 * D + M - 1 - rho;
      float ar[kFR], ai[kFR];
      if constexpr (J_ > 0) {
        constexpr int NX = kFR + 2 * J_ - 2;
        float hr[J_], x_r[NX], x_i[NX];
#pragma unroll
        for (int j = 0; j < J_; ++j) hr[j] = sh[rho * J_ + j];
#pragma unroll
        for (int q = 0; q < NX; ++q) {
          x_r[q] = pr[q * D];
          x_i[q] = pi[q * D];
        }
#pragma unroll
        for (int t = 0; t < kFR; ++t) {
          ar[t] = ai[t] = 0.f;
#pragma unroll
          for (int j = 0; j < J_; ++j) {
            ar[t] = fmaf(hr[j], x_r[t + 2 * (J_ - 1 - j)], ar[t]);
            ai[t] = fmaf(hr[j], x_i[t + 2 * (J_ - 1 - j)], ai[t]);
          }
        }
      } else {
#pragma unroll
        for (int t = 0; t < kFR; ++t) ar[t] = ai[t] = 0.f;
        for (int j = 0; j < J; ++j) {
          const float hj = sh[rho * J + j];
          const int o = 2 * (J - 1 - j);
#pragma unroll
          for (int t = 0; t < kFR; ++t) {
            ar[t] = fmaf(hj, pr[(t + o) * D], ar[t]);
            ai[t] = fmaf(hj, pi[(t + o) * D], ai[t]);
          }
        }
      }
#pragma unroll
      for (int t = 0; t < kFR; ++t)
        u[(s0 + t) * U1 + rho] = make_float2(ar[t], ai[t]);
    }
    __syncthreads();
    // One stage: the FIR has read the window, so the next tile's loads go
    // out now and overlap the transform.
    if (g.stages == 1 && next < g.n_tiles)
      stage_window(z_re, z_im, g, next, win, win + g.win);

    if constexpr (M_ > 0) {
      // Transform in registers, c_k and the parity flip: one step per
      // thread.
      for (int t = threadIdx.x; t < T; t += blockDim.x) {
        const int s = tile * T + t;
        if (s >= g.n_steps) break;
        float ar[M_], ai[M_];
#pragma unroll
        for (int rho = 0; rho < M_; ++rho) {
          const float2 v = u[t * U1 + rho];
          ar[rho] = v.x;
          ai[rho] = v.y;
        }
        if constexpr (is_pow2(M_))
          fft_transform<M_>(ar, ai, k);
        else
          dft_transform<M_>(ar, ai, k);
        const bool odd = (s + par) & 1;
#pragma unroll
        for (int q = 0; q < M_; ++q) {
          const bool neg = (q & 1) && odd;
          out_re[(long)q * g.n_steps + s] = neg ? -ar[q] : ar[q];
          out_im[(long)q * g.n_steps + s] = neg ? -ai[q] : ai[q];
        }
      }
    } else {
      // Product form: warp item = kQT outputs x (32 * kST) steps; lane
      // owns steps lane + 32 i.
      const int lane = threadIdx.x & 31;
      const int n_sg = (T + 32 * kST - 1) / (32 * kST);
      for (int k0 = 0; k0 < M; k0 += g.KB) {
        const int nk = min(g.KB, M - k0);
        if (g.KB < M) {        // this block of F: after the last one is read
          __syncthreads();
          fold(k0, nk);
          __syncthreads();
        }
        const int n_q = (nk + kQT - 1) / kQT;
        for (int item = threadIdx.x / 32; item < n_q * n_sg;
             item += blockDim.x / 32) {
          const int q0 = k0 + (item % n_q) * kQT;
          const int t0 = (item / n_q) * 32 * kST + lane;
          float2 acc[kST][kQT];
#pragma unroll
          for (int i = 0; i < kST; ++i)
#pragma unroll
            for (int j = 0; j < kQT; ++j) acc[i][j] = make_float2(0.f, 0.f);
          for (int rho = 0; rho < M; ++rho) {
            float2 uv[kST], f[kQT];
#pragma unroll
            for (int i = 0; i < kST; ++i) {
              const int t = t0 + 32 * i;
              uv[i] = t < T ? u[t * U1 + rho] : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int j = 0; j < kQT; ++j)
              f[j] = F[(min(q0 + j, k0 + nk - 1) - k0) * M + rho];
#pragma unroll
            for (int i = 0; i < kST; ++i)
#pragma unroll
              for (int j = 0; j < kQT; ++j) {
                acc[i][j].x = fmaf(f[j].x, uv[i].x, acc[i][j].x);
                acc[i][j].x = fmaf(-f[j].y, uv[i].y, acc[i][j].x);
                acc[i][j].y = fmaf(f[j].x, uv[i].y, acc[i][j].y);
                acc[i][j].y = fmaf(f[j].y, uv[i].x, acc[i][j].y);
              }
          }
#pragma unroll
          for (int i = 0; i < kST; ++i) {
            const int t = t0 + 32 * i;
            const int s = tile * T + t;
            if (t >= T || s >= g.n_steps) continue;
            const bool odd = (s + par) & 1;
#pragma unroll
            for (int j = 0; j < kQT; ++j) {
              const int q = q0 + j;
              if (q >= k0 + nk) continue;
              const bool neg = (q & 1) && odd;
              const float2 v = acc[i][j];
              out_re[(long)q * g.n_steps + s] = neg ? -v.x : v.x;
              out_im[(long)q * g.n_steps + s] = neg ? -v.y : v.y;
            }
          }
        }
      }
    }
    tile = next;
    if (tile >= g.n_tiles) break;
  }
}

template <int M_, int J_>
int launch(const float* z_re, const float* z_im, const float* h,
           const float* w_re, const float* w_im, const float* c_re,
           const float* c_im, const int* parity, float* out_re,
           float* out_im, const Geo& g, const PfbConsts& k,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * (size_t)g.stages * g.win
                       + 2 * (size_t)g.T * (g.M + 1)
                       + (M_ > 0 ? 0 : 2 * (size_t)g.KB * g.M)
                       + (size_t)g.M * g.J);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // The attribute is per device: set it once on each device launched on.
  static bool attr_set[kMaxDevices] = {};
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        pfbch2_kernel<M_, J_>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pfbch2_kernel<M_, J_>,
                                                kThreads, smem);
  if (per_sm < 1) per_sm = 1;
  int grid = n_sm * per_sm;
  if (grid > g.n_tiles) grid = g.n_tiles;
  pfbch2_kernel<M_, J_><<<grid, kThreads, smem, stream>>>(
      z_re, z_im, h, w_re, w_im, c_re, c_im, parity, out_re, out_im, g, k);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` with T steps per tile, `stages` staged windows (2 or
// 1) and KB rows of F per fold (product form; 1 <= KB <= M), as
// `pfb_plan` gives them. `consts` (host
// memory, `n_consts` floats) is the register form's folded table
// (`pfb_transform_consts`): required where that form runs (J = 8 and
// power-of-two M <= 64 or even M <= 16), ignored otherwise. Returns a
// cudaError_t.
extern "C" int pfbch2_planar_launch(
    const float* z_re, const float* z_im, long z_len, const float* h,
    const float* w_re, const float* w_im, const float* c_re,
    const float* c_im, const float* consts, int n_consts,
    const int* parity, float* out_re, float* out_im, int M, int J,
    int n_steps, int T, int stages, int KB, void* stream) {
  if (M < 2 || M % 2 || J < 1 || T < 32 || T % 32 || T > 128
      || (stages != 1 && stages != 2) || KB < 1 || KB > M)
    return (int)cudaErrorInvalidValue;
  Geo g;
  g.z_len = z_len;
  g.M = M;
  g.J = J;
  g.D = M / 2;
  g.T = T;
  g.win = ((T + 2 * J - 1) * g.D + 3) / 4 * 4;
  g.n_steps = n_steps;
  g.n_tiles = (n_steps + T - 1) / T;
  g.stages = stages;
  g.KB = KB;
  PfbConsts k;
  memset(&k, 0, sizeof(k));
  cudaStream_t s = (cudaStream_t)stream;
#define CUBICSDR_PFB_LAUNCH(m, j)                                         \
  launch<m, j>(z_re, z_im, h, w_re, w_im, c_re, c_im, parity, out_re,     \
               out_im, g, k, s)
  if (J == kFastJ && (M <= kMaxDft || (is_pow2(M) && M <= kMaxFft))) {
    if (n_consts != (is_pow2(M) ? 3 * M : 2 * M * M))
      return (int)cudaErrorInvalidValue;
    memcpy(k.v, consts, sizeof(float) * (size_t)n_consts);
    switch (M) {
      case 2: return CUBICSDR_PFB_LAUNCH(2, kFastJ);
      case 4: return CUBICSDR_PFB_LAUNCH(4, kFastJ);
      case 6: return CUBICSDR_PFB_LAUNCH(6, kFastJ);
      case 8: return CUBICSDR_PFB_LAUNCH(8, kFastJ);
      case 10: return CUBICSDR_PFB_LAUNCH(10, kFastJ);
      case 12: return CUBICSDR_PFB_LAUNCH(12, kFastJ);
      case 14: return CUBICSDR_PFB_LAUNCH(14, kFastJ);
      case 16: return CUBICSDR_PFB_LAUNCH(16, kFastJ);
      case 32: return CUBICSDR_PFB_LAUNCH(32, kFastJ);
      case 64: return CUBICSDR_PFB_LAUNCH(64, kFastJ);
    }
  }
  if (J == kFastJ) return CUBICSDR_PFB_LAUNCH(0, kFastJ);
  return CUBICSDR_PFB_LAUNCH(0, 0);
#undef CUBICSDR_PFB_LAUNCH
}

// Message for a CUDA error code returned by any launch function here.
extern "C" const char* cubicsdr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
