// Fused route + NCO shift + rational resample — CUDA kernel for Hopper
// (sm_90a).
//
// Replaces: cubicsdr_tpu/ops/pallas/route.py,
// routed_shifted_resample_pallas (the Pallas TPU kernel `_kernel` /
// `_one_tile`). For demod n and output tile g (O outputs, input stride
// S = (O/P)*Q, window W = (O/P - 1)*Q + KK), with the window
// w[i] = z[chan_idx[n], start + g*S + i]:
//
//   xm[i]      = w[i] * E[i],     E[i] = e^{+i mod(omega_n i, 2pi)}
//   y[m]       = sum_t ker[r, t] * xm[lb*Q + KK-1-t],   m = lb*P + r
//   out[n, gO+m] = y[m] * e^{+i phi},
//   phi = mod(pw0_n + a64*(g/64) + a1*(g%64), 2pi),
//   a1 = mod(omega_n S, 2pi), a64 = mod(64 a1, 2pi)
//
// The channel is indexed directly (the TPU kernel's one-hot matmul and
// bf16 splits were MXU workarounds). The phase bookkeeping (window-local
// modulation, split pre-wrapped tile increments a1/a64) is kept exactly,
// rounded as the reference's float32 expressions round: it is about
// float32 accuracy.
//
// What bounds it on the H100: the f32 FMAs of the polyphase filter on the
// CUDA cores (120 nonzero taps on both planes per output on the 8 MS/s,
// 200 kHz FM path: 3.3 GFLOP per block at 256 demods, 50 us at 67
// TFLOP/s), and at 16 demods the DRAM traffic (16.4 MB of channels in,
// 8 bytes per output out: 5.9 us). A filter that reads its samples and
// taps from shared memory for every FMA runs at the shared-memory port's
// rate instead, about 1/6 of the f32 peak.
//
// Design:
// - Polyphase register tiling. With t = KK-1 - (a*Q + c), output phase r
//   is y[lb] = sum_c sum_a kp[r][c][a] * x_c[lb + a], where
//   x_c[m] = xm[m*Q + c] is the stride-Q sub-stream of residue c and
//   kp[r][c][a] = ker[r, KK-1 - a*Q - c] (0 past the kernel). The host
//   lays kp out as [P][Q][A] with A = ceil(KK/Q) rounded up to the unroll
//   U (`route_taps` in ops/kernels/route.py). A thread owns R = 8
//   consecutive lb of one phase r and keeps its R + A window of x_c in
//   registers (fully unrolled for the FM path's tap counts), so one
//   shared load of a sample (float2) and a quarter of a tap load (float4
//   broadcast) feed R complex MACs.
// - Bank-conflict-free decimated rows for any Q: sample m of a residue
//   row sits at m + m/R, so the R-strided thread windows of a half-warp
//   start on distinct banks whatever Q is.
// - Modulation in the kernel. A block owns one demod and a contiguous run
//   of its tiles. It builds E (in the decimated layout), a1 and a64 once;
//   the wrapper launches this kernel and nothing else. Each tile's window
//   is modulated once into the decimated rows (the reference's
//   window-local rounding of E forbids folding E into the taps).
// - Pipelined loads. The block walks its tiles in batches of TB (as many
//   tiles as its 128 threads cover). The raw span of a batch (TB*S + W-S
//   samples of the channel, both planes) is staged with 16-byte cp.async;
//   once a batch is modulated into the decimated rows, the next batch's
//   span is in flight while this one computes.
// - Shared memory by plan. The host (`route_plan` in ops/kernels/route.py)
//   picks TB, the residues per pass CQ, the residue groups RS and whether
//   the E table stays resident, so the block fits the 227 KB an sm_90
//   block may hold: the FM path (Q = 5) keeps TB = 8, all residues and E
//   (104 KB). Large Q (NBFM: Q = 40, 64) has room for one tile per batch,
//   whose 16 output threads would leave an SM nearly idle: RS groups of
//   them (up to 256 threads) split the tile's residues (group k takes
//   every RS-th row of a pass) and add their partial sums at the end.
//   The residues are walked in passes of CQ rows, each modulated by all
//   groups, then filtered; where even E does not fit, each pass computes
//   E as the table would.
// - Streaming plan, where not even one tile's window fits (Q = 307-3413:
//   NBFM at the RTL-SDR's 1.024, 1.4 and 2.56 MS/s, the digital modems
//   at 30.72 MS/s; W up to 477,819 samples per plane). One tile per
//   batch; nothing of the window is staged: each pass reads the samples
//   of its CQ residues straight from global memory into the decimated
//   rows (consecutive threads on consecutive residues of one decimated
//   sample, so the reads of a warp are contiguous), and stages only those
//   CQ rows of the taps. The output tile O stays the reference's.
// - Coalesced, vectorised stores (float4 when P == 1).
// No tensor cores: true f32 FMAs. The grid gives every SM its resident
// blocks at 16 demods and at 256 alike.
//
// Where it stands (PERF.md): at 256 demods about a quarter of the FMA
// bound. The modulation pass and the filter are separated by
// barriers and, at 104 KB of shared memory per block, an SM holds 8 warps,
// which sit in the same phase between the barriers of a batch.

#include <cuda_runtime.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;
constexpr int kR = 8;            // outputs (lb) per thread
constexpr int kMaxThreads = 256;  // threads per block, at most
constexpr int kMod = 4;          // samples per thread per modulation step

// Floor-mod, the semantics of torch.remainder / jnp.mod.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.f && ((r < 0.f) != (y < 0.f))) r += y;
  return r;
}

// Position of decimated sample m in its shared-memory row.
__device__ __forceinline__ int skew(int m) {
  return m + (int)((unsigned)m / kR);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

struct Geo {
  long total;       // samples per channel row (history included)
  int n_rows;       // output tiles per demod
  int tiles_per_block;
  int O, P, Q, A, S, W, start;
  int A4;           // tap row stride in shared memory: A rounded up to 4
  int TB;           // tiles per batch
  int RS;           // residue groups: thread groups that split a tile's
                    // residues and reduce their partial sums
  int CQ;           // residue rows modulated and filtered per pass
  int keep_e;       // 1: the E table is resident; 0: each pass computes E
  int rows_len;     // float2 of the decimated rows (and the reduction)
  int G;            // R-groups per output phase: ceil((O/P)/R)
  int Lrow;         // decimated samples per residue row: G*R + A
  int row_stride;   // float2 per skewed row
  int raw_len;      // floats per plane of the raw staging span
  int ed_len;       // float2 of the E table (0 when not resident)
  int stream;       // 1: the window is read from global memory per pass
                    // and the taps staged per pass (TB = 1, raw_len = 0)
};

// e^{+i mod(omega i, 2pi)}, rounded as the reference's float32 tensor
// expression omega*i (`_tables`).
__device__ __forceinline__ float2 modulation(float om, int i) {
  float sn, cs;
  sincosf(floor_mod(__fmul_rn(om, (float)i), kTwoPi), &sn, &cs);
  return make_float2(cs, sn);
}

// Stage the raw span of tiles [g0, g0+TB) of channel row `row` into
// raw_re/raw_im with 16-byte cp.async (zero-filled past the row's end);
// returns the offset of the span's first sample in the staged buffer.
__device__ __forceinline__ int stage_raw(const float* z_re, const float* z_im,
                                         long row, int g0, const Geo& q,
                                         float* raw_re, float* raw_im) {
  const long off = (long)q.start + (long)g0 * q.S;
  const long ga = row + off;
  const long a0 = ga & ~3L;
  const int delta = (int)(ga - a0);
  for (int k = threadIdx.x; k < q.raw_len / 4; k += blockDim.x) {
    const long p0 = off - delta + 4L * k;    // row-relative first sample
    long valid = q.total - p0;
    valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
    const long e = valid ? a0 + 4L * k : 0;
    cp_async16(raw_re + 4 * k, z_re + e, (int)valid * 4);
    cp_async16(raw_im + 4 * k, z_im + e, (int)valid * 4);
  }
  cp_async_commit();
  return delta;
}

// One residue c of a thread's R outputs: ar/ai[j] += sum_a tc[a] *
// x_c[lb0 + j + a]. `xc` points at x_c[lb0] in its skewed row, so sample
// lb0 + q sits at xc[q + q/R] (lb0 is a multiple of R). With NCH > 0 the
// tap count A = NCH*U is known here: the whole R + A window is loaded
// once and the loop is unrolled, so the window slides by register
// renaming and the loads are scheduled ahead of the FMAs. NCH = 0 walks
// runtime A in chunks of U, shifting the window in registers.
template <int U, int NCH>
__device__ __forceinline__ void fir_residue(const float2* __restrict__ xc,
                                            const float* __restrict__ tc,
                                            int A, float (&ar)[kR],
                                            float (&ai)[kR]) {
  if constexpr (NCH > 0) {
    constexpr int NA = NCH * U;
    float2 x[kR + NA];
#pragma unroll
    for (int q = 0; q < kR + NA; ++q) x[q] = xc[q + q / kR];
    float4 t4[(NA + 3) / 4];        // taps: one broadcast load per 4
#pragma unroll
    for (int v = 0; v < (NA + 3) / 4; ++v)
      t4[v] = reinterpret_cast<const float4*>(tc)[v];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      const float4 tv = t4[a / 4];
      const float t = (a % 4 == 0) ? tv.x : (a % 4 == 1) ? tv.y
                      : (a % 4 == 2) ? tv.z : tv.w;
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        ar[j] = fmaf(t, x[j + a].x, ar[j]);
        ai[j] = fmaf(t, x[j + a].y, ai[j]);
      }
    }
  } else {
    float2 buf[kR + U];
#pragma unroll
    for (int j = 0; j < kR; ++j) buf[j] = xc[j + j / kR];
    for (int a0 = 0; a0 < A; a0 += U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int q = a0 + kR + u;
        buf[kR + u] = xc[q + q / kR];
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float t = tc[a0 + u];
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          ar[j] = fmaf(t, buf[j + u].x, ar[j]);
          ai[j] = fmaf(t, buf[j + u].y, ai[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < kR; ++j) buf[j] = buf[j + U];
    }
  }
}

// Modulate residues c0..c1-1 of one tile's window (wr, wi) into its
// decimated rows (zeros past W), E from the resident table or computed as
// the table would be. Loads of kMod samples are issued before any of
// their stores: a shared store may alias a later shared load, so
// interleaving them would serialise every sample on the load latency.
template <bool KEEP_E>
__device__ __forceinline__ void modulate(const float* wr, const float* wi,
                                         const float2* ed, float om, int c0,
                                         int c1, int lt, int tpt,
                                         const Geo& q, float2* xrow) {
  for (int c = c0; c < c1; ++c) {
    const float2* ec = ed + c * q.Lrow;
    float2* dst = xrow + (c - c0) * q.row_stride;
    for (int m0 = lt; m0 < q.Lrow; m0 += kMod * tpt) {
      float vr[kMod], vi[kMod];
      float2 e[kMod];
#pragma unroll
      for (int k = 0; k < kMod; ++k) {
        const int m = m0 + k * tpt;
        const int i = m * q.Q + c;
        const bool in = m < q.Lrow && i < q.W;
        vr[k] = in ? wr[i] : 0.f;
        vi[k] = in ? wi[i] : 0.f;
        if constexpr (KEEP_E)
          e[k] = m < q.Lrow ? ec[m] : make_float2(0.f, 0.f);
        else
          e[k] = in ? modulation(om, i) : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int k = 0; k < kMod; ++k) {
        const int m = m0 + k * tpt;
        if (m < q.Lrow)
          dst[skew(m)] = make_float2(vr[k] * e[k].x - vi[k] * e[k].y,
                                     vi[k] * e[k].x + vr[k] * e[k].y);
      }
    }
  }
}

// Streaming form of `modulate`: residues c0..c1-1 of one tile's window
// (wr, wi in global memory), the residue fastest across threads so that a
// warp reads contiguous samples; the same per-sample arithmetic.
template <bool KEEP_E>
__device__ __forceinline__ void modulate_stream(const float* wr,
                                                const float* wi,
                                                const float2* ed, float om,
                                                int c0, int c1, int lt,
                                                int tpt, const Geo& q,
                                                float2* xrow) {
  const int nc = c1 - c0;
  const int n = q.Lrow * nc;
  for (int f0 = lt; f0 < n; f0 += kMod * tpt) {
    float vr[kMod], vi[kMod];
    float2 e[kMod];
#pragma unroll
    for (int k = 0; k < kMod; ++k) {
      const int f = f0 + k * tpt;
      const int m = f / nc;
      const int c = c0 + f - m * nc;
      const int i = m * q.Q + c;
      const bool in = f < n && i < q.W;
      vr[k] = in ? __ldg(wr + i) : 0.f;
      vi[k] = in ? __ldg(wi + i) : 0.f;
      if constexpr (KEEP_E)
        e[k] = f < n ? ed[c * q.Lrow + m] : make_float2(0.f, 0.f);
      else
        e[k] = in ? modulation(om, i) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kMod; ++k) {
      const int f = f0 + k * tpt;
      if (f < n) {
        const int m = f / nc;
        const int c = f - m * nc;
        xrow[c * q.row_stride + skew(m)] =
            make_float2(vr[k] * e[k].x - vi[k] * e[k].y,
                        vi[k] * e[k].x + vr[k] * e[k].y);
      }
    }
  }
}

template <int U, int NCH>
__global__ void __launch_bounds__(kMaxThreads)
route_kernel(const float* __restrict__ z_re, const float* __restrict__ z_im,
             const int* __restrict__ chan_idx,
             const float* __restrict__ omega,   // [N]
             const float* __restrict__ pw0,     // [N]
             const float* __restrict__ taps,    // [P][Q][A]
             float* __restrict__ out_re,        // [N, n_rows*O]
             float* __restrict__ out_im, Geo q) {
  extern __shared__ __align__(16) float smem[];
  float* raw_re = smem;
  float* raw_im = raw_re + q.raw_len;
  float2* xm = reinterpret_cast<float2*>(raw_im + q.raw_len);
  float2* ed = xm + q.rows_len;                    // [Q][Lrow] or none
  float* tp = reinterpret_cast<float*>(ed + q.ed_len);  // [P][Q or CQ][A4]

  const int n = blockIdx.y;
  const int g_begin = blockIdx.x * q.tiles_per_block;
  const int g_end = min(q.n_rows, g_begin + q.tiles_per_block);
  if (g_begin >= g_end) return;
  const long row = (long)chan_idx[n] * q.total;
  int delta = q.stream ? 0
                       : stage_raw(z_re, z_im, row, g_begin, q, raw_re,
                                   raw_im);

  // Per-demod tables, built while the first span is in flight. Each
  // product and remainder is rounded as the reference's float32 tensor
  // expressions: omega*i, omega*S and 64*a1 (`_tables`).
  const float om = omega[n];
  const float a1 = floor_mod(__fmul_rn(om, (float)q.S), kTwoPi);
  const float a64 = floor_mod(__fmul_rn(64.f, a1), kTwoPi);
  const float pw = pw0[n];
  for (int idx = threadIdx.x; idx < q.ed_len; idx += blockDim.x) {
    const int c = idx / q.Lrow;
    ed[idx] = modulation(om, (idx - c * q.Lrow) * q.Q + c);
  }
  if (!q.stream)
    for (int idx = threadIdx.x; idx < q.P * q.Q * q.A; idx += blockDim.x) {
      const int row_t = idx / q.A;
      tp[row_t * q.A4 + idx - row_t * q.A] = taps[idx];
    }
  const int tap_rows = q.stream ? q.CQ : q.Q;

  // This thread's work: residue group kk, tile tb of the batch, phase r,
  // outputs lb0 .. lb0+R-1 of that phase.
  const int tpt = q.P * q.G;
  const int per_group = q.TB * tpt;
  const int kk = threadIdx.x / per_group;
  const int rest = threadIdx.x - kk * per_group;
  const int tb = rest / tpt;
  const int lt = rest - tb * tpt;
  const int r = lt / q.G;
  const int jg = lt - r * q.G;
  const int lb0 = jg * kR;
  const int Ob = q.O / q.P;
  const long n_out = (long)q.n_rows * q.O;
  float2* xrow = xm + tb * q.CQ * q.row_stride;

  for (int g0 = g_begin; g0 < g_end; g0 += q.TB) {
    cp_async_wait_all();
    __syncthreads();
    const int g = g0 + tb;
    const bool mine = kk < q.RS && g < g_end;
    float ar[kR], ai[kR];
#pragma unroll
    for (int j = 0; j < kR; ++j) ar[j] = ai[j] = 0.f;
    for (int c0 = 0; c0 < q.Q; c0 += q.CQ) {
      const int c1 = min(q.Q, c0 + q.CQ);
      if (c0 > 0) __syncthreads();     // the last pass's rows are read
      if (q.stream) {
        // This pass's taps into [P][CQ][A4], then its residue rows
        // straight from the channel row.
        const int nc = c1 - c0;
        for (int idx = threadIdx.x; idx < q.P * nc * q.A; idx += blockDim.x) {
          const int pr = idx / q.A;          // rr * nc + cc
          const int rr = pr / nc;
          const int cc = pr - rr * nc;
          const int a = idx - pr * q.A;
          tp[(rr * q.CQ + cc) * q.A4 + a] =
              taps[(rr * q.Q + c0 + cc) * q.A + a];
        }
        if (mine) {
          const long w0 = row + q.start + (long)g * q.S;
          const int lm = kk * tpt + lt, n_mod = q.RS * tpt;
          if (q.keep_e)
            modulate_stream<true>(z_re + w0, z_im + w0, ed, om, c0, c1, lm,
                                  n_mod, q, xrow);
          else
            modulate_stream<false>(z_re + w0, z_im + w0, ed, om, c0, c1, lm,
                                   n_mod, q, xrow);
        }
      } else if (mine) {
        const float* wr = raw_re + delta + tb * q.S;
        const float* wi = raw_im + delta + tb * q.S;
        const int lm = kk * tpt + lt, n_mod = q.RS * tpt;
        if (q.keep_e)
          modulate<true>(wr, wi, ed, om, c0, c1, lm, n_mod, q, xrow);
        else
          modulate<false>(wr, wi, ed, om, c0, c1, lm, n_mod, q, xrow);
      }
      __syncthreads();
      // The raw span is free: fetch the next batch's.
      if (!q.stream && c1 == q.Q && g0 + q.TB < g_end)
        delta = stage_raw(z_re, z_im, row, g0 + q.TB, q, raw_re, raw_im);
      const int tc0 = q.stream ? c0 : 0;
      if (mine)
        for (int c = c0 + kk; c < c1; c += q.RS)
          fir_residue<U, NCH>(xrow + (c - c0) * q.row_stride + jg * (kR + 1),
                              tp + (r * tap_rows + c - tc0) * q.A4, q.A, ar,
                              ai);
    }
    if (q.RS > 1) {
      // Groups 1..RS-1 hand their partial sums to group 0 through the
      // rows, laid out [group][j][thread] (conflict free); group 0 adds
      // them in group order.
      float2* red = xm;
      __syncthreads();                     // every pass's rows are read
      if (mine && kk > 0)
#pragma unroll
        for (int j = 0; j < kR; ++j)
          red[((kk - 1) * kR + j) * per_group + rest] = make_float2(ar[j],
                                                                    ai[j]);
      __syncthreads();
      if (mine && kk == 0)
        for (int k2 = 1; k2 < q.RS; ++k2)
#pragma unroll
          for (int j = 0; j < kR; ++j) {
            const float2 v = red[((k2 - 1) * kR + j) * per_group + rest];
            ar[j] += v.x;
            ai[j] += v.y;
          }
    }
    if (!mine || kk > 0) continue;

    // Rounded exactly as the reference's float32 expression
    // (pw0 + a64*hi) + a1*lo, with no FMA contraction: a1*lo reaches a
    // few hundred radians, where one contraction moves phi by ~3e-5 rad.
    const float phi = floor_mod(
        __fadd_rn(__fadd_rn(pw, __fmul_rn(a64, (float)(g / 64))),
                  __fmul_rn(a1, (float)(g % 64))),
        kTwoPi);
    float sn, cs;
    sincosf(phi, &sn, &cs);
#pragma unroll
    for (int j = 0; j < kR; ++j) {
      const float yr = ar[j] * cs - ai[j] * sn;
      const float yi = ai[j] * cs + ar[j] * sn;
      ar[j] = yr;
      ai[j] = yi;
    }
    const long o = (long)n * n_out + (long)g * q.O;
    if (q.P == 1 && q.O % 4 == 0 && lb0 + kR <= Ob) {
      float4* pr = reinterpret_cast<float4*>(out_re + o + lb0);
      float4* pi = reinterpret_cast<float4*>(out_im + o + lb0);
#pragma unroll
      for (int v = 0; v < kR / 4; ++v) {
        pr[v] = make_float4(ar[4 * v], ar[4 * v + 1], ar[4 * v + 2],
                            ar[4 * v + 3]);
        pi[v] = make_float4(ai[4 * v], ai[4 * v + 1], ai[4 * v + 2],
                            ai[4 * v + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kR; ++j) {
        const int lb = lb0 + j;
        if (lb < Ob) {
          out_re[o + (long)lb * q.P + r] = ar[j];
          out_im[o + (long)lb * q.P + r] = ai[j];
        }
      }
    }
  }
}

constexpr size_t kSmemMax = 232448;   // opt-in dynamic smem per block
constexpr int kMaxDevices = 64;

template <int U, int NCH>
int launch(const float* z_re, const float* z_im, const int* chan_idx,
           const float* omega, const float* pw0, const float* taps,
           float* out_re, float* out_im, int N, Geo q, cudaStream_t stream) {
  const int tpt = q.P * q.G;
  if (q.TB < 1 || q.RS < 1 || q.RS * q.TB * tpt > kMaxThreads || q.CQ < 1
      || q.CQ > q.Q || q.RS > q.CQ || (q.stream && q.TB != 1))
    return (int)cudaErrorInvalidValue;
  const int threads = ((q.RS * q.TB * tpt + 31) / 32) * 32;
  const long span = 3L + (long)(q.TB - 1) * q.S + q.W;
  q.raw_len = q.stream ? 0 : (int)((span + 3) / 4 * 4);
  q.rows_len = max(q.TB * q.CQ * q.row_stride,
                   (q.RS - 1) * kR * q.TB * tpt);
  const size_t tap_len = (size_t)q.P * (q.stream ? q.CQ : q.Q) * q.A4;
  const size_t smem = sizeof(float) * (2 * (size_t)q.raw_len + tap_len)
                      + sizeof(float2) * ((size_t)q.rows_len
                                          + (size_t)q.ed_len);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // The attribute is per device: set it once on each device launched on.
  static bool attr_set[kMaxDevices] = {};
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        route_kernel<U, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemMax);
    if (e != cudaSuccess) return (int)e;
    attr_set[dev] = true;
  }
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, route_kernel<U, NCH>,
                                                threads, smem);
  if (per_sm < 1) per_sm = 1;
  // Tiles per block: enough blocks for every SM's resident slots, each
  // block a whole number of batches of one demod.
  const int n_batch = (q.n_rows + q.TB - 1) / q.TB;
  const long slots = (long)n_sm * per_sm;
  int bpd = (int)((slots + N - 1) / N);
  if (bpd > n_batch) bpd = n_batch;
  if (bpd < 1) bpd = 1;
  const int batches_per_block = (n_batch + bpd - 1) / bpd;
  bpd = (n_batch + batches_per_block - 1) / batches_per_block;
  q.tiles_per_block = batches_per_block * q.TB;
  const dim3 grid(bpd, N);
  route_kernel<U, NCH><<<grid, threads, smem, stream>>>(
      z_re, z_im, chan_idx, omega, pw0, taps, out_re, out_im, q);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` over N demods x n_rows tiles; `taps` is the
// [P][Q][A] polyphase layout with A a multiple of U (U in 4, 5, 6, 8);
// (TB, RS, CQ, keep_e, stream_window) is the shared-memory plan
// (`route_plan`). Returns a
// cudaError_t (0 on success; cudaErrorInvalidValue for a plan that does
// not fit).
extern "C" int routed_shifted_resample_launch(
    const float* z_re, const float* z_im, long total, const int* chan_idx,
    const float* omega, const float* pw0, const float* taps, float* out_re,
    float* out_im, int N, int n_rows, int O, int P, int Q, int A, int U,
    int S, int W, int start, int TB, int RS, int CQ, int keep_e,
    int stream_window, void* stream) {
  Geo q{};
  q.total = total;
  q.n_rows = n_rows;
  q.O = O;
  q.P = P;
  q.Q = Q;
  q.A = A;
  q.S = S;
  q.W = W;
  q.start = start;
  q.A4 = (A + 3) / 4 * 4;
  q.G = (O / P + kR - 1) / kR;
  q.Lrow = q.G * kR + A;
  // Even, so that what follows the rows stays 16-byte aligned.
  q.row_stride = (q.Lrow + q.Lrow / kR + 2) / 2 * 2;
  q.TB = TB;
  q.RS = RS;
  q.CQ = CQ;
  q.keep_e = keep_e ? 1 : 0;
  q.stream = stream_window ? 1 : 0;
  q.ed_len = keep_e ? (q.Q * q.Lrow + 1) / 2 * 2 : 0;
  if (A % U) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define CUBICSDR_ROUTE_LAUNCH(u, nch) \
  launch<u, nch>(z_re, z_im, chan_idx, omega, pw0, taps, out_re, out_im, N, q, s)
  // Unrolled instances for the tap counts of the FM path (1/5 and 1/4:
  // A = 25; 2/5: A = 15; 6/25: A = 5); a runtime chunk loop otherwise.
  if (U == 5 && A == 25) return CUBICSDR_ROUTE_LAUNCH(5, 5);
  if (U == 5 && A == 15) return CUBICSDR_ROUTE_LAUNCH(5, 3);
  if (U == 5 && A == 5) return CUBICSDR_ROUTE_LAUNCH(5, 1);
  switch (U) {
    case 4: return CUBICSDR_ROUTE_LAUNCH(4, 0);
    case 5: return CUBICSDR_ROUTE_LAUNCH(5, 0);
    case 6: return CUBICSDR_ROUTE_LAUNCH(6, 0);
    case 8: return CUBICSDR_ROUTE_LAUNCH(8, 0);
    default: return (int)cudaErrorInvalidValue;
  }
#undef CUBICSDR_ROUTE_LAUNCH
}
