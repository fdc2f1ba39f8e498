// Fused route + NCO shift + rational resample — CUDA kernel for Hopper
// (sm_90a).
//
// Replaces: cubicsdr_tpu/ops/pallas/route.py,
// routed_shifted_resample_pallas (the Pallas TPU kernel `_kernel` /
// `_one_tile`). For demod n and output tile g (O outputs, input stride
// S = (O/P)*Q, window W = (O/P - 1)*Q + KK), with the window
// w[i] = z[chan_idx[n], start + g*S + i]:
//
//   xm[i]      = w[i] * E[n, i],        E[n, i] = e^{+i mod(omega_n i, 2pi)}
//   y[m]       = sum_t ker[r, t] * xm[lb*Q + KK-1-t],   m = lb*P + r
//   out[n, gO+m] = y[m] * e^{+i phi},
//   phi = mod(pw0_n + a64_n*(g/64) + a1_n*(g%64), 2pi)
//
// i.e. the Pallas kernel's window @ banded-Toeplitz product, evaluated as
// the KK-tap dot product each output actually touches (the Toeplitz
// matrix is zero outside that band). The channel is indexed directly (the
// TPU kernel's one-hot matmul and bf16 splits were MXU workarounds); the
// phase bookkeeping (window-local modulation, split pre-wrapped tile
// increments a1/a64) is kept exactly: it is about float32 accuracy.
//
// What bounds it on the H100: 2*KK FMAs per complex output (KK = 124 on
// the 8 MS/s, 200 kHz FM path: 496 flop/output) on the FP32 CUDA cores,
// ~3.2 GFLOP per block at 256 demods; the per-(tile, demod) window and
// E-table reads come from L2 (the 16-channel stream is 16 MB and stays
// L2-resident), the outputs (8 bytes each) go to DRAM once. FP32 FMA
// throughput is the floor.
//
// Design: one block per (tile, demod). The block stages its channel's
// W-sample window, modulated by E, in shared memory, then each thread
// computes whole outputs with KK f32 FMAs per plane from shared memory
// (output lanes read at stride Q, conflict free for odd Q) and rotates
// them by the tile phase. No per-demod full-rate stream is written to
// device memory. No tensor cores yet: simple and exact f32 first.

#include <cuda_runtime.h>

namespace {

constexpr float kTwoPi = 6.283185307179586f;

// Floor-mod, the semantics of jnp.mod / torch.remainder.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.f && ((r < 0.f) != (y < 0.f))) r += y;
  return r;
}

__global__ void route_kernel(const float* __restrict__ z_re,
                             const float* __restrict__ z_im, long total,
                             const int* __restrict__ chan_idx,
                             const float* __restrict__ e_re,  // [N, W]
                             const float* __restrict__ e_im,
                             const float* __restrict__ ker,   // [P, KK]
                             const float* __restrict__ pw0,   // [N]
                             const float* __restrict__ a1,
                             const float* __restrict__ a64,
                             float* __restrict__ out_re,      // [N, n_out]
                             float* __restrict__ out_im,
                             long n_out, int O, int P, int Q, int KK,
                             int S, int W, int start) {
  extern __shared__ float smem[];
  float* xr = smem;
  float* xi = xr + W;
  float* kr = xi + W;                      // [P][KK]
  const int g = blockIdx.x;
  const int n = blockIdx.y;
  const long row = (long)chan_idx[n] * total;
  const long off = (long)start + (long)g * S;
  const float* er = e_re + (long)n * W;
  const float* ei = e_im + (long)n * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const long p = off + i;
    const float vr = p < total ? z_re[row + p] : 0.f;
    const float vi = p < total ? z_im[row + p] : 0.f;
    xr[i] = vr * er[i] - vi * ei[i];
    xi[i] = vi * er[i] + vr * ei[i];
  }
  for (int i = threadIdx.x; i < P * KK; i += blockDim.x) kr[i] = ker[i];
  __syncthreads();

  // Rounded exactly as the reference's float32 expression
  // (pw0 + a64*hi) + a1*lo, with no FMA contraction: a1*lo reaches a few
  // hundred radians, where one contraction moves phi by ~3e-5 rad.
  const float phi = floor_mod(
      __fadd_rn(__fadd_rn(pw0[n], __fmul_rn(a64[n], (float)(g / 64))),
                __fmul_rn(a1[n], (float)(g % 64))),
      kTwoPi);
  float sn, cs;
  sincosf(phi, &sn, &cs);
  for (int m = threadIdx.x; m < O; m += blockDim.x) {
    const int lb = m / P;
    const int r = m - lb * P;
    const float* k = kr + r * KK;
    const float* pr = xr + lb * Q + KK - 1;
    const float* pm = xi + lb * Q + KK - 1;
    float yr = 0.f, yi = 0.f;
    for (int t = 0; t < KK; ++t) {
      yr = fmaf(k[t], pr[-t], yr);
      yi = fmaf(k[t], pm[-t], yi);
    }
    const long o = (long)n * n_out + (long)g * O + m;
    out_re[o] = yr * cs - yi * sn;
    out_im[o] = yi * cs + yr * sn;
  }
}

}  // namespace

// Launch on `stream` over n_rows tiles x N demods; returns
// cudaGetLastError() (0 on success).
extern "C" int routed_shifted_resample_launch(
    const float* z_re, const float* z_im, long total, const int* chan_idx,
    const float* e_re, const float* e_im, const float* ker, const float* pw0,
    const float* a1, const float* a64, float* out_re, float* out_im, int N,
    int n_rows, int O, int P, int Q, int KK, int S, int W, int start,
    void* stream) {
  const size_t smem = sizeof(float) * (size_t)(2 * W + P * KK);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        route_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int threads = ((O + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid(n_rows, N);
  route_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      z_re, z_im, total, chan_idx, e_re, e_im, ker, pw0, a1, a64, out_re,
      out_im, (long)n_rows * O, O, P, Q, KK, S, W, start);
  return (int)cudaGetLastError();
}
