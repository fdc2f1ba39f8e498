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
// (8*D bytes) and writes M complex outputs (8*M bytes) while doing
// 2*M*J + 4*M*M FMAs. At M=16 that is ~13 flop/byte, below the card's
// FP32 ridge (~20 flop/byte at 67 TFLOP/s and 3.35 TB/s): DRAM traffic
// (8 MB in, 16 MB out per 1,024,000-sample block) is the floor.
//
// Design: one block per tile of T output steps. The block stages the
// (T + 2J - 1)*D-sample window of both planes in shared memory once (the
// 2J-1 step halo is the only re-read), computes the M branch sums per step
// into shared memory (rows padded to M+1 floats so the DFT's reads are
// bank-conflict free), then applies the MxM DFT, c_k and the parity flip
// with f32 FMAs from shared memory and writes each channel row with
// consecutive threads on consecutive steps (coalesced). Any even M works;
// the ragged last tile is masked. No tensor cores: a simple, exact-f32
// first version.

#include <cuda_runtime.h>

namespace {

__global__ void pfbch2_kernel(const float* __restrict__ z_re,
                              const float* __restrict__ z_im, long z_len,
                              const float* __restrict__ h,      // [M, J]
                              const float* __restrict__ w_re,   // [M, M]
                              const float* __restrict__ w_im,
                              const float* __restrict__ c_re,   // [M]
                              const float* __restrict__ c_im,
                              const int* __restrict__ parity,   // scalar
                              float* __restrict__ out_re,       // [M, n_steps]
                              float* __restrict__ out_im,
                              int M, int J, int n_steps, int T) {
  extern __shared__ float smem[];
  const int D = M / 2;
  const int win = (T + 2 * J - 1) * D;
  const int U = M + 1;                      // padded u row (one step)
  float* x_re = smem;
  float* x_im = x_re + win;
  float* u_re = x_im + win;                 // [T][M+1]
  float* u_im = u_re + T * U;
  float* sw_re = u_im + T * U;              // [M][M]
  float* sw_im = sw_re + M * M;
  float* sh = sw_im + M * M;                // [M][J]

  const int s0 = blockIdx.x * T;
  const long base = (long)s0 * D;
  for (int i = threadIdx.x; i < win; i += blockDim.x) {
    const long g = base + i;
    x_re[i] = g < z_len ? z_re[g] : 0.f;
    x_im[i] = g < z_len ? z_im[g] : 0.f;
  }
  for (int i = threadIdx.x; i < M * M; i += blockDim.x) {
    sw_re[i] = w_re[i];
    sw_im[i] = w_im[i];
  }
  for (int i = threadIdx.x; i < M * J; i += blockDim.x) sh[i] = h[i];
  __syncthreads();

  // Polyphase FIR: branch rho fastest, so a warp reads a contiguous run
  // of the window.
  for (int idx = threadIdx.x; idx < M * T; idx += blockDim.x) {
    const int rho = idx % M;
    const int t = idx / M;
    const float* hr = sh + rho * J;
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j < J; ++j) {
      const int p = (t + 2 * (J - 1 - j)) * D + M - 1 - rho;
      ar = fmaf(hr[j], x_re[p], ar);
      ai = fmaf(hr[j], x_im[p], ai);
    }
    u_re[t * U + rho] = ar;
    u_im[t * U + rho] = ai;
  }
  __syncthreads();

  // DFT + c_k + parity flip: step fastest, so each channel row is written
  // by consecutive threads.
  const int par = *parity;
  for (int idx = threadIdx.x; idx < M * T; idx += blockDim.x) {
    const int t = idx % T;
    const int k = idx / T;
    const int s = s0 + t;
    if (s >= n_steps) continue;
    const float* wr = sw_re + k * M;
    const float* wi = sw_im + k * M;
    const float* ur = u_re + t * U;
    const float* ui = u_im + t * U;
    float yr = 0.f, yi = 0.f;
    for (int rho = 0; rho < M; ++rho) {
      yr = fmaf(wr[rho], ur[rho], yr);
      yr = fmaf(-wi[rho], ui[rho], yr);
      yi = fmaf(wr[rho], ui[rho], yi);
      yi = fmaf(wi[rho], ur[rho], yi);
    }
    float vr = yr * c_re[k] - yi * c_im[k];
    float vi = yr * c_im[k] + yi * c_re[k];
    if ((k & 1) && ((s + par) & 1)) {
      vr = -vr;
      vi = -vi;
    }
    out_re[(long)k * n_steps + s] = vr;
    out_im[(long)k * n_steps + s] = vi;
  }
}

}  // namespace

extern "C" size_t pfbch2_smem_bytes(int M, int J, int T) {
  const int D = M / 2;
  return sizeof(float) * (size_t)(2 * (T + 2 * J - 1) * D + 2 * T * (M + 1)
                                  + 2 * M * M + M * J);
}

// Launch on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int pfbch2_planar_launch(const float* z_re, const float* z_im,
                                    long z_len, const float* h,
                                    const float* w_re, const float* w_im,
                                    const float* c_re, const float* c_im,
                                    const int* parity, float* out_re,
                                    float* out_im, int M, int J, int n_steps,
                                    int T, void* stream) {
  const size_t smem = pfbch2_smem_bytes(M, J, T);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        pfbch2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (n_steps + T - 1) / T;
  pfbch2_kernel<<<grid, 256, smem, (cudaStream_t)stream>>>(
      z_re, z_im, z_len, h, w_re, w_im, c_re, c_im, parity, out_re, out_im,
      M, J, n_steps, T);
  return (int)cudaGetLastError();
}

// Message for a CUDA error code returned by any launch function here.
extern "C" const char* cubicsdr_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
