// Hand-written Hopper (sm_90a) kernels of the PyTorch/CUDA port.
//
// Each kernel is exposed through a plain extern "C" launcher that takes raw
// device pointers and a stream and returns cudaGetLastError() after the
// launch; Python binds them with ctypes (kernels/_build.py). Both kernels
// are bound by device-memory bytes, not arithmetic: see the notes above
// each one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// enhance: replaces ocr_system_tpu/kernels/preprocess_pallas.py::fused_enhance
//
// out = (clip(blur5(c) + (c - blur5(c)) * sharpness, 0, 1) - norm_mean)
//       / norm_std,   c = clip(mean + (x - mean) * contrast, 0, 1)
// with blur5 the separable 5-tap Gaussian (sigma 1), rows first, edges
// replicated by clamping indices at the true image borders.
//
// Bound: bytes. Per pixel it reads one float per input channel and writes
// three; the 5x5 stencil's reuse is served from shared memory, so each
// input element leaves device memory about once (8 x 960 x 960 pages with
// RGB in and out: ~177 MB). Design: one block per 32 x 16 output tile of
// one image; the block stages the contrast-adjusted tile plus a 2-pixel
// halo in shared memory, blurs columns into a second shared buffer, then
// each thread finishes its pixels in registers and writes every output
// channel. A gray input (channel stride 0) is read once and written as
// three normalised planes, which is the detector's path. Unlike the TPU
// kernel there is no lane padding and no row tiling with DMA halos.
constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr int kRadius = 2;
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

struct EnhanceParams {
  const float* in;
  float* out;
  const float* means;  // (B,) luma mean per image
  int h, w, in_channels;  // in_channels: 1 (gray) or 3
  long long in_sb, in_sc, in_sy, in_sx;
  long long out_sb, out_sc, out_sy, out_sx;
  float contrast, sharpness;
  float g[5];
  float norm_mean[3], norm_std[3];
};

__global__ void enhance_kernel(const EnhanceParams p) {
  __shared__ float c[kTileH + 2 * kRadius][kTileW + 2 * kRadius];
  __shared__ float v[kTileH][kTileW + 2 * kRadius];
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  const int nthreads = kThreadsX * kThreadsY;
  const float mean = p.means[b];
  constexpr int cw = kTileW + 2 * kRadius;
  constexpr int ch = kTileH + 2 * kRadius;

  for (int plane = 0; plane < p.in_channels; ++plane) {
    const float* src = p.in + b * p.in_sb + plane * p.in_sc;
    for (int i = tid; i < ch * cw; i += nthreads) {
      const int ty = i / cw, tx = i % cw;
      const int gy = min(max(y0 + ty - kRadius, 0), p.h - 1);
      const int gx = min(max(x0 + tx - kRadius, 0), p.w - 1);
      const float x = src[gy * p.in_sy + gx * p.in_sx];
      c[ty][tx] = fminf(fmaxf(mean + (x - mean) * p.contrast, 0.0f), 1.0f);
    }
    __syncthreads();
    for (int i = tid; i < kTileH * cw; i += nthreads) {
      const int ty = i / cw, tx = i % cw;
      v[ty][tx] = p.g[0] * c[ty][tx] + p.g[1] * c[ty + 1][tx] +
                  p.g[2] * c[ty + 2][tx] + p.g[3] * c[ty + 3][tx] +
                  p.g[4] * c[ty + 4][tx];
    }
    __syncthreads();
    const int tx = threadIdx.x;
    for (int ty = threadIdx.y; ty < kTileH; ty += kThreadsY) {
      const int y = y0 + ty, x = x0 + tx;
      if (y < p.h && x < p.w) {
        const float blur = p.g[0] * v[ty][tx] + p.g[1] * v[ty][tx + 1] +
                           p.g[2] * v[ty][tx + 2] + p.g[3] * v[ty][tx + 3] +
                           p.g[4] * v[ty][tx + 4];
        const float cc = c[ty + kRadius][tx + kRadius];
        const float s = fminf(fmaxf(blur + (cc - blur) * p.sharpness, 0.0f), 1.0f);
        float* dst = p.out + b * p.out_sb + y * p.out_sy + x * p.out_sx;
        if (p.in_channels == 1) {
          for (int k = 0; k < 3; ++k)
            dst[k * p.out_sc] = (s - p.norm_mean[k]) / p.norm_std[k];
        } else {
          dst[plane * p.out_sc] = (s - p.norm_mean[plane]) / p.norm_std[plane];
        }
      }
    }
    __syncthreads();  // c and v are rewritten by the next plane
  }
}

// ---------------------------------------------------------------------------
// crop: replaces ocr_system_tpu/kernels/crop_pallas.py::crop_boxes_matmul
//
// Per box n (page n / N), output (r, j) of an (H, W) crop samples the page
// bilinearly at ys = y0 + (y1 - y0) * r / (H - 1), xs = x0 + (x1 - x0) *
// j / (W - 1), each clamped into the page (border replication), scales by
// 1/255 and is zero for j >= w_valid[n].
//
// Bound: bytes, dominated by the float32 output (crops x H x W x 4); the
// page reads are 4 uint8 taps per output, mostly from L2. Design: one block
// per (box, output row); its threads walk the row's columns, so stores are
// coalesced. Direct 4-tap gathers replace the TPU kernel's hat-weight
// matmuls on a 128-row slab, so no box height bound exists.
constexpr int kCropThreads = 128;

__global__ void crop_kernel(const uint8_t* __restrict__ pages,
                            const float* __restrict__ aabbs,
                            const int32_t* __restrict__ w_valid,
                            float* __restrict__ out, int n_per_page,
                            int rows, int cols, int h_out, int w_out) {
  const int n = blockIdx.x;
  const int r = blockIdx.y;
  const uint8_t* page = pages + (long long)(n / n_per_page) * rows * cols;
  const float bx0 = aabbs[4 * n + 0], by0 = aabbs[4 * n + 1];
  const float bx1 = aabbs[4 * n + 2], by1 = aabbs[4 * n + 3];
  const int wv = w_valid[n];

  // the division keeps the reference's rounding (no fused multiply-add)
  float ys = by0 + ((by1 - by0) * (float)r) / (float)(h_out - 1);
  ys = fminf(fmaxf(ys, 0.0f), (float)(rows - 1));
  const float yf = floorf(ys);
  const float dy = ys - yf;
  const int ya = (int)yf;
  const int yb = min(ya + 1, rows - 1);
  const uint8_t* row_a = page + (long long)ya * cols;
  const uint8_t* row_b = page + (long long)yb * cols;
  float* dst = out + ((long long)n * h_out + r) * w_out;
  const float inv255 = 1.0f / 255.0f;

  for (int j = threadIdx.x; j < w_out; j += blockDim.x) {
    float val = 0.0f;
    if (j < wv) {
      float xs = bx0 + ((bx1 - bx0) * (float)j) / (float)(w_out - 1);
      xs = fminf(fmaxf(xs, 0.0f), (float)(cols - 1));
      const float xf = floorf(xs);
      const float dx = xs - xf;
      const int xa = (int)xf;
      const int xb = min(xa + 1, cols - 1);
      const float left = (1.0f - dy) * (row_a[xa] * inv255) + dy * (row_b[xa] * inv255);
      const float right = (1.0f - dy) * (row_a[xb] * inv255) + dy * (row_b[xb] * inv255);
      val = (1.0f - dx) * left + dx * right;
    }
    dst[j] = val;
  }
}

}  // namespace

extern "C" {

int ocr_enhance(const float* in, float* out, const float* means, int batch,
                int h, int w, int in_channels, long long in_sb, long long in_sc,
                long long in_sy, long long in_sx, long long out_sb,
                long long out_sc, long long out_sy, long long out_sx,
                float contrast, float sharpness, const float* gauss5,
                const float* norm_mean, const float* norm_std,
                void* stream) {
  EnhanceParams p;
  p.in = in;
  p.out = out;
  p.means = means;
  p.h = h;
  p.w = w;
  p.in_channels = in_channels;
  p.in_sb = in_sb;
  p.in_sc = in_sc;
  p.in_sy = in_sy;
  p.in_sx = in_sx;
  p.out_sb = out_sb;
  p.out_sc = out_sc;
  p.out_sy = out_sy;
  p.out_sx = out_sx;
  p.contrast = contrast;
  p.sharpness = sharpness;
  for (int k = 0; k < 5; ++k) p.g[k] = gauss5[k];
  for (int k = 0; k < 3; ++k) {
    p.norm_mean[k] = norm_mean[k];
    p.norm_std[k] = norm_std[k];
  }
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, batch);
  const dim3 block(kThreadsX, kThreadsY);
  enhance_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int ocr_crop(const uint8_t* pages, const float* aabbs, const int32_t* w_valid,
             float* out, int n_boxes, int n_per_page, int rows, int cols,
             int h_out, int w_out, void* stream) {
  const dim3 grid(n_boxes, h_out);
  crop_kernel<<<grid, kCropThreads, 0, (cudaStream_t)stream>>>(
      pages, aabbs, w_valid, out, n_per_page, rows, cols, h_out, w_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
