// Hand-written Hopper (sm_90a) kernels of the PyTorch/CUDA port.
//
// Each kernel is exposed through a plain extern "C" launcher that takes raw
// device pointers and a stream and returns cudaGetLastError() after the
// launch; Python binds them with ctypes (kernels/_build.py). Both kernels
// are bound by device-memory bytes, not arithmetic: see the notes above
// each one. Each writes float32 or bfloat16 (rounded to nearest even, as
// Tensor.to(torch.bfloat16) rounds), the model's compute dtype, so no
// separate cast pass follows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// u8 -> float without the slow integer-to-float unit: byte k of `word`
// under the exponent of 2^23 is 2^23 + v exactly.
__device__ __forceinline__ float byte_to_float(uint32_t word, int k) {
  const uint32_t bits = __byte_perm(word, 0x4B000000u, 0x7440u | k);
  return __int_as_float(bits) - 8388608.0f;
}

// Correctly rounded a / b from r = RN(1 / b): one Newton step on the
// product (Markstein). Checked on random inputs for the normalisation's
// divisors.
__device__ __forceinline__ float div_rn(float a, float b, float r) {
  const float q = __fmul_rn(a, r);
  const float e = __fmaf_rn(-q, b, a);
  return __fmaf_rn(e, r, q);
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// ---------------------------------------------------------------------------
// enhance: replaces ocr_system_tpu/kernels/preprocess_pallas.py::fused_enhance
//
// out_k = (clip(blur5(c) + (c - blur5(c)) * sharpness, 0, 1) - norm_mean_k)
//         / norm_std_k,   c = clip(mean + (x - mean) * contrast, 0, 1)
// with blur5 the separable 5-tap Gaussian (sigma 1), down the columns
// first, edges replicated by clamping indices at the true image borders,
// and x = v * float32(1/255) for a u8 input v (the detector's f =
// gray_u8 / 255 as XLA compiles it: a multiply by the reciprocal). Every
// step rounds as the plain PyTorch version does (no contracted
// multiply-adds; the normalisation's division correctly rounded), so the
// float32 result is the plain version's bit for bit, and the bf16 output
// its rounding: near zero, where s - norm_mean cancels, a float32 ulp of
// difference would span many bf16 ulps.
//
// Bound: bytes. The detector's form reads the (B, S, S) u8 canvas and
// writes three planes in the compute dtype: 8 x 960^2 u8 in, bf16 out is
// 51.6 MB. Design: one block of 4 warps per 480-column x 16-row tile of one
// plane. The block first copies its u8 tile plus a 2-row and 4-column halo
// into shared memory, each thread issuing all its ~20 word loads before it
// stores any (~10 KB in flight per block, several blocks per SM). Then each lane owns 4 adjacent columns
// and streams down the 20 tile rows: per row, one 4-byte shared load, c
// for its columns, and each c added into the five column sums that need
// it (a register ring, unrolled by 5 so it is renaming, not moves). When a
// sum is complete, the ±2 neighbouring column sums come from the adjacent
// lanes by __shfl_sync; lanes 0 and 31 of each warp only supply that halo,
// so a warp writes 120 columns, 4 per lane, as one 8-byte (bf16) or
// 16-byte (f32) store per plane, coalesced across the warp. The RGB form
// (float32 planes in, one output plane each) shares the code.
constexpr int kEnhWarps = 4;
constexpr int kEnhThreads = 32 * kEnhWarps;
constexpr int kEnhCols = 4;                             // columns per lane
constexpr int kEnhWarpOut = 30 * kEnhCols;              // columns a warp writes
constexpr int kEnhTileW = kEnhWarps * kEnhWarpOut;      // columns a block writes
constexpr int kEnhRows = 16;                            // rows a block writes
constexpr int kEnhTileH = kEnhRows + 4;                 // input rows, 2-row halo each side
constexpr int kEnhPitch = kEnhTileW + 8;                // 4-column halo each side
static_assert(kEnhTileH % 5 == 0, "the register ring is unrolled by 5");

struct EnhanceArgs {
  const void* in;
  void* out;
  const float* means;  // (images,) luma mean per image
  int h, w;
  float contrast, sharpness;
  float g[5];
  float norm_mean[3], norm_std[3], norm_rcp[3];
};

// x of a lane's 4 columns in one tile row (tile columns 4 * word .. + 3)
__device__ __forceinline__ void tile_x4(const uint8_t* row, int word, float x[4]) {
  const uint32_t v = reinterpret_cast<const uint32_t*>(row)[word];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = __fmul_rn(byte_to_float(v, k), 1.0f / 255.0f);
}

__device__ __forceinline__ void tile_x4(const float* row, int word, float x[4]) {
  const float4 v = reinterpret_cast<const float4*>(row)[word];
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}

// Copy the tile: rows y0 - 2 .. y0 + 17 and columns xb - 4 .. xb + 483 of
// one plane, clamped at the image borders. Each thread issues all its
// loads before it stores any, so their latencies overlap instead of adding
// up (a loop that stores each word as it arrives waits ~20 times in turn).
__device__ __forceinline__ uint32_t tile_word(const uint8_t* src, int h, int w, int xb,
                                              int y0, int i) {
  constexpr int kWords = kEnhPitch / 4;
  const int ty = i / kWords, tw = i - ty * kWords;
  const int gy = min(max(y0 - 2 + ty, 0), h - 1);
  const int gx = xb - 4 + 4 * tw;
  const uint8_t* row = src + gy * w;
  if ((w & 3) == 0 && gx >= 0 && gx + 3 < w) return *reinterpret_cast<const uint32_t*>(row + gx);
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) word |= (uint32_t)row[min(max(gx + k, 0), w - 1)] << (8 * k);
  return word;
}

__device__ __forceinline__ void load_tile(uint8_t (*tile)[kEnhPitch], const uint8_t* src,
                                          int h, int w, int xb, int y0) {
  constexpr int kTotal = kEnhTileH * kEnhPitch / 4;
  constexpr int kPerThread = (kTotal + kEnhThreads - 1) / kEnhThreads;
  uint32_t words[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = threadIdx.x + k * kEnhThreads;
    if (i < kTotal) words[k] = tile_word(src, h, w, xb, y0, i);
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = threadIdx.x + k * kEnhThreads;
    if (i < kTotal) reinterpret_cast<uint32_t*>(tile)[i] = words[k];
  }
}

__device__ __forceinline__ void load_tile(float (*tile)[kEnhPitch], const float* src,
                                          int h, int w, int xb, int y0) {
  constexpr int kTotal = kEnhTileH * kEnhPitch;
  constexpr int kBatch = 16;
  for (int base = 0; base < kTotal; base += kBatch * kEnhThreads) {
    float v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + threadIdx.x + k * kEnhThreads;
      const int ty = i / kEnhPitch, tx = i - ty * kEnhPitch;
      const int gy = min(max(y0 - 2 + ty, 0), h - 1);
      const int gx = min(max(xb - 4 + tx, 0), w - 1);
      if (i < kTotal) v[k] = src[gy * w + gx];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + threadIdx.x + k * kEnhThreads;
      if (i < kTotal) (&tile[0][0])[i] = v[k];
    }
  }
}

// a + g * b, rounded twice as PyTorch's separate multiply and add round
__device__ __forceinline__ float add_mul(float a, float g, float b) {
  return __fadd_rn(a, __fmul_rn(g, b));
}

// TIn uint8_t: one gray plane per image, three output planes (the detector).
// TIn float: three planes per image, one output plane each (the RGB form).
// Offsets are 32-bit: the wrapper refuses tensors of 2^31 elements or more.
template <typename TIn, typename TOut, int NOUT>
__global__ void __launch_bounds__(kEnhThreads, 8) enhance_kernel(const EnhanceArgs p) {
  constexpr int kPlanesPerImage = NOUT == 3 ? 1 : 3;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ __align__(16) TIn tile[kEnhTileH][kEnhPitch];
  const int q = blockIdx.z;
  const int xb = blockIdx.x * kEnhTileW;
  const int y0 = blockIdx.y * kEnhRows;
  const int h = p.h, w = p.w;
  const int plane_size = h * w;
  load_tile(tile, static_cast<const TIn*>(p.in) + q * plane_size, h, w, xb, y0);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int word = (threadIdx.x >> 5) * (kEnhWarpOut / 4) + lane;  // tile columns 4 * word ..
  const int x0 = xb - 4 + 4 * word;                                 // .. are image columns x0 ..
  const bool writes = lane > 0 && lane < 31 && x0 < w;
  const bool vec = (w & 3) == 0;  // then all 4 columns of a writing lane are in the image
  const float mean = p.means[q / kPlanesPerImage];
  const float g0 = p.g[0], g1 = p.g[1], g2 = p.g[2], g3 = p.g[3], g4 = p.g[4];
  TOut* out = static_cast<TOut*>(p.out) + q * NOUT * plane_size + x0;
  float acc[5][4] = {};  // column sums, ring by top tile row
  float cr[5][4];        // c of the lane's columns, ring by tile row

  for (int grp = 0; grp < kEnhTileH / 5; ++grp) {
#pragma unroll
    for (int k = 0; k < 5; ++k) {
      const int ty = grp * 5 + k;
      // ring slots of tile rows ty - 1 .. ty - 4: constants once unrolled
      const int k1 = (k + 4) % 5, k2 = (k + 3) % 5, k3 = (k + 2) % 5, k4 = (k + 1) % 5;
      float c[4];
      tile_x4(tile[ty], word, c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[i] = __saturatef(add_mul(mean, p.contrast, __fsub_rn(c[i], mean)));
        cr[k][i] = c[i];
        acc[k][i] = __fmul_rn(g0, c[i]);  // the sum whose top row is ty
        acc[k1][i] = add_mul(acc[k1][i], g1, c[i]);
        acc[k2][i] = add_mul(acc[k2][i], g2, c[i]);
        acc[k3][i] = add_mul(acc[k3][i], g3, c[i]);
        acc[k4][i] = add_mul(acc[k4][i], g4, c[i]);  // complete: rows ty - 4 .. ty
      }
      const int y = y0 + ty - 4;
      if (ty < 4 || y >= h) continue;  // uniform across the block
      // the finished column sums at x0 - 2 .. x0 + 5
      const float vv[8] = {__shfl_up_sync(kAll, acc[k4][2], 1),
                           __shfl_up_sync(kAll, acc[k4][3], 1),
                           acc[k4][0], acc[k4][1], acc[k4][2], acc[k4][3],
                           __shfl_down_sync(kAll, acc[k4][0], 1),
                           __shfl_down_sync(kAll, acc[k4][1], 1)};
      if (!writes) continue;
      float s[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float blur = __fmul_rn(g0, vv[i]);
        blur = add_mul(blur, g1, vv[i + 1]);
        blur = add_mul(blur, g2, vv[i + 2]);
        blur = add_mul(blur, g3, vv[i + 3]);
        blur = add_mul(blur, g4, vv[i + 4]);
        s[i] = __saturatef(add_mul(blur, p.sharpness, __fsub_rn(cr[k2][i], blur)));
      }
#pragma unroll
      for (int o = 0; o < NOUT; ++o) {
        // the plane's channel, picked by a uniform select: indexing the
        // parameter arrays by the RGB form's runtime q % 3 puts them on a stack
        const int ch = NOUT == 3 ? o : q % 3;
        const float nm = ch == 0 ? p.norm_mean[0] : ch == 1 ? p.norm_mean[1] : p.norm_mean[2];
        const float ns = ch == 0 ? p.norm_std[0] : ch == 1 ? p.norm_std[1] : p.norm_std[2];
        const float nr = ch == 0 ? p.norm_rcp[0] : ch == 1 ? p.norm_rcp[1] : p.norm_rcp[2];
        float r[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) r[i] = div_rn(__fsub_rn(s[i], nm), ns, nr);
        TOut* dst = out + o * plane_size + y * w;
        if (vec) {
          store4(dst, r);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (x0 + i < w) store1(dst + i, r[i]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// crop: replaces ocr_system_tpu/kernels/crop_pallas.py::crop_boxes_matmul
//
// Per box n (page n / N), output (r, j) of an (H, W) crop samples the page
// bilinearly at ys = y0 + (y1 - y0) * r / (H - 1), xs = x0 + (x1 - x0) *
// j / (W - 1), each clamped into the page (border replication), scales by
// 1/255 and is zero for j >= w_valid[n]. As the reference, it blends the
// two source rows first, then the two columns.
//
// Bound: bytes, dominated by the output (crops x H x W in the compute
// dtype). Design: one block per (box, 16-row group). The block computes the
// column taps (floor index and fraction) of the box's valid columns once
// into shared memory, and each row's taps; then each thread makes 8
// consecutive outputs of a row at a time, each from 4 u8 taps read through
// L1, and writes them with one 16-byte store (bf16) or two (f32),
// consecutive threads on consecutive chunks, so a warp writes 512 or 1024
// contiguous bytes. Where W is not a multiple of 8 the rows are not
// 16-byte aligned, so every chunk is stored element by element, the last
// one masked at W. Chunks at or past w_valid are stored as zeros without
// touching the page. What holds it at 28-40% of its bound (PERF.md)
// is not the stores: the bf16 and float32 forms take about the same time.
// Staging the blended source rows in shared memory instead, with or
// without bank skew and word loads, measured no faster. Direct 4-tap
// gathers replace the TPU kernel's hat-weight matmuls on a 128-row slab,
// so no box height bound exists. The arithmetic rounds as the plain
// version's does (no contracted multiply-adds; the coordinates' division
// correctly rounded), so the float32 result equals it bit for bit.
constexpr int kCropThreads = 128;
constexpr int kCropRows = 16;   // output rows per block
constexpr int kCropChunk = 8;   // outputs per thread and store

__device__ __forceinline__ float crop_coord(float lo, float hi, int i, int n, int size) {
  const float s = __fadd_rn(lo, __fdiv_rn(__fmul_rn(hi - lo, (float)i), (float)(n - 1)));
  return fminf(fmaxf(s, 0.0f), (float)(size - 1));
}

__device__ __forceinline__ void store8(float* p, const float v[8]) {
  store4(p, v);
  store4(p + 4, v + 4);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float v[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// the first n (<= 8) outputs of a chunk: one vector store where the row
// is 16-byte aligned (vec), else one store each
template <typename TOut>
__device__ __forceinline__ void store_chunk(TOut* p, const float v[8], int n, bool vec) {
  if (vec) {
    store8(p, v);
    return;
  }
#pragma unroll
  for (int k = 0; k < kCropChunk; ++k)
    if (k < n) store1(p + k, v[k]);
}

// the plain version's u8 -> float * (1/255)
__device__ __forceinline__ float u8_scaled(const uint8_t* p) {
  return __fmul_rn(__int_as_float(0x4B000000u | __ldg(p)) - 8388608.0f, 1.0f / 255.0f);
}

// (1 - t) * a + t * b with the plain version's three roundings
__device__ __forceinline__ float lerp_rn(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(1.0f - t, a), __fmul_rn(t, b));
}

template <typename TOut>
__global__ void __launch_bounds__(kCropThreads) crop_kernel(
    const uint8_t* __restrict__ pages, const float* __restrict__ aabbs,
    const int32_t* __restrict__ w_valid, TOut* __restrict__ out, int n_per_page, int rows,
    int cols, int h_out, int w_out) {
  extern __shared__ __align__(16) unsigned char crop_smem[];
  const int w_pad = (w_out + kCropChunk - 1) / kCropChunk * kCropChunk;
  int* xa = reinterpret_cast<int*>(crop_smem);              // [w_pad]
  float* dxs = reinterpret_cast<float*>(xa + w_pad);        // [w_pad]
  int* ya = reinterpret_cast<int*>(dxs + w_pad);            // [kCropRows]
  int* yb = ya + kCropRows;                                 // [kCropRows]
  float* dys = reinterpret_cast<float*>(yb + kCropRows);    // [kCropRows]

  const int n = blockIdx.x;
  const int r0 = blockIdx.y * kCropRows;
  const int n_rows = min(kCropRows, h_out - r0);
  const float bx0 = aabbs[4 * n + 0], by0 = aabbs[4 * n + 1];
  const float bx1 = aabbs[4 * n + 2], by1 = aabbs[4 * n + 3];
  const int wv = min(max(w_valid[n], 0), w_out);
  for (int j = threadIdx.x; j < wv; j += kCropThreads) {
    const float xs = crop_coord(bx0, bx1, j, w_out, cols);
    const float xf = floorf(xs);
    xa[j] = (int)xf;
    dxs[j] = __fsub_rn(xs, xf);
  }
  for (int r = threadIdx.x; r < n_rows; r += kCropThreads) {
    const float ys = crop_coord(by0, by1, r0 + r, h_out, rows);
    const float yf = floorf(ys);
    ya[r] = (int)yf;
    yb[r] = min((int)yf + 1, rows - 1);
    dys[r] = __fsub_rn(ys, yf);
  }
  __syncthreads();

  const uint8_t* page = pages + (long long)(n / n_per_page) * rows * cols;
  const int chunks = w_pad / kCropChunk;
  const bool vec = w_pad == w_out;
  for (int i = threadIdx.x; i < n_rows * chunks; i += kCropThreads) {
    const int r = i / chunks;
    const int j0 = (i - r * chunks) * kCropChunk;
    TOut* dst = out + ((long long)n * h_out + r0 + r) * w_out + j0;
    float v[kCropChunk];
    if (j0 >= wv) {
#pragma unroll
      for (int k = 0; k < kCropChunk; ++k) v[k] = 0.0f;
      store_chunk(dst, v, w_out - j0, vec);
      continue;
    }
    const uint8_t* row_a = page + ya[r] * cols;
    const uint8_t* row_b = page + yb[r] * cols;
    const float dy = dys[r];
    const int4 xa_lo = *reinterpret_cast<const int4*>(xa + j0);
    const int4 xa_hi = *reinterpret_cast<const int4*>(xa + j0 + 4);
    const float4 dx_lo = *reinterpret_cast<const float4*>(dxs + j0);
    const float4 dx_hi = *reinterpret_cast<const float4*>(dxs + j0 + 4);
    const int xas[kCropChunk] = {xa_lo.x, xa_lo.y, xa_lo.z, xa_lo.w,
                                 xa_hi.x, xa_hi.y, xa_hi.z, xa_hi.w};
    const float dx[kCropChunk] = {dx_lo.x, dx_lo.y, dx_lo.z, dx_lo.w,
                                  dx_hi.x, dx_hi.y, dx_hi.z, dx_hi.w};
#pragma unroll
    for (int k = 0; k < kCropChunk; ++k) {
      if (j0 + k < wv) {
        const int a = xas[k], b = min(a + 1, cols - 1);
        const float left = lerp_rn(u8_scaled(row_a + a), u8_scaled(row_b + a), dy);
        const float right = lerp_rn(u8_scaled(row_a + b), u8_scaled(row_b + b), dy);
        v[k] = lerp_rn(left, right, dx[k]);
      } else {
        v[k] = 0.0f;
      }
    }
    store_chunk(dst, v, w_out - j0, vec);
  }
}

template <typename TIn, typename TOut, int NOUT>
int launch_enhance(const EnhanceArgs& p, int planes, cudaStream_t stream) {
  const dim3 grid((p.w + kEnhTileW - 1) / kEnhTileW, (p.h + kEnhRows - 1) / kEnhRows, planes);
  enhance_kernel<TIn, TOut, NOUT><<<grid, kEnhThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_crop(const uint8_t* pages, const float* aabbs, const int32_t* w_valid, void* out,
                int n_boxes, int n_per_page, int rows, int cols, int h_out, int w_out,
                cudaStream_t stream) {
  const size_t w_pad = (w_out + kCropChunk - 1) / kCropChunk * kCropChunk;
  const size_t smem = w_pad * 8 + kCropRows * 12;  // under 48 KB: w_out <= 6000
  const dim3 grid(n_boxes, (h_out + kCropRows - 1) / kCropRows);
  crop_kernel<TOut><<<grid, kCropThreads, smem, stream>>>(
      pages, aabbs, w_valid, static_cast<TOut*>(out), n_per_page, rows, cols, h_out, w_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// in_u8 = 1: `in` is (planes, h, w) u8 gray, out (planes, 3, h, w).
// in_u8 = 0: `in` is (planes, h, w) float32, three planes per image, out
// (planes, h, w). out_bf16 picks the output dtype (else float32).
int ocr_enhance(const void* in, int in_u8, void* out, int out_bf16, const float* means,
                int planes, int h, int w, float contrast, float sharpness,
                const float* gauss5, const float* norm_mean, const float* norm_std,
                void* stream) {
  EnhanceArgs p;
  p.in = in;
  p.out = out;
  p.means = means;
  p.h = h;
  p.w = w;
  p.contrast = contrast;
  p.sharpness = sharpness;
  for (int k = 0; k < 5; ++k) p.g[k] = gauss5[k];
  for (int k = 0; k < 3; ++k) {
    p.norm_mean[k] = norm_mean[k];
    p.norm_std[k] = norm_std[k];
    p.norm_rcp[k] = 1.0f / norm_std[k];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (in_u8) {
    return out_bf16 ? launch_enhance<uint8_t, __nv_bfloat16, 3>(p, planes, s)
                    : launch_enhance<uint8_t, float, 3>(p, planes, s);
  }
  return out_bf16 ? launch_enhance<float, __nv_bfloat16, 1>(p, planes, s)
                  : launch_enhance<float, float, 1>(p, planes, s);
}

// 2 <= w_out <= 6000 (the wrapper checks).
int ocr_crop(const uint8_t* pages, const float* aabbs, const int32_t* w_valid, void* out,
             int out_bf16, int n_boxes, int n_per_page, int rows, int cols, int h_out,
             int w_out, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  return out_bf16 ? launch_crop<__nv_bfloat16>(pages, aabbs, w_valid, out, n_boxes,
                                               n_per_page, rows, cols, h_out, w_out, s)
                  : launch_crop<float>(pages, aabbs, w_valid, out, n_boxes, n_per_page,
                                       rows, cols, h_out, w_out, s);
}

}  // extern "C"
