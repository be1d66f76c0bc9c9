// Raster connected-components labelling for the device line detector, as a
// CUDA kernel called through the XLA foreign function interface.
//
// Semantics are exactly those of lines_device._connected_components (the
// XLA lax.scan formulation, which stays as the reference and the CPU path):
// labels start at the flat pixel index; each half pass walks the rows in
// order (descending, then ascending), injects the minimum label of the
// final previous row through the N/NW/NE (S/SW/SE when ascending) edges,
// then gives every pixel the minimum over its W/E-connected run of the row.
// `pairs` descending+ascending pairs run. Only integer minima are taken, so
// the labels equal the scan's bit for bit.
//
// One block per image. The rows are a loop inside the block; the previous
// row's labels stay in shared memory. Each thread owns C contiguous pixels
// of every row (and is the only one to read or write their labels in global
// memory). The run minimum is one block-wide max-scan of run starts (warp
// shuffles + one shared word per warp) and one shared-memory atomicMin per
// run piece a thread holds. Two block barriers per row.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

// bit index of each neighbour direction in the packed edge mask; must match
// ccl_gpu._BIT
constexpr int kNW = 0, kN = 1, kNE = 2, kW = 3, kE = 4, kSW = 5, kS = 6,
              kSE = 7;
constexpr int kThreads = 256;  // threads per block before chunking
constexpr int kMaxChunk = 8;   // so rows up to 2048 pixels

__device__ __forceinline__ int warp_inclusive_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v = max(v, o);
  }
  return v;
}

template <int C>
__global__ void ccl_kernel(const uint8_t* __restrict__ masks,
                           int32_t* __restrict__ labels, int h, int w,
                           int pairs) {
  extern __shared__ int smem[];
  int* row_buf = smem;          // [2][w] final labels of the last two rows
  int* seg_buf = smem + 2 * w;  // [2][w] run minimum, indexed by run start
  int* warp_buf = smem + 4 * w; // [2][32] inclusive max of each warp

  const size_t img = static_cast<size_t>(blockIdx.x) * h * w;
  const uint8_t* m_img = masks + img;
  int32_t* lab = labels + img;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int x0 = t * C;

  int parity = 0;
  for (int half = 0; half < 2 * pairs; ++half) {
    const bool asc = half & 1;
    const int b_up = asc ? kS : kN;
    const int b_upl = asc ? kSW : kNW;
    const int b_upr = asc ? kSE : kNE;
    for (int r = 0; r < h; ++r) {
      const int y = asc ? h - 1 - r : r;
      const uint8_t* mrow = m_img + static_cast<size_t>(y) * w;
      int32_t* lrow = lab + static_cast<size_t>(y) * w;
      const int* prev = row_buf + (parity ^ 1) * w;
      int* cur = row_buf + parity * w;
      int* seg = seg_buf + parity * w;
      int* wtot = warp_buf + parity * 32;

      uint8_t m[C];
      int v[C];
      int last_break = -1;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int x = x0 + i;
        m[i] = 0;
        v[i] = INT_MAX;
        if (x < w) {
          // clear bits that would point outside the image (a valid mask
          // never sets them) so no read leaves the row buffers
          uint8_t mm = mrow[x];
          if (x == 0) mm &= ~((1 << kW) | (1 << kNW) | (1 << kSW));
          if (x == w - 1) mm &= ~((1 << kNE) | (1 << kSE));
          if (r == 0) mm &= (1 << kW) | (1 << kE);
          m[i] = mm;
          v[i] = half == 0 ? y * w + x : lrow[x];
          seg[x] = INT_MAX;
          if (!((m[i] >> kW) & 1)) last_break = x;
        }
      }
      const int inc = warp_inclusive_max(last_break, lane);
      if (lane == 31) wtot[warp] = inc;
      __syncthreads();

      // start of the run that reaches into this chunk from the left
      int carry = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) carry = -1;
      for (int k = 0; k < warp; ++k) carry = max(carry, wtot[k]);

      int start[C];
      int s = carry;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int x = x0 + i;
        start[i] = -1;
        if (x < w) {
          int val = v[i];
          if ((m[i] >> b_up) & 1) val = min(val, prev[x]);
          if ((m[i] >> b_upl) & 1) val = min(val, prev[x - 1]);
          if ((m[i] >> b_upr) & 1) val = min(val, prev[x + 1]);
          v[i] = val;
          if (!((m[i] >> kW) & 1)) s = x;
          start[i] = s;
        }
      }
      int open = -1, run = INT_MAX;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (start[i] < 0) continue;
        if (start[i] != open) {
          if (open >= 0) atomicMin(&seg[open], run);
          open = start[i];
          run = v[i];
        } else {
          run = min(run, v[i]);
        }
      }
      if (open >= 0) atomicMin(&seg[open], run);
      __syncthreads();

#pragma unroll
      for (int i = 0; i < C; ++i) {
        if (start[i] < 0) continue;
        const int o = seg[start[i]];
        lrow[x0 + i] = o;
        cur[x0 + i] = o;
      }
      parity ^= 1;
    }
  }
}

template <int C>
cudaError_t launch(cudaStream_t stream, const uint8_t* masks, int32_t* labels,
                   int64_t batch, int h, int w, int pairs) {
  const int threads = ((w + C - 1) / C + 31) / 32 * 32;
  const size_t smem = (4 * static_cast<size_t>(w) + 64) * sizeof(int);
  ccl_kernel<C><<<static_cast<unsigned>(batch), threads, smem, stream>>>(
      masks, labels, h, w, pairs);
  return cudaGetLastError();
}

ffi::Error CclImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> masks,
                   ffi::ResultBuffer<ffi::S32> labels, int32_t pairs) {
  const auto dims = masks.dimensions();
  if (dims.size() < 2) {
    return ffi::Error::InvalidArgument("ccl: edge masks must be (..., H, W)");
  }
  const int64_t h = dims[dims.size() - 2], w = dims[dims.size() - 1];
  int64_t batch = 1;
  for (size_t i = 0; i + 2 < dims.size(); ++i) batch *= dims[i];
  if (w > kThreads * kMaxChunk || h * w > INT_MAX || pairs < 1) {
    return ffi::Error::InvalidArgument("ccl: unsupported image shape");
  }
  if (batch == 0 || h == 0 || w == 0) return ffi::Error::Success();
  const int chunk = static_cast<int>((w + kThreads - 1) / kThreads);
  const uint8_t* m = masks.typed_data();
  int32_t* out = labels->typed_data();
  const int hi = static_cast<int>(h), wi = static_cast<int>(w);
  cudaError_t err;
  switch (chunk) {
    case 1: err = launch<1>(stream, m, out, batch, hi, wi, pairs); break;
    case 2: err = launch<2>(stream, m, out, batch, hi, wi, pairs); break;
    case 3: err = launch<3>(stream, m, out, batch, hi, wi, pairs); break;
    case 4: err = launch<4>(stream, m, out, batch, hi, wi, pairs); break;
    case 5: err = launch<5>(stream, m, out, batch, hi, wi, pairs); break;
    case 6: err = launch<6>(stream, m, out, batch, hi, wi, pairs); break;
    case 7: err = launch<7>(stream, m, out, batch, hi, wi, pairs); break;
    default: err = launch<8>(stream, m, out, batch, hi, wi, pairs); break;
  }
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(VpRasterCcl, CclImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Ret<ffi::Buffer<ffi::S32>>()
                                  .Attr<int32_t>("pairs"));
