// Device helpers shared by the port's CUDA sources: operand-type
// conversions and the NF4 level table.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace salr {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// v rounded to the operand type T and widened back: how the reference
// feeds a dequantized weight or K/V entry into an f32 product.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// The 16 NF4 levels (QLoRA): the float32 values of
// repro_torch.core.quant.NF4_LEVELS, written bit for bit as hex literals.
__constant__ float NF4_LEVELS[16] = {
    -0x1.000000p+0f, -0x1.647362p-1f, -0x1.0cd660p-1f, -0x1.946540p-2f,
    -0x1.23449ap-2f, -0x1.7a6a7ep-3f, -0x1.74f0e2p-4f, 0x0.0p+0f,
    0x1.45f5fep-4f,  0x1.4995c6p-3f,  0x1.f809bap-3f,  0x1.5a0674p-2f,
    0x1.c34970p-2f,  0x1.200f56p-1f,  0x1.722766p-1f,  0x1.000000p+0f,
};

// Copy the level table into shared memory (a lookup whose lanes hit
// different entries; the constant cache would serialise them).  A
// __syncthreads must follow before the table is read.
__device__ __forceinline__ void load_nf4_table(float* lut) {
  if (threadIdx.x < 16) lut[threadIdx.x] = NF4_LEVELS[threadIdx.x];
}

}  // namespace salr
