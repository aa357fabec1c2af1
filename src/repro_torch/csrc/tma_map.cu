// TMA tensor maps, encoded on the host for the kernels that copy with TMA
// (paged_attention.cu and flash_prefill.cu over the paged K/V pools,
// rglru_scan.cu over its (B, T, W) inputs and output). kernels/tma.py
// gives each map's geometry: the tensor's dims (innermost first), its
// byte strides and the box one TMA copy moves. The encoder,
// cuTensorMapEncodeTiled, is looked up in the libcuda already loaded, so
// nothing links against it.
#include <cuda.h>
#include <dlfcn.h>
#include <string.h>

namespace {
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);
}  // namespace

// Writes the 128-byte map to `map_out`. dims: `rank` (1-5) sizes in
// elements, innermost first; strides: the rank - 1 outer strides in bytes;
// box: `rank` sizes of one copy. dtype: 0 = float32, 1 = bfloat16;
// swizzle128: 0 = none, 1 = 128-byte swizzle (the tensor cores' layout).
// Elements outside the tensor read as 0 and are not written. Returns 0 or
// a CUresult.
extern "C" int tma_encode(void* map_out, const void* base, int rank,
                          const long long* dims, const long long* strides,
                          const int* box, int dtype, int swizzle128) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (!h) return (int)CUDA_ERROR_NOT_FOUND;
    encode = (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
    if (!encode) return (int)CUDA_ERROR_NOT_FOUND;
  }
  if (rank < 1 || rank > 5) return (int)CUDA_ERROR_INVALID_VALUE;
  cuuint64_t d[5], s[4];
  cuuint32_t bx[5], estr[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    estr[i] = 1;
    if (i + 1 < rank) s[i] = (cuuint64_t)strides[i];
  }
  CUtensorMap map;
  const CUresult r = encode(
      &map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      (cuuint32_t)rank, const_cast<void*>(base), d, s, bx, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) memcpy(map_out, &map, sizeof(map));
  return (int)r;
}
