// TMA tensor maps for the paged K/V pools (used by paged_attention.cu and
// flash_prefill.cu). A map describes a whole pool as a 2-D tensor of
// `rows` rows x `cols` elements (a page row of all KV heads, Hkv * hd) and
// the box one TMA load copies (box_cols x box_rows: one page of one KV head
// for decode, unswizzled; 64 columns of one page for prefill, written with
// the 128-byte swizzle the tensor cores read). It is
// built once per pool on the host; a layer's view is reached by a row
// offset passed to the kernel. The encoder, cuTensorMapEncodeTiled, is
// looked up in the libcuda already loaded, so nothing links against it.
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

// Writes the 128-byte map to `map_out`. dtype: 0 = float32, 1 = bfloat16;
// swizzle128: 0 = none, 1 = 128-byte swizzle. Returns 0 or a CUresult.
extern "C" int tma_make_map(void* map_out, const void* base, long long rows,
                            int cols, int dtype, int box_cols, int box_rows,
                            int swizzle128) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!h) h = dlopen("libcuda.so.1", RTLD_NOW);
    if (!h) return (int)CUDA_ERROR_NOT_FOUND;
    encode = (EncodeTiled)dlsym(h, "cuTensorMapEncodeTiled");
    if (!encode) return (int)CUDA_ERROR_NOT_FOUND;
  }
  const size_t elem = dtype == 0 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = encode(
      &map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) memcpy(map_out, &map, sizeof(map));
  return (int)r;
}
