// Host side of the TMA copies (Hopper's tensor memory accelerator) of the
// bf16 kernels under csrc/: the tensor map of a [batch, heads, rows, cols]
// operand addressed through element strides, encoded by
// cuTensorMapEncodeTiled, whose entry point the CUDA runtime hands out
// (the libraries link no libcuda).  A map is passed to its kernel by value (__grid_constant__),
// so a CUDA graph that captures the launch keeps it.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace scat_tma {

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the tensor maps of a kernel's K operands, passed to it by value
// (__grid_constant__); row_dim[i] is where operand i's row coordinate
// goes (1 or 2, encode_rows), the head's the other
template <int K>
struct Maps {
  CUtensorMap op[K];
  int row_dim[K];
};

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the 4-D map of a bf16 operand [batch, heads, rows, cols] (element strides
// sb, sh, sn; the columns contiguous): the columns innermost, then rows and
// heads in the order of their strides (a map's strides grow outwards),
// then batch; *row_dim is where the row coordinate goes (1 or 2), the
// head's the other.  Boxes of box_rows x box_cols (box_cols * 2 bytes <=
// 128) land in the 128-byte swizzled layout; what lies past rows or cols
// reads as zeros.  Every stride must be a multiple of 8 elements and ptr
// 16-byte aligned.
inline cudaError_t encode_rows(CUtensorMap* map, const void* ptr,
                               long long sb, long long sh, long long sn,
                               int batch, int heads, int rows, int cols,
                               int box_rows, int box_cols, int* row_dim) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const bool rows_first = sn <= sh;
  *row_dim = rows_first ? 1 : 2;
  const cuuint64_t dims[4] = {cuuint64_t(cols),
                              cuuint64_t(rows_first ? rows : heads),
                              cuuint64_t(rows_first ? heads : rows),
                              cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(2 * (rows_first ? sn : sh)),
                                 cuuint64_t(2 * (rows_first ? sh : sn)),
                                 cuuint64_t(2 * sb)};
  const cuuint32_t box[4] = {cuuint32_t(box_cols),
                             cuuint32_t(rows_first ? box_rows : 1),
                             cuuint32_t(rows_first ? 1 : box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace scat_tma
