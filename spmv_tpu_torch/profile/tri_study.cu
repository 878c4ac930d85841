// cuSPARSE's sparse triangular solve (SpSV) as a yardstick for the
// tri_solve kernel (csrc/tri_solve.cu): the same z = T^-1 b on the same
// CSR triangle, with the analysis done once when the state is made and
// only cusparseSpSV_solve timed.  Built by profile/tri_study.py into
// spmv_tpu_torch/_build/study/; no path of the port calls it.
//
// Plain C interface for ctypes: spsv_create makes the handle, the
// descriptors, the work buffer and the analysis; spsv_solve runs one
// solve on the stream it is given; spsv_destroy frees them.  Return codes are
// cusparseStatus_t, or kCudaError + a cudaError_t.

#include <cuda_runtime.h>
#include <cusparse.h>

#include <cstdint>
#include <new>

namespace {

constexpr int kCudaError = 1000;

struct Spsv {
  cusparseHandle_t handle = nullptr;
  cusparseSpMatDescr_t mat = nullptr;
  cusparseDnVecDescr_t b = nullptr;
  cusparseDnVecDescr_t z = nullptr;
  cusparseSpSVDescr_t sv = nullptr;
  void* buffer = nullptr;
  cudaDataType type = CUDA_R_32F;
  float one_f = 1.0f;
  double one_d = 1.0;

  const void* one() const {
    return type == CUDA_R_64F ? static_cast<const void*>(&one_d)
                              : static_cast<const void*>(&one_f);
  }
  ~Spsv() {
    if (buffer) cudaFree(buffer);
    if (sv) cusparseSpSV_destroyDescr(sv);
    if (z) cusparseDestroyDnVec(z);
    if (b) cusparseDestroyDnVec(b);
    if (mat) cusparseDestroySpMat(mat);
    if (handle) cusparseDestroy(handle);
  }
};

}  // namespace

#define SPSV_TRY(call)                                \
  do {                                                \
    cusparseStatus_t st_ = (call);                    \
    if (st_ != CUSPARSE_STATUS_SUCCESS) {             \
      delete s;                                       \
      return static_cast<int>(st_);                   \
    }                                                 \
  } while (0)

// dtype 0 = float32, 1 = float64; row_ptr and cols int32 on the device;
// lower: the fill mode; unit: the diagonal is 1 and not read.
extern "C" int spsv_create(int dtype, long long n, long long nnz,
                           void* row_ptr, void* cols, void* vals, int lower,
                           int unit, void* b, void* z, void* stream,
                           void** out) {
  Spsv* s = new (std::nothrow) Spsv();
  if (!s) return kCudaError + cudaErrorMemoryAllocation;
  s->type = dtype == 1 ? CUDA_R_64F : CUDA_R_32F;
  SPSV_TRY(cusparseCreate(&s->handle));
  SPSV_TRY(cusparseSetStream(s->handle, static_cast<cudaStream_t>(stream)));
  SPSV_TRY(cusparseCreateCsr(&s->mat, n, n, nnz, row_ptr, cols, vals,
                             CUSPARSE_INDEX_32I, CUSPARSE_INDEX_32I,
                             CUSPARSE_INDEX_BASE_ZERO, s->type));
  cusparseFillMode_t fill =
      lower ? CUSPARSE_FILL_MODE_LOWER : CUSPARSE_FILL_MODE_UPPER;
  cusparseDiagType_t diag =
      unit ? CUSPARSE_DIAG_TYPE_UNIT : CUSPARSE_DIAG_TYPE_NON_UNIT;
  SPSV_TRY(cusparseSpMatSetAttribute(s->mat, CUSPARSE_SPMAT_FILL_MODE, &fill,
                                     sizeof(fill)));
  SPSV_TRY(cusparseSpMatSetAttribute(s->mat, CUSPARSE_SPMAT_DIAG_TYPE, &diag,
                                     sizeof(diag)));
  SPSV_TRY(cusparseCreateDnVec(&s->b, n, b, s->type));
  SPSV_TRY(cusparseCreateDnVec(&s->z, n, z, s->type));
  SPSV_TRY(cusparseSpSV_createDescr(&s->sv));
  size_t bytes = 0;
  SPSV_TRY(cusparseSpSV_bufferSize(
      s->handle, CUSPARSE_OPERATION_NON_TRANSPOSE, s->one(), s->mat, s->b,
      s->z, s->type, CUSPARSE_SPSV_ALG_DEFAULT, s->sv, &bytes));
  cudaError_t e = cudaMalloc(&s->buffer, bytes > 0 ? bytes : 1);
  if (e != cudaSuccess) {
    delete s;
    return kCudaError + e;
  }
  SPSV_TRY(cusparseSpSV_analysis(
      s->handle, CUSPARSE_OPERATION_NON_TRANSPOSE, s->one(), s->mat, s->b,
      s->z, s->type, CUSPARSE_SPSV_ALG_DEFAULT, s->sv, s->buffer));
  *out = s;
  return 0;
}

// One solve on `stream` (so a CUDA graph can capture it).
extern "C" int spsv_solve(void* state, void* stream) {
  Spsv* s = static_cast<Spsv*>(state);
  cusparseStatus_t st =
      cusparseSetStream(s->handle, static_cast<cudaStream_t>(stream));
  if (st != CUSPARSE_STATUS_SUCCESS) return static_cast<int>(st);
  return static_cast<int>(cusparseSpSV_solve(
      s->handle, CUSPARSE_OPERATION_NON_TRANSPOSE, s->one(), s->mat, s->b,
      s->z, s->type, CUSPARSE_SPSV_ALG_DEFAULT, s->sv));
}

extern "C" void spsv_destroy(void* state) { delete static_cast<Spsv*>(state); }

extern "C" const char* spsv_error(int code) {
  if (code >= kCudaError)
    return cudaGetErrorString(static_cast<cudaError_t>(code - kCudaError));
  return cusparseGetErrorString(static_cast<cusparseStatus_t>(code));
}
