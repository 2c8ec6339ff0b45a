/*
 * C predict API over the PyTorch port's exported artifacts (MXTPTEXP1).
 *
 * The same functions and signatures as the JAX package's
 * native/c_predict_api.h, so a C program written for one links against
 * the other.  The artifact is what mxnet_tpu_torch.predictor.export_model
 * writes (a torch.export program with its JSON header); the library
 * embeds CPython and serves it with nothing but torch and numpy
 * (c_predict_serve.py, compiled into the library).  All tensors cross
 * the ABI as float32; integer-typed inputs (token ids) are cast inside
 * according to the dtype recorded in the artifact.
 *
 * Build: mxnet_tpu_torch._build.build_c_predict() compiles it with g++
 * against the running interpreter's headers and libpython, into the
 * kernel build directory, as libc_predict_api.<hash>.so.
 * Run time: PYTHONPATH names the site-packages that hold torch (with
 * PYTHONHOME unset).  MXNET_TPU_PREDICT_DEVICE picks the device (default
 * cuda); without a card MXTPUPredCreate fails, it never falls back to the
 * CPU.
 *
 * Every function returns 0 on success, -1 on failure; call
 * MXTPUGetLastError() for the message (thread-local).
 */
#ifndef MXTPU_C_PREDICT_API_H_
#define MXTPU_C_PREDICT_API_H_

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void *MXTPUPredictorHandle;

/* Load an exported artifact.  Initializes the embedded Python runtime
 * on first use. */
int MXTPUPredCreate(const char *artifact_path, MXTPUPredictorHandle *out);

int MXTPUPredGetInputCount(MXTPUPredictorHandle h, int *out);
/* name/shape pointers stay valid until MXTPUPredFree(h). */
int MXTPUPredGetInputInfo(MXTPUPredictorHandle h, int index,
                          const char **name, const int64_t **shape,
                          int *ndim);

/* Copy `size` floats in as input `name` (row-major, full tensor). */
int MXTPUPredSetInput(MXTPUPredictorHandle h, const char *name,
                      const float *data, size_t size);

/* Execute the program on the inputs set so far. */
int MXTPUPredForward(MXTPUPredictorHandle h);

int MXTPUPredGetOutputCount(MXTPUPredictorHandle h, int *out);
int MXTPUPredGetOutputShape(MXTPUPredictorHandle h, int index,
                            const int64_t **shape, int *ndim);
/* Copy output `index` into `out` (`size` = element count). */
int MXTPUPredGetOutput(MXTPUPredictorHandle h, int index, float *out,
                       size_t size);

int MXTPUPredFree(MXTPUPredictorHandle h);

const char *MXTPUGetLastError(void);

#ifdef __cplusplus
}
#endif

#endif /* MXTPU_C_PREDICT_API_H_ */
