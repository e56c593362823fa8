/* C inference API for paddle_tpu_torch (see capi.cc).
 *
 * Counterpart of the reference C prediction ABI
 * (paddle/fluid/inference/capi/c_api.h); Go programs wrap this header via
 * cgo exactly as the reference's go/paddle/predictor.go wrapped theirs.
 * The same ABI as the JAX package's paddle_tpu_c.h.
 *
 * All functions are thread-compatible (one embedded CPython runtime per
 * process; calls serialize on the GIL).
 */
#ifndef PADDLE_TPU_C_H_
#define PADDLE_TPU_C_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Create a predictor from an exported model (paddle_tpu_torch.inference
 * save_inference_model artifacts: prefix.pdmodel / prefix.pdiparams) on
 * the card, or on the device PADDLE_TPU_TORCH_C_DEVICE names ("cpu").
 * Returns NULL on failure — see pd_last_error(). */
void* pd_predictor_create(const char* model_path, const char* params_path);

void pd_predictor_destroy(void* predictor);

/* Run inference: n_inputs float32 row-major buffers with the given
 * shapes.  On success (return 0) the FIRST output is malloc'd into
 * *out_data (free with pd_free), its shape written to out_shape
 * (capacity out_shape_cap) and rank to *out_ndim. */
int pd_predictor_run(void* predictor, const float** inputs,
                     const int64_t* const* shapes, const int* ndims,
                     int n_inputs, float** out_data, int64_t* out_shape,
                     int out_shape_cap, int* out_ndim);

const char* pd_last_error(void);
void pd_free(void* p);

#ifdef __cplusplus
}
#endif

#endif /* PADDLE_TPU_C_H_ */
