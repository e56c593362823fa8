/* A C client of the inference ABI (paddle_tpu_c.h): loads an exported
 * model with one float32 input of shape [2, 8], feeds it the values
 * i / 16 - 0.5 (i = 0..15, row-major) and prints the first output's rank,
 * its dims and its values, one a line.  Exit codes: 2 create failed, 3 run
 * failed (the reason on stderr, from pd_last_error).
 *
 *   gcc capi_example.c <c_api_path()> -I<this directory> \
 *       -Wl,-rpath,<the library's directory> -o capi_example
 *   ./capi_example prefix.pdmodel prefix.pdiparams
 */
#include <stdio.h>
#include <stdlib.h>

#include "paddle_tpu_c.h"

int main(int argc, char** argv) {
  if (argc != 3) {
    fprintf(stderr, "usage: %s model.pdmodel model.pdiparams\n", argv[0]);
    return 1;
  }
  void* pred = pd_predictor_create(argv[1], argv[2]);
  if (!pred) {
    fprintf(stderr, "create: %s\n", pd_last_error());
    return 2;
  }
  float in[2 * 8];
  for (int i = 0; i < 16; i++) in[i] = (float)i / 16.0f - 0.5f;
  const float* inputs[1] = {in};
  int64_t shape[2] = {2, 8};
  const int64_t* shapes[1] = {shape};
  int ndims[1] = {2};
  float* out = NULL;
  int64_t out_shape[8];
  int out_ndim = 0;
  int rc = pd_predictor_run(pred, inputs, shapes, ndims, 1, &out, out_shape,
                            8, &out_ndim);
  if (rc != 0) {
    fprintf(stderr, "run: %s\n", pd_last_error());
    return 3;
  }
  long long numel = 1;
  for (int d = 0; d < out_ndim; d++) numel *= out_shape[d];
  printf("%d\n", out_ndim);
  for (int d = 0; d < out_ndim; d++) printf("%lld\n", (long long)out_shape[d]);
  for (long long i = 0; i < numel; i++) printf("%.9g\n", out[i]);
  pd_free(out);
  pd_predictor_destroy(pred);
  return 0;
}
