/* A C host of lib_lightgbm_tpu_torch.so: trains a booster from a text file
 * through the LGBM_* ABI alone and saves its model, as a C, R or Java
 * program would.  Built by ``python -m lightgbm_tpu_torch.capi_build
 * --host`` beside the library (build/capi/lightgbm_tpu_torch_capi_host).
 *
 * Usage:
 *   lightgbm_tpu_torch_capi_host <data file> <parameters> <iterations>
 *                                <model out>
 *
 * <parameters> is one LightGBM parameter string ("key=value key=value"),
 * given to LGBM_DatasetCreateFromFile and LGBM_BoosterCreate alike.  The
 * device is the C ABI's (cuda unless LIGHTGBM_TPU_TORCH_DEVICE=cpu).  It
 * prints one line of seconds a step ("load", "create", each iteration,
 * "save") and exits 0, or prints LGBM_GetLastError() and exits 1.
 */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#include "lightgbm_tpu_torch_c_api.h"

static double now(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

static int fail(const char *what) {
  fprintf(stderr, "capi_host: %s: %s\n", what, LGBM_GetLastError());
  return 1;
}

int main(int argc, char **argv) {
  DatasetHandle data = NULL;
  BoosterHandle booster = NULL;
  int iterations, finished = 0, i;
  double t;
  if (argc != 5) {
    fprintf(stderr, "usage: %s <data file> <parameters> <iterations> "
                    "<model out>\n", argv[0]);
    return 2;
  }
  iterations = atoi(argv[3]);
  t = now();
  if (LGBM_DatasetCreateFromFile(argv[1], argv[2], NULL, &data) != 0)
    return fail("LGBM_DatasetCreateFromFile");
  printf("load %.4f\n", now() - t);
  t = now();
  if (LGBM_BoosterCreate(data, argv[2], &booster) != 0)
    return fail("LGBM_BoosterCreate");
  printf("create %.4f\n", now() - t);
  for (i = 0; i < iterations && !finished; ++i) {
    t = now();
    if (LGBM_BoosterUpdateOneIter(booster, &finished) != 0)
      return fail("LGBM_BoosterUpdateOneIter");
    printf("iteration %d %.4f\n", i, now() - t);
  }
  t = now();
  if (LGBM_BoosterSaveModel(booster, 0, -1, argv[4]) != 0)
    return fail("LGBM_BoosterSaveModel");
  printf("save %.4f\n", now() - t);
  if (LGBM_BoosterFree(booster) != 0) return fail("LGBM_BoosterFree");
  if (LGBM_DatasetFree(data) != 0) return fail("LGBM_DatasetFree");
  fflush(stdout);
  return 0;
}
