/* A pure-C driver of the C predict API: loads an exported artifact, feeds
 * one float32 input tensor from a file, runs the forward `reps` times
 * (default 1), timing each call on the host's monotonic clock, and writes
 * every output tensor of the last forward to a file.
 *
 * Usage: predict_driver model.mxtpt in.bin out.bin [reps]
 * Prints the input's name and size, one line "forward_ms t1 t2 ...", the
 * median as "median_forward_ms t", and "served N outputs ok".  A failed
 * call prints MXTPUGetLastError() and exits 1; bad arguments or files
 * exit 2.  Being C proves that the ABI needs no C++ or Python on the
 * caller's side. */
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#include "c_predict_api.h"

static void die(const char *what) {
  fprintf(stderr, "%s: %s\n", what, MXTPUGetLastError());
  exit(1);
}

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static int cmp_double(const void *a, const void *b) {
  double x = *(const double *)a, y = *(const double *)b;
  return (x > y) - (x < y);
}

int main(int argc, char **argv) {
  if (argc != 4 && argc != 5) {
    fprintf(stderr, "usage: %s model.mxtpt in.bin out.bin [reps]\n",
            argv[0]);
    return 2;
  }
  int reps = argc == 5 ? atoi(argv[4]) : 1;
  if (reps < 1) {
    fprintf(stderr, "reps must be at least 1, got %s\n", argv[4]);
    return 2;
  }
  MXTPUPredictorHandle h;
  if (MXTPUPredCreate(argv[1], &h) != 0) die("create");

  int n_in;
  MXTPUPredGetInputCount(h, &n_in);
  if (n_in != 1) {
    fprintf(stderr, "expected 1 input, got %d\n", n_in);
    return 2;
  }
  const char *name;
  const int64_t *shape;
  int ndim;
  if (MXTPUPredGetInputInfo(h, 0, &name, &shape, &ndim) != 0)
    die("input info");
  size_t need = 1;
  for (int i = 0; i < ndim; ++i) need *= (size_t)shape[i];
  printf("input %s ndim=%d elems=%zu\n", name, ndim, need);

  float *buf = (float *)malloc(need * sizeof(float));
  FILE *f = fopen(argv[2], "rb");
  if (buf == NULL || f == NULL ||
      fread(buf, sizeof(float), need, f) != need) {
    fprintf(stderr, "short read on %s\n", argv[2]);
    return 2;
  }
  fclose(f);
  if (MXTPUPredSetInput(h, name, buf, need) != 0) die("set input");

  double *ms = (double *)malloc(reps * sizeof(double));
  if (ms == NULL) return 2;
  printf("forward_ms");
  for (int r = 0; r < reps; ++r) {
    double t0 = now_ms();
    if (MXTPUPredForward(h) != 0) die("forward");
    ms[r] = now_ms() - t0;
    printf(" %.6f", ms[r]);
  }
  printf("\n");
  qsort(ms, reps, sizeof(double), cmp_double);
  printf("median_forward_ms %.6f\n",
         reps % 2 ? ms[reps / 2] : 0.5 * (ms[reps / 2 - 1] + ms[reps / 2]));

  int n_out;
  if (MXTPUPredGetOutputCount(h, &n_out) != 0) die("output count");
  FILE *g = fopen(argv[3], "wb");
  if (!g) {
    fprintf(stderr, "cannot open %s for writing\n", argv[3]);
    return 2;
  }
  for (int i = 0; i < n_out; ++i) {
    const int64_t *oshape;
    int ondim;
    if (MXTPUPredGetOutputShape(h, i, &oshape, &ondim) != 0)
      die("output shape");
    size_t oelems = 1;
    for (int d = 0; d < ondim; ++d) oelems *= (size_t)oshape[d];
    float *out = (float *)malloc(oelems * sizeof(float));
    if (out == NULL) return 2;
    if (MXTPUPredGetOutput(h, i, out, oelems) != 0) die("get output");
    fwrite(out, sizeof(float), oelems, g);
    free(out);
  }
  fclose(g);
  free(ms);
  free(buf);
  MXTPUPredFree(h);
  printf("served %d outputs ok\n", n_out);
  return 0;
}
