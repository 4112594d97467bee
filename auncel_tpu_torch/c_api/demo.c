/* Minimal C client of the auncel_tpu_torch C API: build an IVF index from
 * C buffers, run fixed-nprobe and error-bounded searches, sanity-check the
 * results and print the ids each search returned (one line each, "fixed:"
 * and "bounded:", row-major). Mirrors the usage pattern of the
 * reference's c_api tests. */

#include "auncel_c.h"
#include <stdio.h>
#include <stdlib.h>

static void print_ids(const char *label, const int64_t *ids, int n) {
  printf("%s:", label);
  for (int i = 0; i < n; i++) printf(" %lld", (long long)ids[i]);
  printf("\n");
}

#define D 16
#define NB 4000
#define NQ 32
#define K 5

static float frand(unsigned *s) {
  *s = *s * 1103515245u + 12345u;
  return (float)((*s >> 8) & 0xFFFF) / 65536.0f;
}

int main(void) {
  unsigned seed = 7;
  float *xb = malloc(sizeof(float) * NB * D);
  float *xq = malloc(sizeof(float) * NQ * D);
  for (long i = 0; i < NB * D; i++) xb[i] = frand(&seed);
  for (long i = 0; i < NQ * D; i++) xq[i] = xb[i];  /* queries = corpus rows */

  auncel_index_t *idx = NULL;
  if (auncel_index_factory(&idx, D, "IVF32,Flat", "l2")) {
    fprintf(stderr, "factory: %s\n", auncel_last_error());
    return 1;
  }
  if (auncel_index_train(idx, NB, xb) || auncel_index_add(idx, NB, xb)) {
    fprintf(stderr, "train/add: %s\n", auncel_last_error());
    return 1;
  }
  int64_t n = 0;
  auncel_index_ntotal(idx, &n);
  if (n != NB) { fprintf(stderr, "ntotal %lld\n", (long long)n); return 1; }

  float d_out[NQ * K];
  int64_t i_out[NQ * K];
  if (auncel_index_search(idx, NQ, xq, K, 32, d_out, i_out)) {
    fprintf(stderr, "search: %s\n", auncel_last_error());
    return 1;
  }
  print_ids("fixed", i_out, NQ * K);
  /* full-scan search of a corpus row must return itself first */
  int self_hits = 0;
  for (int q = 0; q < NQ; q++) self_hits += (i_out[q * K] == q);
  if (self_hits < NQ - 1) {
    fprintf(stderr, "self-hit %d/%d\n", self_hits, NQ);
    return 1;
  }

  auncel_errsys_t *es = NULL;
  if (auncel_errsys_new(&es, idx, NQ, xq, 20)) {
    fprintf(stderr, "errsys: %s\n", auncel_last_error());
    return 1;
  }
  if (auncel_errsys_bounded_search(es, NQ, xq, K, 0.9f, 4.0f, 1.0f,
                                   d_out, i_out)) {
    fprintf(stderr, "bounded: %s\n", auncel_last_error());
    return 1;
  }
  print_ids("bounded", i_out, NQ * K);
  self_hits = 0;
  for (int q = 0; q < NQ; q++) self_hits += (i_out[q * K] == q);
  printf("c_api demo: ok (bounded self-hit %d/%d)\n", self_hits, NQ);
  auncel_errsys_free(es);
  auncel_index_free(idx);
  free(xb); free(xq);
  return self_hits >= NQ - 1 ? 0 : 1;
}
