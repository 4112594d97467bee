/* C API for auncel_tpu_torch (the ABI of auncel_tpu/c_api/auncel_c.h,
 * after the reference's c_api/ wrappers): create/train/add/search plus
 * the error-bounded search entry points, as a plain C ABI.
 *
 * The library embeds a CPython interpreter running the auncel_tpu_torch
 * runtime (PyTorch and the CUDA kernels); handles are opaque. Indexes
 * live on the device AUNCEL_C_DEVICE names ("cuda" unless set, e.g.
 * "cpu"). All functions
 * return 0 on success and a negative error code otherwise;
 * auncel_last_error() returns a description of the last failure.
 *
 * Thread-safety: calls are serialized through the embedded interpreter's
 * GIL; concurrent calls are safe but not parallel. */

#ifndef AUNCEL_C_H
#define AUNCEL_C_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct auncel_index auncel_index_t;
typedef struct auncel_errsys auncel_errsys_t;

/* ---- index lifecycle -------------------------------------------------- */

/* desc: factory string, e.g. "IVF1024,Flat", "Flat", "HNSW32", "PQ8";
 * metric: "l2" or "ip". */
int auncel_index_factory(auncel_index_t **out, int d, const char *desc,
                         const char *metric);
int auncel_index_train(auncel_index_t *idx, int64_t n, const float *x);
int auncel_index_add(auncel_index_t *idx, int64_t n, const float *x);
int auncel_index_ntotal(auncel_index_t *idx, int64_t *out);
/* nprobe <= 0 uses the index default. out_d: nq*k floats, out_i: nq*k
 * int64 ids (-1 padding). */
int auncel_index_search(auncel_index_t *idx, int64_t nq, const float *q,
                        int k, int nprobe, float *out_d, int64_t *out_i);
void auncel_index_free(auncel_index_t *idx);

/* ---- error-bounded search (the Auncel capability) --------------------- */

/* Build the error-profile system on an IVF index: computes value-
 * consistent ground truth for the training queries and trains the
 * phi->U maps (reference Error_sys::set_gt + sys_train). */
int auncel_errsys_new(auncel_errsys_t **out, auncel_index_t *idx,
                      int64_t train_nq, const float *train_q,
                      int max_topk);
/* Per-query error-bounded search: every query's recall@k is targeted at
 * >= require_acc; multipler/std_m are the calibration knobs
 * (hyperparameter.txt semantics; pass 0 to keep current values). */
int auncel_errsys_bounded_search(auncel_errsys_t *es, int64_t nq,
                                 const float *q, int k, float require_acc,
                                 float multipler, float std_m,
                                 float *out_d, int64_t *out_i);
void auncel_errsys_free(auncel_errsys_t *es);

const char *auncel_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* AUNCEL_C_H */
