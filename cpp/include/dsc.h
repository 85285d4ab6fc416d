/* dsc_tpu C ABI — the C front door to the JAX/XLA runtime.
 *
 * Rebuild of the reference C ABI surface (reference dsc/include/dsc.h:85-428).
 * The reference exposes a C++ core through extern "C"; here the runtime is
 * the JAX/XLA/PJRT stack, reached through an embedded CPython interpreter
 * (src/dsc_shim.cpp), so C/C++ callers share the same context, FFT plan
 * cache and tracing ring as Python callers (parity with the reference's
 * shared dsc::ctx, dsc_api.h:26).
 *
 * Tensors are opaque int64 handles; DSC_NONE marks "value not given" like
 * the reference's DSC_VALUE_NONE (dsc.h:78).
 */

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef int64_t dsc_tensor_h;

typedef enum dsc_dtype {
    DSC_F32 = 0,
    DSC_F64 = 1,
    DSC_C32 = 2,
    DSC_C64 = 3,
} dsc_dtype;

#define DSC_NONE      INT32_MAX
#define DSC_MAX_DIMS  4
#define DSC_INVALID   ((dsc_tensor_h) 0)

/* -- context ------------------------------------------------------------ */
int         dsc_ctx_init(size_t main_mem, size_t scratch_mem);
void        dsc_ctx_clear(void);
size_t      dsc_used_mem(void);
void        dsc_tensor_free(dsc_tensor_h h);
/* last error message (empty string if none); returns length */
int         dsc_last_error(char *buf, size_t buf_size);

/* -- creation / interop -------------------------------------------------- */
dsc_tensor_h dsc_tensor_from_buffer(const void *data, dsc_dtype dtype,
                                    int n_dim, const int *shape);
int          dsc_tensor_to_buffer(dsc_tensor_h h, void *out, size_t out_size);
int          dsc_tensor_ndim(dsc_tensor_h h);
int          dsc_tensor_shape(dsc_tensor_h h, int *shape_out /* MAX_DIMS */);
dsc_dtype    dsc_tensor_dtype(dsc_tensor_h h);
int64_t      dsc_tensor_ne(dsc_tensor_h h);
size_t       dsc_tensor_nbytes(dsc_tensor_h h);

dsc_tensor_h dsc_wrap(double re, double im, dsc_dtype dtype);
dsc_tensor_h dsc_arange(int n, dsc_dtype dtype);
dsc_tensor_h dsc_randn(int n_dim, const int *shape, dsc_dtype dtype);
dsc_tensor_h dsc_full(int n_dim, const int *shape, double re, double im,
                      dsc_dtype dtype);

/* -- binary ops (reference dsc.h:256-300) -------------------------------- */
dsc_tensor_h dsc_add(dsc_tensor_h a, dsc_tensor_h b);
dsc_tensor_h dsc_sub(dsc_tensor_h a, dsc_tensor_h b);
dsc_tensor_h dsc_mul(dsc_tensor_h a, dsc_tensor_h b);
dsc_tensor_h dsc_div(dsc_tensor_h a, dsc_tensor_h b);
dsc_tensor_h dsc_pow(dsc_tensor_h a, dsc_tensor_h b);
/* scalar rhs/lhs variants; reflected != 0 computes scalar <op> tensor */
dsc_tensor_h dsc_add_scalar(dsc_tensor_h a, double re, double im,
                            int is_complex, int reflected);
dsc_tensor_h dsc_sub_scalar(dsc_tensor_h a, double re, double im,
                            int is_complex, int reflected);
dsc_tensor_h dsc_mul_scalar(dsc_tensor_h a, double re, double im,
                            int is_complex, int reflected);
dsc_tensor_h dsc_div_scalar(dsc_tensor_h a, double re, double im,
                            int is_complex, int reflected);
dsc_tensor_h dsc_pow_scalar(dsc_tensor_h a, double re, double im,
                            int is_complex, int reflected);

/* -- unary ops (reference dsc.h:302-356) ---------------------------------- */
dsc_tensor_h dsc_cos(dsc_tensor_h h);
dsc_tensor_h dsc_sin(dsc_tensor_h h);
dsc_tensor_h dsc_sinc(dsc_tensor_h h);
dsc_tensor_h dsc_logn(dsc_tensor_h h);
dsc_tensor_h dsc_log2(dsc_tensor_h h);
dsc_tensor_h dsc_log10(dsc_tensor_h h);
dsc_tensor_h dsc_exp(dsc_tensor_h h);
dsc_tensor_h dsc_sqrt(dsc_tensor_h h);
dsc_tensor_h dsc_abs(dsc_tensor_h h);
dsc_tensor_h dsc_angle(dsc_tensor_h h);
dsc_tensor_h dsc_conj(dsc_tensor_h h);
dsc_tensor_h dsc_real(dsc_tensor_h h);
dsc_tensor_h dsc_imag(dsc_tensor_h h);
dsc_tensor_h dsc_i0(dsc_tensor_h h);
dsc_tensor_h dsc_clip(dsc_tensor_h h, double lo, double hi,
                      int has_lo, int has_hi);

/* -- reductions (defaults axis=-1, keepdims=true; reference dsc.h:358-380) */
dsc_tensor_h dsc_sum(dsc_tensor_h h, int axis, int keepdims);
dsc_tensor_h dsc_mean(dsc_tensor_h h, int axis, int keepdims);
dsc_tensor_h dsc_max(dsc_tensor_h h, int axis, int keepdims);
dsc_tensor_h dsc_min(dsc_tensor_h h, int axis, int keepdims);

/* -- layout --------------------------------------------------------------- */
dsc_tensor_h dsc_reshape(dsc_tensor_h h, int n_dim, const int *shape);
dsc_tensor_h dsc_transpose(dsc_tensor_h h, int n_axes, const int *axes);
dsc_tensor_h dsc_concat(int n, const dsc_tensor_h *hs, int axis, int flatten);
dsc_tensor_h dsc_cast(dsc_tensor_h h, dsc_dtype dtype);

/* -- indexing/slicing (mixed int+slice like reference dsc.cpp:898-948;
 *    pass start==stop==step and is_index=1 for a plain index; DSC_NONE for
 *    open slice bounds) ---------------------------------------------------- */
dsc_tensor_h dsc_get_slice(dsc_tensor_h h, int n, const int *starts,
                           const int *stops, const int *steps,
                           const int *is_index);
int          dsc_set_slice(dsc_tensor_h h, dsc_tensor_h val, int n,
                           const int *starts, const int *stops,
                           const int *steps, const int *is_index);

/* -- fft (reference dsc.h:384-424) ----------------------------------------- */
void         dsc_plan_fft(int n, dsc_dtype dtype);
dsc_tensor_h dsc_fft(dsc_tensor_h h, int n, int axis);
dsc_tensor_h dsc_ifft(dsc_tensor_h h, int n, int axis);
dsc_tensor_h dsc_rfft(dsc_tensor_h h, int n, int axis);
dsc_tensor_h dsc_irfft(dsc_tensor_h h, int n, int axis);
dsc_tensor_h dsc_fftfreq(int n, double d, dsc_dtype dtype);
dsc_tensor_h dsc_rfftfreq(int n, double d, dsc_dtype dtype);

/* -- dsc_tpu extensions: 2-D transforms + window generators ---------------- */
dsc_tensor_h dsc_fft2(dsc_tensor_h h, int n0, int n1, int ax0, int ax1);
dsc_tensor_h dsc_ifft2(dsc_tensor_h h, int n0, int n1, int ax0, int ax1);
dsc_tensor_h dsc_rfft2(dsc_tensor_h h, int n0, int n1, int ax0, int ax1);
dsc_tensor_h dsc_irfft2(dsc_tensor_h h, int n0, int n1, int ax0, int ax1);
/* kind: "hanning" | "hamming" | "blackman" | "kaiser" (beta used for kaiser) */
dsc_tensor_h dsc_window(const char *kind, int n, double beta, dsc_dtype dtype);

/* -- tracing (reference dsc.h:160-168) -------------------------------------- */
void dsc_traces_record(int record);
void dsc_dump_traces(const char *path);
void dsc_clear_traces(void);

#ifdef __cplusplus
}
#endif
