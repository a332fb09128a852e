/* libsdtpu — the C API of the PyTorch/CUDA port (sdtpu_torch).
 *
 * The port's copy of csrc/libsdtpu/include/sdtpu.h: the same functions,
 * signatures, types and status codes (only this comment differs). The
 * engine functions drive an embedded CPython running sdtpu_torch.Context
 * (compiled in when SDTPU_EMBED_PYTHON is defined); its device is the
 * SDTPU_TORCH_DEVICE environment variable, "cuda" when unset.
 *
 * Three component groups:
 *   - tokenizer:   CLIP BPE, numerically identical ids to the Python side
 *   - dpm solver:  schedule + 2nd-order multistep update (host math)
 *   - engine:      full prompt->image via the embedded CPython pipeline
 */

#ifndef SDTPU_H
#define SDTPU_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#ifndef SDTPU_API
#define SDTPU_API __attribute__((visibility("default")))
#endif

/* status codes (reference: errors.h:12-19 has the same granularity) */
typedef enum sdtpu_status {
  SDTPU_NO_ERROR = 0,
  SDTPU_INVALID_ARGUMENT = 1,
  SDTPU_FAILED_ALLOCATION = 2,
  SDTPU_RUNTIME_ERROR = 3,
  SDTPU_INVALID_CONTEXT = 4,
  SDTPU_INTERNAL_ERROR = 5,
  SDTPU_UNSUPPORTED = 6
} sdtpu_status;

SDTPU_API const char* sdtpu_get_error_description(int status);
/* last recorded message for `status`, global table; NULL if none */
SDTPU_API const char* sdtpu_get_last_error_extra_info(int status, void* context);

/* ---------------- tokenizer ---------------- */

typedef struct sdtpu_tokenizer sdtpu_tokenizer;

/* Load the flat single-file vocab (ctokenizer.txt format). */
SDTPU_API int sdtpu_tokenizer_create(const char* flat_file_path,
                                     sdtpu_tokenizer** out);
SDTPU_API int sdtpu_tokenizer_vocab_size(const sdtpu_tokenizer* tok,
                                         int32_t* out);
/* Encode `text` into exactly `context_len` ids (sot + bpe + eot padding). */
SDTPU_API int sdtpu_tokenizer_tokenize(const sdtpu_tokenizer* tok,
                                       const char* text, int32_t context_len,
                                       int32_t* out_ids);
SDTPU_API void sdtpu_tokenizer_release(sdtpu_tokenizer* tok);

/* ---------------- DPM solver ---------------- */

typedef struct sdtpu_dpm sdtpu_dpm;

/* SD v1.x defaults: train_steps=1000, lin_start=0.00085, lin_end=0.0120
 * (reference: dpm_solver.cpp:84-97, context.cpp:196). */
SDTPU_API int sdtpu_dpm_create(int32_t train_steps, double lin_start,
                               double lin_end, sdtpu_dpm** out);
SDTPU_API int sdtpu_dpm_prepare(sdtpu_dpm* s, int32_t steps);
/* model-facing timesteps, length `steps` (valid after prepare) */
SDTPU_API int sdtpu_dpm_model_ts(const sdtpu_dpm* s, float* out, int32_t n);
/* One 2nd-order multistep update: x <- step(x, eps); keeps prev-y state.
 * step must be called in order 0..steps-1 after prepare(). */
SDTPU_API int sdtpu_dpm_update(sdtpu_dpm* s, int32_t step, float* x,
                               const float* eps, size_t n);
SDTPU_API void sdtpu_dpm_release(sdtpu_dpm* s);

/* ---------------- engine (embedded python) ---------------- */

/* Opaque refcounted context handle (reference: libsdod.cpp:22-27). */
/* config: "sd15" (default when NULL) or "tiny" (CPU-testable demo). */
SDTPU_API int sdtpu_setup(void** context, const char* model_dir,
                          const char* config, int32_t steps,
                          int32_t log_level, int32_t use_tpu);
SDTPU_API int sdtpu_set_steps(void* context, int32_t steps);
SDTPU_API int sdtpu_set_seed(void* context, int64_t seed);
/* Quality/latency knobs (0 disables each; see README "Quality knobs"):
 * pag_scale = perturbed-attention guidance strength applied to every
 * generate call; deepcache = full-UNet cadence N (>= 2); tome_ratio =
 * token-merge fraction in (0, 0.75]. deepcache/tome recompile on next
 * use (the setting is baked into the program). */
SDTPU_API int sdtpu_set_pag_scale(void* context, float scale);
SDTPU_API int sdtpu_set_deepcache(void* context, int32_t interval);
SDTPU_API int sdtpu_set_tome_ratio(void* context, float ratio);
SDTPU_API int sdtpu_ref_context(void* context);
SDTPU_API int sdtpu_release(void* context);
/* Generate one image. If *image_buffer is NULL it is callee-allocated (free
 * with sdtpu_free_buffer) and *buffer_size is set; otherwise it must hold
 * *buffer_size bytes (reference: api/libsdod.h:91-114 protocol). */
SDTPU_API int sdtpu_generate_image(void* context, const char* prompt,
                                   float guidance, void** image_buffer,
                                   size_t* buffer_size);
/* Register a LoRA adapter artifact (sdtpu.train.lora .npz) under `name`
 * for per-request selection. Adapters share the base weights; loading N
 * adapters costs N adapter trees, not N models. */
SDTPU_API int sdtpu_load_lora(void* context, const char* name,
                              const char* npz_path);
/* Generate with a named adapter: `lora` = registered name, "" forces the
 * base model, NULL uses the context default. Output protocol as
 * sdtpu_generate_image. */
SDTPU_API int sdtpu_generate_image_lora(void* context, const char* prompt,
                                        float guidance, const char* lora,
                                        void** image_buffer,
                                        size_t* buffer_size);
/* img2img / inpainting. `image`: uint8 RGB HWC at the context resolution
 * (image_size bytes = H*W*3). `mask`: optional uint8 grayscale [H, W]
 * (mask_size = H*W; nonzero = repaint) — NULL selects plain img2img.
 * `strength` in (0, 1]. Output protocol as sdtpu_generate_image. */
SDTPU_API int sdtpu_img2img_image(void* context, const char* prompt,
                                  float guidance, float strength,
                                  const uint8_t* image, size_t image_size,
                                  const uint8_t* mask, size_t mask_size,
                                  void** image_buffer, size_t* buffer_size);
/* Depth-conditioned img2img (5-ch configs, e.g. "sd2_depth"). `depth`:
 * float32 [H*W] row-major, any monotone depth scale (normalized per
 * sample inside the program). Output protocol as sdtpu_generate_image. */
SDTPU_API int sdtpu_depth2img_image(void* context, const char* prompt,
                                    float guidance, float strength,
                                    const uint8_t* image, size_t image_size,
                                    const float* depth, size_t depth_count,
                                    void** image_buffer, size_t* buffer_size);
/* InstructPix2Pix editing (8-ch configs, e.g. "sd15_ip2p"): `prompt` is
 * the edit instruction; dual text (`guidance`) / image (`image_guidance`)
 * CFG. Output protocol as sdtpu_generate_image. */
SDTPU_API int sdtpu_edit_image(void* context, const char* prompt,
                               float guidance, float image_guidance,
                               const uint8_t* image, size_t image_size,
                               void** image_buffer, size_t* buffer_size);
/* SD x4 latent upscaler (7-ch noise-level-conditioned configs, e.g.
 * "sd_x4"): `image` is the LOW-RES uint8 RGB HWC input at the LATENT
 * grid size (context resolution / upscale factor; image_size bytes =
 * h*w*3); the output image is at the context resolution. `noise_level`
 * in [0, max_noise_level) sets the conditioning noise augmentation.
 * Output protocol as sdtpu_generate_image. */
SDTPU_API int sdtpu_upscale_image(void* context, const char* prompt,
                                  float guidance, int noise_level,
                                  const uint8_t* image, size_t image_size,
                                  void** image_buffer, size_t* buffer_size);
/* Textual-inversion embedding: register the trigger `word` from an
 * .npz/.safetensors vector artifact (Context.load_embedding). */
SDTPU_API int sdtpu_load_embedding(void* context, const char* word,
                                   const char* path);
SDTPU_API void sdtpu_free_buffer(void* buffer);

#ifdef __cplusplus
}
#endif

#endif /* SDTPU_H */
