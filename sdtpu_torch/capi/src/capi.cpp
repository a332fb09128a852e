// The port's copy of csrc/libsdtpu/src/capi.cpp (unchanged but for this line and sdtpu_setup).
// C ABI facade: status-code boundary over the native components + the
// embedded-Python engine. Mirrors the reference facade's semantics
// (reference: libsdod.cpp:22-247 — refcounted magic-validated handles,
// exception->status conversion, per-status last-error introspection,
// caller-or-callee output buffers) with an independent implementation.

#include <atomic>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <string>

#include "dpm.h"
#include "errors.h"
#include "logging.h"
#include "sdtpu.h"
#include "tokenizer.h"

#ifdef SDTPU_EMBED_PYTHON
#include <Python.h>
#endif

namespace {

using sdtpu::Error;

int guard(const char* func, auto&& fn) {
  try {
    fn();
    return SDTPU_NO_ERROR;
  } catch (const Error& e) {
    return int(e.code);
  } catch (const std::bad_alloc&) {
    sdtpu::global_error_table().record(SDTPU_FAILED_ALLOCATION, func);
    return SDTPU_FAILED_ALLOCATION;
  } catch (const std::exception& e) {
    sdtpu::global_error_table().record(SDTPU_INTERNAL_ERROR,
                                       std::string(func) + ": " + e.what());
    return SDTPU_INTERNAL_ERROR;
  }
}

constexpr uint32_t kMagic = 0x53445450;  // "SDTP"
constexpr uint32_t kVersion = 1;

struct ContextHandle {
  uint32_t magic = kMagic;
  uint32_t version = kVersion;
  std::atomic<int> refcount{1};
  sdtpu::ErrorTable errors;
  sdtpu::Logger logger;
#ifdef SDTPU_EMBED_PYTHON
  void* py_ctx = nullptr;  // PyObject* of the sdtpu.Context
#endif
  ContextHandle() : logger(sdtpu::LogLevel::kError, "libsdtpu") {}
};

ContextHandle* retrieve(void* context) {
  auto* h = static_cast<ContextHandle*>(context);
  if (!h || h->magic != kMagic || h->version != kVersion ||
      h->refcount.load() <= 0) {
    sdtpu::global_error_table().record(SDTPU_INVALID_CONTEXT,
                                       "bad context handle");
    return nullptr;
  }
  return h;
}

}  // namespace

extern "C" {

const char* sdtpu_get_error_description(int status) {
  switch (status) {
    case SDTPU_NO_ERROR: return "no error";
    case SDTPU_INVALID_ARGUMENT: return "invalid argument";
    case SDTPU_FAILED_ALLOCATION: return "allocation failed";
    case SDTPU_RUNTIME_ERROR: return "runtime error";
    case SDTPU_INVALID_CONTEXT: return "invalid context";
    case SDTPU_INTERNAL_ERROR: return "internal error";
    case SDTPU_UNSUPPORTED: return "unsupported (built without this feature)";
    default: return "unknown status";
  }
}

const char* sdtpu_get_last_error_extra_info(int status, void* context) {
  if (context) {
    auto* h = retrieve(context);
    if (h)
      if (const char* m = h->errors.last(status)) return m;
  }
  return sdtpu::global_error_table().last(status);
}

/* ---------------- tokenizer ---------------- */

struct sdtpu_tokenizer {
  sdtpu::Tokenizer impl;
};

int sdtpu_tokenizer_create(const char* path, sdtpu_tokenizer** out) {
  return guard(__func__, [&] {
    if (!path || !out)
      SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "null path/out");
    *out = new sdtpu_tokenizer{sdtpu::Tokenizer::from_flat_file(path)};
  });
}

int sdtpu_tokenizer_vocab_size(const sdtpu_tokenizer* tok, int32_t* out) {
  return guard(__func__, [&] {
    if (!tok || !out) SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "null tok/out");
    *out = tok->impl.vocab_size();
  });
}

int sdtpu_tokenizer_tokenize(const sdtpu_tokenizer* tok, const char* text,
                             int32_t context_len, int32_t* out_ids) {
  return guard(__func__, [&] {
    if (!tok || !text || !out_ids || context_len < 2)
      SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "bad tokenize args");
    auto ids = tok->impl.tokenize(text, context_len);
    std::memcpy(out_ids, ids.data(), ids.size() * sizeof(int32_t));
  });
}

void sdtpu_tokenizer_release(sdtpu_tokenizer* tok) { delete tok; }

/* ---------------- DPM ---------------- */

struct sdtpu_dpm {
  sdtpu::DpmSolver impl;
};

int sdtpu_dpm_create(int32_t train_steps, double lin_start, double lin_end,
                     sdtpu_dpm** out) {
  return guard(__func__, [&] {
    if (!out) SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "null out");
    *out = new sdtpu_dpm{sdtpu::DpmSolver(train_steps, lin_start, lin_end)};
  });
}

int sdtpu_dpm_prepare(sdtpu_dpm* s, int32_t steps) {
  return guard(__func__, [&] {
    if (!s) SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "null solver");
    s->impl.prepare(steps);
  });
}

int sdtpu_dpm_model_ts(const sdtpu_dpm* s, float* out, int32_t n) {
  return guard(__func__, [&] {
    if (!s || !out || n != s->impl.steps())
      SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "bad model_ts args");
    std::memcpy(out, s->impl.model_ts().data(), size_t(n) * sizeof(float));
  });
}

int sdtpu_dpm_update(sdtpu_dpm* s, int32_t step, float* x, const float* eps,
                     size_t n) {
  return guard(__func__, [&] {
    if (!s || !x || !eps) SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "null args");
    s->impl.update(step, x, eps, n);
  });
}

void sdtpu_dpm_release(sdtpu_dpm* s) { delete s; }

/* ---------------- engine (embedded python) ---------------- */

#ifdef SDTPU_EMBED_PYTHON

namespace {
std::once_flag g_py_once;

void ensure_python() {
  std::call_once(g_py_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      PyEval_SaveThread();  // release GIL for PyGILState_Ensure users
    }
  });
}

struct Gil {
  PyGILState_STATE st;
  Gil() { st = PyGILState_Ensure(); }
  ~Gil() { PyGILState_Release(st); }
};

void raise_py(ContextHandle* h, const char* what) {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  std::string msg = what;
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      msg += ": ";
      msg += PyUnicode_AsUTF8(s);
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  throw Error(SDTPU_RUNTIME_ERROR, msg, what, h ? &h->errors : nullptr);
}

// Copy a numpy image result into the caller-or-callee allocated output
// buffer (reference output protocol: api/libsdod.h:91-114). Steals `img`.
void deliver_image(ContextHandle* h, PyObject* img, void** image_buffer,
                   size_t* buffer_size) {
  PyObject* bytes = PyObject_CallMethod(img, "tobytes", nullptr);
  Py_DECREF(img);
  if (!bytes) raise_py(h, "tobytes");
  char* data;
  Py_ssize_t len;
  PyBytes_AsStringAndSize(bytes, &data, &len);
  if (*image_buffer) {
    if (*buffer_size < size_t(len)) {
      Py_DECREF(bytes);
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT,
                    "caller buffer too small");
    }
  } else {
    *image_buffer = std::malloc(size_t(len));
    if (!*image_buffer) {
      Py_DECREF(bytes);
      SDTPU_THROW_T(&h->errors, SDTPU_FAILED_ALLOCATION, "image buffer");
    }
  }
  std::memcpy(*image_buffer, data, size_t(len));
  *buffer_size = size_t(len);
  Py_DECREF(bytes);
}

// bytes -> uint8 ndarray of the given shape (dims 2 or 3)
PyObject* bytes_to_array(ContextHandle* h, const uint8_t* data, size_t n,
                         int dims, long d0, long d1, long d2,
                         const char* dtype = "uint8") {
  PyObject* np = PyImport_ImportModule("numpy");
  if (!np) raise_py(h, "import numpy");
  PyObject* by =
      PyBytes_FromStringAndSize(reinterpret_cast<const char*>(data),
                                Py_ssize_t(n));
  PyObject* flat = by ? PyObject_CallMethod(np, "frombuffer", "(Os)", by,
                                            dtype)
                      : nullptr;
  Py_XDECREF(by);
  Py_DECREF(np);
  if (!flat) raise_py(h, "np.frombuffer");
  PyObject* arr =
      dims == 3 ? PyObject_CallMethod(flat, "reshape", "(lll)", d0, d1, d2)
                : PyObject_CallMethod(flat, "reshape", "(ll)", d0, d1);
  Py_DECREF(flat);
  if (!arr) raise_py(h, "reshape");
  return arr;
}

long context_image_size(ContextHandle* h) {
  PyObject* cfg =
      PyObject_GetAttrString(static_cast<PyObject*>(h->py_ctx), "cfg");
  if (!cfg) raise_py(h, "cfg");
  PyObject* o = PyObject_GetAttrString(cfg, "image_size");
  Py_DECREF(cfg);
  if (!o) raise_py(h, "image_size");
  long isz = PyLong_AsLong(o);
  Py_DECREF(o);
  return isz;
}
}  // namespace

int sdtpu_setup(void** context, const char* model_dir, const char* config,
                int32_t steps, int32_t log_level, int32_t use_tpu) {
  return guard(__func__, [&] {
    if (!context) SDTPU_THROW(SDTPU_INVALID_ARGUMENT, "null context out");
    ensure_python();
    auto h = std::make_unique<ContextHandle>();
    Gil gil;
    PyObject* mod = PyImport_ImportModule("sdtpu_torch");
    if (!mod) raise_py(h.get(), "import sdtpu_torch");
    PyObject* cls = PyObject_GetAttrString(mod, "Context");
    Py_DECREF(mod);
    if (!cls) raise_py(h.get(), "sdtpu_torch.Context");
    // the device: SDTPU_TORCH_DEVICE, the card when unset; use_tpu keeps
    // its meaning, the hand-written kernels ("auto") or the plain path
    const char* device = std::getenv("SDTPU_TORCH_DEVICE");
    PyObject* kwargs = Py_BuildValue(
        "{s:s, s:s, s:i, s:i, s:s, s:s}", "model_dir", model_dir, "config",
        config ? config : "sd15", "steps", steps, "log_level", log_level,
        "kernels", use_tpu ? "auto" : "plain", "device",
        device && *device ? device : "cuda");
    if (!model_dir) {
      PyDict_SetItemString(kwargs, "model_dir", Py_None);
    }
    PyObject* args = PyTuple_New(0);
    PyObject* ctx = PyObject_Call(cls, args, kwargs);
    Py_DECREF(cls);
    Py_DECREF(args);
    Py_DECREF(kwargs);
    if (!ctx) raise_py(h.get(), "Context()");
    h->py_ctx = ctx;
    *context = h.release();
  });
}

int sdtpu_set_steps(void* context, int32_t steps) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    Gil gil;
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                      "set_steps", "(i)", steps);
    if (!r) raise_py(h, "set_steps");
    Py_DECREF(r);
  });
}

int sdtpu_set_seed(void* context, int64_t seed) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    Gil gil;
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                      "set_seed", "(L)", (long long)seed);
    if (!r) raise_py(h, "set_seed");
    Py_DECREF(r);
  });
}

int sdtpu_set_pag_scale(void* context, float scale) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    Gil gil;
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                      "set_pag_scale", "(d)", (double)scale);
    if (!r) raise_py(h, "set_pag_scale");
    Py_DECREF(r);
  });
}

int sdtpu_set_deepcache(void* context, int32_t interval) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    Gil gil;
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                      "set_deepcache", "(i)", interval);
    if (!r) raise_py(h, "set_deepcache");
    Py_DECREF(r);
  });
}

int sdtpu_set_tome_ratio(void* context, float ratio) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    Gil gil;
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                      "set_tome_ratio", "(d)", (double)ratio);
    if (!r) raise_py(h, "set_tome_ratio");
    Py_DECREF(r);
  });
}

int sdtpu_generate_image(void* context, const char* prompt, float guidance,
                         void** image_buffer, size_t* buffer_size) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!prompt || !image_buffer || !buffer_size)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null args");
    Gil gil;
    PyObject* img = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                        "generate", "(sf)", prompt,
                                        (double)guidance);
    if (!img) raise_py(h, "generate");
    deliver_image(h, img, image_buffer, buffer_size);
  });
}

int sdtpu_load_lora(void* context, const char* name, const char* npz_path) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!name || !npz_path)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null name/path");
    Gil gil;
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                      "load_lora", "(ss)", name, npz_path);
    if (!r) raise_py(h, "load_lora");
    Py_DECREF(r);
  });
}

int sdtpu_load_embedding(void* context, const char* word, const char* path) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!word || !path)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null word/path");
    Gil gil;
    PyObject* r = PyObject_CallMethod(static_cast<PyObject*>(h->py_ctx),
                                      "load_embedding", "(ss)", word, path);
    if (!r) raise_py(h, "load_embedding");
    Py_DECREF(r);
  });
}

int sdtpu_generate_image_lora(void* context, const char* prompt,
                              float guidance, const char* lora,
                              void** image_buffer, size_t* buffer_size) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!prompt || !image_buffer || !buffer_size)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null args");
    Gil gil;
    // keyword call: generate(prompt, guidance=..., lora=...) — lora NULL
    // maps to Python None (context default), "" to the base model
    PyObject* meth =
        PyObject_GetAttrString(static_cast<PyObject*>(h->py_ctx), "generate");
    if (!meth) raise_py(h, "generate");
    PyObject* args = Py_BuildValue("(s)", prompt);
    PyObject* kwargs = Py_BuildValue("{s:d}", "guidance", (double)guidance);
    if (lora) {
      PyObject* l = PyUnicode_FromString(lora);
      PyDict_SetItemString(kwargs, "lora", l);
      Py_DECREF(l);
    }
    PyObject* img = PyObject_Call(meth, args, kwargs);
    Py_DECREF(meth);
    Py_DECREF(args);
    Py_DECREF(kwargs);
    if (!img) raise_py(h, "generate(lora)");
    deliver_image(h, img, image_buffer, buffer_size);
  });
}

int sdtpu_img2img_image(void* context, const char* prompt, float guidance,
                        float strength, const uint8_t* image,
                        size_t image_size, const uint8_t* mask,
                        size_t mask_size, void** image_buffer,
                        size_t* buffer_size) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!prompt || !image || !image_buffer || !buffer_size)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null args");
    Gil gil;
    long isz = context_image_size(h);
    if (image_size != size_t(isz) * size_t(isz) * 3)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT,
                    "image must be H*W*3 bytes at the context resolution");
    if (mask && mask_size != size_t(isz) * size_t(isz))
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT,
                    "mask must be H*W bytes at the context resolution");
    PyObject* ctx = static_cast<PyObject*>(h->py_ctx);
    PyObject* arr = bytes_to_array(h, image, image_size, 3, isz, isz, 3);
    PyObject* img;
    if (mask) {
      PyObject* marr = bytes_to_array(h, mask, mask_size, 2, isz, isz, 0);
      img = PyObject_CallMethod(ctx, "inpaint", "(sOOdd)", prompt, arr, marr,
                                double(strength), double(guidance));
      Py_DECREF(marr);
    } else {
      img = PyObject_CallMethod(ctx, "img2img", "(sOdd)", prompt, arr,
                                double(strength), double(guidance));
    }
    Py_DECREF(arr);
    if (!img) raise_py(h, mask ? "inpaint" : "img2img");
    deliver_image(h, img, image_buffer, buffer_size);
  });
}

int sdtpu_depth2img_image(void* context, const char* prompt, float guidance,
                          float strength, const uint8_t* image,
                          size_t image_size, const float* depth,
                          size_t depth_count, void** image_buffer,
                          size_t* buffer_size) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!prompt || !image || !depth || !image_buffer || !buffer_size)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null args");
    Gil gil;
    long isz = context_image_size(h);
    if (image_size != size_t(isz) * size_t(isz) * 3)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT,
                    "image must be H*W*3 bytes at the context resolution");
    if (depth_count != size_t(isz) * size_t(isz))
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT,
                    "depth must be H*W float32 values");
    PyObject* ctx = static_cast<PyObject*>(h->py_ctx);
    PyObject* arr = bytes_to_array(h, image, image_size, 3, isz, isz, 3);
    PyObject* darr = bytes_to_array(
        h, reinterpret_cast<const uint8_t*>(depth),
        depth_count * sizeof(float), 2, isz, isz, 0, "float32");
    PyObject* img = PyObject_CallMethod(ctx, "depth2img", "(sOOdd)", prompt,
                                        arr, darr, double(strength),
                                        double(guidance));
    Py_DECREF(darr);
    Py_DECREF(arr);
    if (!img) raise_py(h, "depth2img");
    deliver_image(h, img, image_buffer, buffer_size);
  });
}

int sdtpu_edit_image(void* context, const char* prompt, float guidance,
                     float image_guidance, const uint8_t* image,
                     size_t image_size, void** image_buffer,
                     size_t* buffer_size) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!prompt || !image || !image_buffer || !buffer_size)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null args");
    Gil gil;
    long isz = context_image_size(h);
    if (image_size != size_t(isz) * size_t(isz) * 3)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT,
                    "image must be H*W*3 bytes at the context resolution");
    PyObject* ctx = static_cast<PyObject*>(h->py_ctx);
    PyObject* arr = bytes_to_array(h, image, image_size, 3, isz, isz, 3);
    PyObject* img = PyObject_CallMethod(ctx, "instruct_pix2pix", "(sOdd)",
                                        prompt, arr, double(guidance),
                                        double(image_guidance));
    Py_DECREF(arr);
    if (!img) raise_py(h, "instruct_pix2pix");
    deliver_image(h, img, image_buffer, buffer_size);
  });
}

int sdtpu_upscale_image(void* context, const char* prompt, float guidance,
                        int noise_level, const uint8_t* image,
                        size_t image_size, void** image_buffer,
                        size_t* buffer_size) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  return guard(__func__, [&] {
    if (!prompt || !image || !image_buffer || !buffer_size)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT, "null args");
    Gil gil;
    // the x4 upscaler consumes the low-res input at the LATENT grid
    PyObject* cfg =
        PyObject_GetAttrString(static_cast<PyObject*>(h->py_ctx), "cfg");
    if (!cfg) raise_py(h, "cfg");
    PyObject* o = PyObject_GetAttrString(cfg, "latent_size");
    Py_DECREF(cfg);
    if (!o) raise_py(h, "latent_size");
    long ls = PyLong_AsLong(o);
    Py_DECREF(o);
    if (image_size != size_t(ls) * size_t(ls) * 3)
      SDTPU_THROW_T(&h->errors, SDTPU_INVALID_ARGUMENT,
                    "image must be h*w*3 bytes at the latent grid size");
    PyObject* ctx = static_cast<PyObject*>(h->py_ctx);
    PyObject* arr = bytes_to_array(h, image, image_size, 3, ls, ls, 3);
    PyObject* img = PyObject_CallMethod(ctx, "upscale", "(sOid)", prompt,
                                        arr, noise_level, double(guidance));
    Py_DECREF(arr);
    if (!img) raise_py(h, "upscale");
    deliver_image(h, img, image_buffer, buffer_size);
  });
}

int sdtpu_ref_context(void* context) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  h->refcount.fetch_add(1);
  return SDTPU_NO_ERROR;
}

int sdtpu_release(void* context) {
  auto* h = retrieve(context);
  if (!h) return SDTPU_INVALID_CONTEXT;
  if (h->refcount.fetch_sub(1) == 1) {
    if (h->py_ctx) {
      Gil gil;
      Py_DECREF(static_cast<PyObject*>(h->py_ctx));
    }
    h->magic = 0;
    delete h;
  }
  return SDTPU_NO_ERROR;
}

#else  // !SDTPU_EMBED_PYTHON

int sdtpu_setup(void** context, const char*, const char*, int32_t, int32_t,
                int32_t) {
  (void)context;
  return SDTPU_UNSUPPORTED;
}
int sdtpu_set_steps(void*, int32_t) { return SDTPU_UNSUPPORTED; }
int sdtpu_set_seed(void*, int64_t) { return SDTPU_UNSUPPORTED; }
int sdtpu_set_pag_scale(void*, float) { return SDTPU_UNSUPPORTED; }
int sdtpu_set_deepcache(void*, int32_t) { return SDTPU_UNSUPPORTED; }
int sdtpu_set_tome_ratio(void*, float) { return SDTPU_UNSUPPORTED; }
int sdtpu_generate_image(void*, const char*, float, void**, size_t*) {
  return SDTPU_UNSUPPORTED;
}
int sdtpu_load_lora(void*, const char*, const char*) {
  return SDTPU_UNSUPPORTED;
}
int sdtpu_generate_image_lora(void*, const char*, float, const char*, void**,
                              size_t*) {
  return SDTPU_UNSUPPORTED;
}
int sdtpu_img2img_image(void*, const char*, float, float, const uint8_t*,
                        size_t, const uint8_t*, size_t, void**, size_t*) {
  return SDTPU_UNSUPPORTED;
}
int sdtpu_depth2img_image(void*, const char*, float, float, const uint8_t*,
                          size_t, const float*, size_t, void**, size_t*) {
  return SDTPU_UNSUPPORTED;
}
int sdtpu_edit_image(void*, const char*, float, float, const uint8_t*,
                     size_t, void**, size_t*) {
  return SDTPU_UNSUPPORTED;
}
int sdtpu_load_embedding(void*, const char*, const char*) {
  return SDTPU_UNSUPPORTED;
}
int sdtpu_ref_context(void*) { return SDTPU_UNSUPPORTED; }
int sdtpu_release(void*) { return SDTPU_UNSUPPORTED; }

#endif  // SDTPU_EMBED_PYTHON

void sdtpu_free_buffer(void* buffer) { std::free(buffer); }

}  // extern "C"
