/* The port's copy of csrc/test/simple_app.c (unchanged but for this line). */
/* E2E native app: setup -> generate -> write raw output.bin
 * (the analogue of the reference's test/simple_app.cpp:6-38, through the
 * embedded-Python engine). Build with EMBED_PYTHON=1. */
#include <stdio.h>
#include <stdlib.h>

#include "sdtpu.h"

int main(int argc, char** argv) {
  const char* prompt = argc > 1
      ? argv[1]
      : "a photograph of an astronaut riding a horse";
  const char* config = argc > 2 ? argv[2] : "tiny";
  void* ctx = NULL;
  int st = sdtpu_setup(&ctx, NULL /* random-init demo */, config,
                       4 /* steps */, 2 /* info */, 0 /* cpu */);
  if (st != SDTPU_NO_ERROR) {
    fprintf(stderr, "setup failed: %s (%s)\n", sdtpu_get_error_description(st),
            sdtpu_get_last_error_extra_info(st, ctx));
    return 1;
  }
  void* buf = NULL;
  size_t size = 0;
  st = sdtpu_generate_image(ctx, prompt, 7.5f, &buf, &size);
  if (st != SDTPU_NO_ERROR) {
    fprintf(stderr, "generate failed: %s (%s)\n",
            sdtpu_get_error_description(st),
            sdtpu_get_last_error_extra_info(st, ctx));
    sdtpu_release(ctx);
    return 1;
  }
  FILE* f = fopen("output.bin", "wb");
  fwrite(buf, 1, size, f);
  fclose(f);
  printf("wrote output.bin (%zu bytes)\n", size);

  /* img2img round trip: feed the generated image back at strength 0.5 */
  void* buf2 = NULL;
  size_t size2 = 0;
  st = sdtpu_img2img_image(ctx, prompt, 7.5f, 0.5f,
                           (const unsigned char*)buf, size, NULL, 0, &buf2,
                           &size2);
  if (st != SDTPU_NO_ERROR) {
    fprintf(stderr, "img2img failed: %s (%s)\n",
            sdtpu_get_error_description(st),
            sdtpu_get_last_error_extra_info(st, ctx));
    sdtpu_free_buffer(buf);
    sdtpu_release(ctx);
    return 1;
  }
  f = fopen("output2.bin", "wb");
  fwrite(buf2, 1, size2, f);
  fclose(f);
  printf("wrote output2.bin (%zu bytes, img2img)\n", size2);
  sdtpu_free_buffer(buf2);
  sdtpu_free_buffer(buf);
  sdtpu_release(ctx);
  return 0;
}
