/* Thin native executable linking the port's C ABI library -- the analogue
 * of the reference's RayTracingGPUVulkan exe (main.cpp:10-64, linked
 * against the ray_trace shared library, CMakeLists.txt:47-51).  Same flags,
 * same defaults, same unknown-argument behaviour (warn on stderr and
 * continue).
 *
 * Build: raytrace_tpu_torch._build.abi_library() (build/abi/<hash>/
 *        raytrace_torch_demo; rpath $ORIGIN, libpython linked in)
 * Run:   PYTHONPATH=<repo root> build/abi/<hash>/raytrace_torch_demo --samples 4
 *        (renders on the GPU; RAYTRACE_TORCH_DEVICE=cpu renders on the CPU)
 */

#include <stdbool.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* the shared library's exported entry point (raytrace_abi.cpp,
 * signature-compatible with the reference's ray_trace.h:9-15) */
extern void ray_trace(uint32_t samples, bool storeRenderResult,
                      uint32_t width, uint32_t height, uint32_t gpu_count);

int main(int argc, char** argv) {
    uint32_t samples = 10, width = 1920, height = 1080, gpus = 1;
    bool store = false;
    for (int i = 1; i < argc; i++) {
        const char* a = argv[i];
        if (strcmp(a, "--help") == 0) {
            /* reference main.cpp:21-27 help block (incl. its typo) */
            printf("--help                # Show this help infomation\n"
                   "--store               # Store rendered image to file\n"
                   "--samples <count>     # Total samples to render\n"
                   "--width <width>       # Image width\n"
                   "--height <height>     # Image height\n"
                   "--gpus <count>        # Max used GPUs count\n");
            return 0;
        } else if (strcmp(a, "--store") == 0) {
            store = true;
        } else if (strcmp(a, "--samples") == 0 && i + 1 < argc) {
            samples = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else if (strcmp(a, "--width") == 0 && i + 1 < argc) {
            width = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else if (strcmp(a, "--height") == 0 && i + 1 < argc) {
            height = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else if (strcmp(a, "--gpus") == 0 && i + 1 < argc) {
            gpus = (uint32_t)strtoul(argv[++i], NULL, 10);
        } else {
            fprintf(stderr, "unknown argument: %s\n", a); /* main.cpp:49 */
        }
    }
    ray_trace(samples, store, width, height, gpus);
    return 0;
}
