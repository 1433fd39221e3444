// Forward-render megakernel for NVIDIA Hopper (sm_90a): the whole render of a
// pixel range — eye rays, all samples, all bounces — in ONE launch.
//
// Replaces the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/megakernel.py::_make_render_kernel
// (launched there by _render_block_sums) in three of its variants, each an
// instantiation of one source: the reference-parity estimator (default), the
// physical (unbiased MIS) estimator, and the physical estimator with the
// bidirectional carries; each once for untextured and once for textured scenes
// (the texture block applies color and normal maps at every hit, with direct
// indexed loads from a flat texel atlas). One thread per pixel over a 1-D grid; the ragged
// edge is masked by i < n_local. The per-pixel math is in megakernel.cuh. The scene tables are read through read-only global memory
// (const float* __restrict__): a 10k-primitive scene runs like a small one,
// and a small scene's tables stay in L1. Bound on this card: FP32 arithmetic
// throughput (a launch reads a few KB of tables and writes 12 bytes per pixel).
//
// Plain C interface, loaded with ctypes: no PyTorch headers. Each launch
// function enqueues on the given stream, does not synchronise, and returns
// cudaGetLastError() taken right after the launch.
#include <cuda_runtime.h>

#include "megakernel.cuh"

namespace {

// 128 threads per block: at the kernel's register count this gives an SM
// more resident warps than 256-thread blocks do, and the loop hides its
// latencies with warps. The launch shape is the kernel's own business.
constexpr int THREADS_PER_BLOCK = 128;

template <bool PHYSICAL, bool BIDIR, bool TEXTURED>
__global__ void render_kernel(cpt::SceneTables sc, cpt::RenderParams p,
                              float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n_local) return;
    float r, g, b;
    cpt::render_pixel_t<PHYSICAL, BIDIR, TEXTURED>(sc, p, p.pixel_offset + i, r, g, b);
    out[3 * i + 0] = r;
    out[3 * i + 1] = g;
    out[3 * i + 2] = b;
}

__global__ void uniform_pairs_kernel(const int* __restrict__ seed, const int* __restrict__ pixel,
                                     const int* __restrict__ sample, const int* __restrict__ pair,
                                     int n, float* __restrict__ u0, float* __restrict__ u1) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    cpt::uniform_pair(seed[i], pixel[i], sample[i], pair[i], u0[i], u1[i]);
}

template <bool PHYSICAL, bool BIDIR>
void launch_render(const cpt::SceneTables& sc, const cpt::RenderParams& p, float* out,
                   int blocks, cudaStream_t st) {
    if (sc.num_textures > 0) {
        render_kernel<PHYSICAL, BIDIR, true><<<blocks, THREADS_PER_BLOCK, 0, st>>>(sc, p, out);
    } else {
        render_kernel<PHYSICAL, BIDIR, false><<<blocks, THREADS_PER_BLOCK, 0, st>>>(sc, p, out);
    }
}

}  // namespace

extern "C" {

// Radiance sums out[n_local][3] for flat pixels [pixel_offset, pixel_offset +
// n_local). Table pointers are device pointers (float32, row-major, `num_*`
// rows; an empty table may point at a dummy row); the texture bundle (atlas,
// meta, triuv, matids; megakernel.cuh: SceneTables) is null with
// num_textures 0 on an untextured scene and selects the textured
// instantiation otherwise; cam_host points at 16 host
// floats (slot 15: the bidirectional count ratio nu). `variant` picks the
// estimator: 0 reference-parity, 1 physical, 2 physical with the
// bidirectional carries. Everything but the code itself is a runtime argument.
int cpt_render_megakernel(const float* spheres, int num_spheres,
                          const float* triangles, int num_triangles,
                          const float* materials, int num_materials,
                          const float* point_lights, int num_point_lights,
                          const float* area_lights, int num_area_lights,
                          const float* background,
                          const float* tex_atlas, const float* tex_meta,
                          const float* tex_triuv, const float* tex_matids, int num_textures,
                          const float* cam_host,
                          int seed, int pixel_offset, int n_local, int sample_offset,
                          int spp, int max_bounces, int width, int height, int variant,
                          float* out, void* stream) {
    cpt::SceneTables sc;
    sc.spheres = spheres; sc.num_spheres = num_spheres;
    sc.triangles = triangles; sc.num_triangles = num_triangles;
    sc.materials = materials; sc.num_materials = num_materials;
    sc.point_lights = point_lights; sc.num_point_lights = num_point_lights;
    sc.area_lights = area_lights; sc.num_area_lights = num_area_lights;
    sc.background = background;
    sc.tex_atlas = tex_atlas; sc.tex_meta = tex_meta;
    sc.tex_triuv = tex_triuv; sc.tex_matids = tex_matids; sc.num_textures = num_textures;
    cpt::RenderParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.pixel_offset = pixel_offset; p.n_local = n_local;
    p.sample_offset = sample_offset; p.spp = spp; p.max_bounces = max_bounces;
    cpt::set_image_size(p, width, height);
    const int blocks = (n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    const cudaStream_t st = (cudaStream_t)stream;
    if (variant == 0) {
        launch_render<false, false>(sc, p, out, blocks, st);
    } else if (variant == 1) {
        launch_render<true, false>(sc, p, out, blocks, st);
    } else if (variant == 2) {
        launch_render<true, true>(sc, p, out, blocks, st);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

// Debug entry: u0[i], u1[i] = uniform_pair(seed[i], pixel[i], sample[i], pair[i]).
int cpt_uniform_pairs(const int* seed, const int* pixel, const int* sample, const int* pair,
                      int n, float* u0, float* u1, void* stream) {
    const int threads = 256;
    uniform_pairs_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
        seed, pixel, sample, pair, n, u0, u1);
    return (int)cudaGetLastError();
}

const char* cpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
