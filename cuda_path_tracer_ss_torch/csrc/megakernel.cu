// Forward-render megakernel for NVIDIA Hopper (sm_90a): the whole render of a
// pixel range — eye rays, all samples, all bounces — in ONE launch.
//
// Replaces the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/megakernel.py::_make_render_kernel
// (launched there by _render_block_sums) in all of its variants, each an
// instantiation of one source: the reference-parity estimator (default), the
// physical (unbiased MIS) estimator, and the physical estimator with the
// bidirectional carries; each for untextured and for textured scenes (the
// texture block applies color and normal maps at every hit, with direct
// indexed loads from a flat texel atlas); each with linear sweeps or with the
// supercell grid's; each with float32 or bfloat16 storage of the carries
// (state_bf16; 24 kernels). One thread
// per pixel over a 1-D grid; the ragged edge is masked by i < n_local. The
// per-pixel math is in megakernel.cuh. The scene tables and the grid's CSR
// table are read through read-only global memory (const __restrict__): a
// 10k-primitive scene runs like a small one, and a small scene's tables stay
// in L1. Bound on this card: FP32 arithmetic throughput (a launch reads a few
// KB of tables and writes 12 bytes per pixel). With the grid a thread tests
// only the primitives of the boxes its own ray reaches: divergence instead of
// a block vote.
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

template <bool PHYSICAL, bool BIDIR, bool TEXTURED, bool GRID, bool BF16>
__global__ void render_kernel(cpt::SceneTables sc, cpt::RenderParams p,
                              float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n_local) return;
    float r, g, b;
    cpt::render_pixel_t<PHYSICAL, BIDIR, TEXTURED>(cpt::grid_tables<GRID>(sc),
                                                   cpt::bf16_params<BF16>(p),
                                                   p.pixel_offset + i, r, g, b);
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

template <bool PHYSICAL, bool BIDIR, bool TEXTURED, bool GRID>
void launch_render_g(const cpt::SceneTables& sc, const cpt::RenderParams& p, float* out,
                     int blocks, cudaStream_t st) {
    if (p.state_bf16) {
        render_kernel<PHYSICAL, BIDIR, TEXTURED, GRID, true>
            <<<blocks, THREADS_PER_BLOCK, 0, st>>>(sc, p, out);
    } else {
        render_kernel<PHYSICAL, BIDIR, TEXTURED, GRID, false>
            <<<blocks, THREADS_PER_BLOCK, 0, st>>>(sc, p, out);
    }
}

template <bool PHYSICAL, bool BIDIR, bool TEXTURED>
void launch_render_t(const cpt::SceneTables& sc, const cpt::RenderParams& p, float* out,
                     int blocks, cudaStream_t st) {
    if (sc.grid.idx != nullptr) {
        launch_render_g<PHYSICAL, BIDIR, TEXTURED, true>(sc, p, out, blocks, st);
    } else {
        launch_render_g<PHYSICAL, BIDIR, TEXTURED, false>(sc, p, out, blocks, st);
    }
}

template <bool PHYSICAL, bool BIDIR>
void launch_render(const cpt::SceneTables& sc, const cpt::RenderParams& p, float* out,
                   int blocks, cudaStream_t st) {
    if (sc.num_textures > 0) {
        launch_render_t<PHYSICAL, BIDIR, true>(sc, p, out, blocks, st);
    } else {
        launch_render_t<PHYSICAL, BIDIR, false>(sc, p, out, blocks, st);
    }
}

}  // namespace

extern "C" {

// Radiance sums out[n_local][3] for flat pixels [pixel_offset, pixel_offset +
// n_local). Table pointers are device pointers (float32, row-major, `num_*`
// rows; an empty table may point at a dummy row); the texture bundle (atlas,
// meta, triuv, matids; megakernel.cuh: SceneTables) is null with
// num_textures 0 on an untextured scene and selects the textured
// instantiation otherwise; the grid bundle (grid_idx int32 and grid_scal
// float32 device pointers, grid_meta 9 host ints; megakernel.cuh: set_grid)
// has a null grid_idx for linear sweeps and selects the grid instantiation
// otherwise; cam_host points at 16 host floats (slot 15: the bidirectional
// count ratio nu). `variant` picks the estimator: 0 reference-parity, 1
// physical, 2 physical with the bidirectional carries; state_bf16 != 0 selects
// the instantiation that stores the radiance / throughput carries as
// bfloat16. Everything but the code
// itself is a runtime argument.
int cpt_render_megakernel(const float* spheres, int num_spheres,
                          const float* triangles, int num_triangles,
                          const float* materials, int num_materials,
                          const float* point_lights, int num_point_lights,
                          const float* area_lights, int num_area_lights,
                          const float* background,
                          const float* tex_atlas, const float* tex_meta,
                          const float* tex_triuv, const float* tex_matids, int num_textures,
                          const int* grid_idx, const float* grid_scal, const int* grid_meta,
                          const float* cam_host,
                          int seed, int pixel_offset, int n_local, int sample_offset,
                          int spp, int max_bounces, int width, int height, int variant,
                          int state_bf16, float* out, void* stream) {
    cpt::SceneTables sc;
    sc.spheres = spheres; sc.num_spheres = num_spheres;
    sc.triangles = triangles; sc.num_triangles = num_triangles;
    sc.materials = materials; sc.num_materials = num_materials;
    sc.point_lights = point_lights; sc.num_point_lights = num_point_lights;
    sc.area_lights = area_lights; sc.num_area_lights = num_area_lights;
    sc.background = background;
    sc.tex_atlas = tex_atlas; sc.tex_meta = tex_meta;
    sc.tex_triuv = tex_triuv; sc.tex_matids = tex_matids; sc.num_textures = num_textures;
    cpt::set_grid(sc, grid_idx, grid_scal, grid_meta);
    cpt::RenderParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.pixel_offset = pixel_offset; p.n_local = n_local;
    p.sample_offset = sample_offset; p.spp = spp; p.max_bounces = max_bounces;
    p.state_bf16 = state_bf16;
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
