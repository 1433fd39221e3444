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
// (state_bf16; 24 kernels). One thread per pixel over a 1-D grid; the ragged
// edge is masked by i < n_local. The per-pixel math is in megakernel.cuh.
//
// What bounds it on this card: FP32 issue. A launch reads a few KB of tables
// and writes 12 bytes per pixel; cornell 800x800 x 8 bounces x 2000 spp needs
// 5.2e12 float32 operations, 77.5 ms at 67 TFLOP/s (chip_smoke.py [bound]).
//
// What held it back (before this design: 1195-1211 ms there, 87 registers): a
// loop over samples around a loop over bounces. A lane whose path had ended waited at
// the inner loop's end for the warp's longest path of that sample, so only
// 34 % of the lane slots the warps issued carried a live path (the plain
// version's tally of the kernel's warps, render_block_sums_plain: stats).
//
// What the design does about it: the TPU kernel's own schedule, persistent
// path regeneration (render_pixel_t): one loop, one bounce per iteration, and
// a lane whose path ends starts its next sample's path in the next
// iteration. Lane efficiency 0.34 -> 0.7-0.9 at 16-256 spp; the sums are the
// nested loop's bit for bit. Cornell 2000 spp: 523 ms default (90
// registers), 723-724 ms physical (116), against 1205-1210 / 1668-1674 in
// turns with the nested kernel on one card (k1_turns.py; NVIDIA H100 80GB
// HBM3, 700 W).
//
// Occupancy: no __launch_bounds__. Capping registers for 6 or 8 resident
// blocks of 128 (80 / 64 registers) was 4-7 % faster there (default 499-503
// ms, physical 674-675 ms) but spills in every instantiation (24-404 bytes),
// and a spilling cap is not kept; 128 threads per block, 5 (default) or 4
// (physical, textured) resident blocks per SM.
//
// Tables: each block first copies the small tables (spheres, triangles,
// materials, lights, background and the texture bundle's meta, material map
// ids and UVs: 1.8 KB on cornell, 2.6 KB on textured) into shared memory and
// reads them there, when they fit the 48 KB a launch takes without opting in
// and cost no resident block per SM (staged_bytes: the default
// instantiation stops at about 45 KB, stress_dense(2200)); the texel atlas,
// the grid's tables and larger scenes stay in global memory. Faster than
// global memory in 10 of 10 alternating pairs on each of cornell default
// (median 523.2 / 527.4 ms), physical (721.9 / 729.1) and textured (732.8 /
// 740.8): the divergent per-lane gather of the hit material's 20 columns is
// served by shared memory's banks.
//
// Tensor cores have no part: the work is scalar FP32 ray and BSDF math held
// bit-exact against the plain version under -fmad=false; TF32 or bf16
// products would break that parity. Nor has TMA: the tables are a few KB
// copied once per block in front of milliseconds of work.
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

// The dynamic shared memory a launch may take without opting in
// (cudaFuncAttributeMaxDynamicSharedMemorySize): a scene whose small tables
// (megakernel.cuh: small_table_floats) exceed it reads them from global memory.
constexpr int MAX_STAGED_BYTES = 48 * 1024;

// `staged` != 0: the block first copies the small tables into its dynamic
// shared memory (small_table_floats floats) and reads them there.
template <bool PHYSICAL, bool BIDIR, bool TEXTURED, bool GRID, bool BF16>
__global__ void render_kernel(cpt::SceneTables sc, cpt::RenderParams p, int staged,
                              float* __restrict__ out) {
    extern __shared__ float tables[];
    cpt::SceneTables s = cpt::grid_tables<GRID>(sc);
    if (staged) {
        s = cpt::stage_tables(s, tables, threadIdx.x, blockDim.x);
        __syncthreads();
    }
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n_local) return;
    float r, g, b;
    cpt::render_pixel_t<PHYSICAL, BIDIR, TEXTURED>(s, cpt::bf16_params<BF16>(p),
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

using RenderKernel = void (*)(cpt::SceneTables, cpt::RenderParams, int, float*);

template <bool PHYSICAL, bool BIDIR, bool TEXTURED, bool GRID>
RenderKernel kernel_g(bool bf16) {
    return bf16 ? render_kernel<PHYSICAL, BIDIR, TEXTURED, GRID, true>
                : render_kernel<PHYSICAL, BIDIR, TEXTURED, GRID, false>;
}

template <bool PHYSICAL, bool BIDIR, bool TEXTURED>
RenderKernel kernel_t(bool grid, bool bf16) {
    return grid ? kernel_g<PHYSICAL, BIDIR, TEXTURED, true>(bf16)
                : kernel_g<PHYSICAL, BIDIR, TEXTURED, false>(bf16);
}

template <bool PHYSICAL, bool BIDIR>
RenderKernel kernel_v(bool textured, bool grid, bool bf16) {
    return textured ? kernel_t<PHYSICAL, BIDIR, true>(grid, bf16)
                    : kernel_t<PHYSICAL, BIDIR, false>(grid, bf16);
}

// The instantiation for estimator `variant` (0 reference-parity, 1 physical,
// 2 physical with the bidirectional carries); null for another variant.
RenderKernel render_kernel_of(int variant, bool textured, bool grid, bool bf16) {
    if (variant == 0) return kernel_v<false, false>(textured, grid, bf16);
    if (variant == 1) return kernel_v<true, false>(textured, grid, bf16);
    if (variant == 2) return kernel_v<true, true>(textured, grid, bf16);
    return nullptr;
}

// Resident blocks per SM of `kernel` at `smem` bytes of dynamic shared memory
// (0 if the query fails; its error stays for cudaGetLastError).
int resident_blocks(RenderKernel kernel, int smem) {
    int blocks = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS_PER_BLOCK, smem);
    return blocks;
}

// Dynamic shared memory of a launch of `kernel` on `sc`: its small tables,
// when they fit MAX_STAGED_BYTES and cost no resident block per SM against a
// launch without them; else 0, and they are read from global memory.
int staged_bytes(RenderKernel kernel, const cpt::SceneTables& sc) {
    const long long bytes = (long long)cpt::small_table_floats(sc) * (long long)sizeof(float);
    if (bytes > MAX_STAGED_BYTES) return 0;
    return resident_blocks(kernel, (int)bytes) >= resident_blocks(kernel, 0) ? (int)bytes : 0;
}

cpt::SceneTables table_counts(int num_spheres, int num_triangles, int num_materials,
                              int num_point_lights, int num_area_lights, int num_textures) {
    cpt::SceneTables sc;
    sc.num_spheres = num_spheres; sc.num_triangles = num_triangles;
    sc.num_materials = num_materials; sc.num_point_lights = num_point_lights;
    sc.num_area_lights = num_area_lights; sc.num_textures = num_textures;
    return sc;
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
    const RenderKernel kernel = render_kernel_of(variant, num_textures > 0, grid_idx != nullptr,
                                                 state_bf16 != 0);
    if (kernel == nullptr) return (int)cudaErrorInvalidValue;
    const int smem = staged_bytes(kernel, sc);
    const int blocks = (n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    kernel<<<blocks, THREADS_PER_BLOCK, smem, (cudaStream_t)stream>>>(sc, p, smem > 0, out);
    return (int)cudaGetLastError();
}

// What a launch of cpt_render_megakernel on a scene of these table counts
// gets: *smem_bytes the dynamic shared memory of its staged tables (0: the
// tables stay in global memory), *registers the instantiation's registers
// per thread; returns its resident blocks per SM at that shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus a CUDA error.
int cpt_render_occupancy(int variant, int textured, int grid, int state_bf16,
                         int num_spheres, int num_triangles, int num_materials,
                         int num_point_lights, int num_area_lights, int num_textures,
                         int* smem_bytes, int* registers) {
    const RenderKernel kernel = render_kernel_of(variant, textured != 0, grid != 0,
                                                 state_bf16 != 0);
    if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
    *smem_bytes = staged_bytes(kernel, table_counts(num_spheres, num_triangles, num_materials,
                                                    num_point_lights, num_area_lights,
                                                    num_textures));
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return -(int)err;
    *registers = attr.numRegs;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS_PER_BLOCK,
                                                        *smem_bytes);
    return err == cudaSuccess ? blocks : -(int)err;
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
