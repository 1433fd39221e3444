// Light-tracing kernel for NVIDIA Hopper (sm_90a): every light path of a
// batch — emission, all bounces, all camera connections — in ONE launch.
//
// Replaces the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/lightkernel.py::_make_light_kernel
// (launched there by _light_records), with and without the bidirectional MIS
// weights: two instantiations of one source. One thread per light path over a
// 1-D grid; the ragged edge is masked by i < n_local. The per-path math is in
// lightkernel.cuh. The kernel writes splat RECORDS, planes of
// [max_bounces + 1][n_local] (pixel index, r, g, b), coalesced across the
// threads of a warp; the caller sums them into the image, as the TPU kernel
// leaves that sum to a scatter-add outside its body.
//
// Bound on this card: FP32 arithmetic throughput — a path sweeps the scene
// twice per bounce (nearest hit, visibility of the eye) and writes 16 bytes
// per record. The number of paths, the bounce cap, the sample index and the
// path offset are runtime arguments: one build serves every batch size.
//
// Plain C interface, loaded with ctypes: no PyTorch headers. The launch
// function enqueues on the given stream, does not synchronise, and returns
// cudaGetLastError() taken right after the launch.
#include <cuda_runtime.h>

#include "lightkernel.cuh"

namespace {

constexpr int THREADS_PER_BLOCK = 128;

template <bool BIDIR>
__global__ void light_kernel(cpt::SceneTables sc, cpt::LightParams p,
                             int* __restrict__ pix, float* __restrict__ r,
                             float* __restrict__ g, float* __restrict__ b) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n_local) return;
    cpt::RecordOut out;
    out.pix = pix + i; out.r = r + i; out.g = g + i; out.b = b + i;
    out.stride = (size_t)p.n_local;
    // the JAX light kernel takes no grid: linear sweeps, folded at compile time
    cpt::light_path<BIDIR>(cpt::grid_tables<false>(sc), p, p.path_offset + i, out);
}

}  // namespace

extern "C" {

// Records pix/r/g/b[max_bounces + 1][n_local] of the light paths with global
// indices [path_offset, path_offset + n_local) of a batch of n_paths. Table
// pointers are device pointers as for cpt_render_megakernel; cam_host points
// at 16 host floats (slot 15: the count ratio nu, read when bidir != 0).
int cpt_light_records(const float* spheres, int num_spheres,
                      const float* triangles, int num_triangles,
                      const float* materials, int num_materials,
                      const float* point_lights, int num_point_lights,
                      const float* area_lights, int num_area_lights,
                      const float* cam_host,
                      int seed, int path_offset, int n_local, int sample_idx,
                      int n_paths, int max_bounces, int width, int height, int bidir,
                      int* pix, float* r, float* g, float* b, void* stream) {
    cpt::SceneTables sc;
    sc.spheres = spheres; sc.num_spheres = num_spheres;
    sc.triangles = triangles; sc.num_triangles = num_triangles;
    sc.materials = materials; sc.num_materials = num_materials;
    sc.point_lights = point_lights; sc.num_point_lights = num_point_lights;
    sc.area_lights = area_lights; sc.num_area_lights = num_area_lights;
    sc.background = nullptr;
    sc.tex_atlas = sc.tex_meta = sc.tex_triuv = sc.tex_matids = nullptr;
    sc.num_textures = 0;  // the light kernel has no texture block
    cpt::LightParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.path_offset = path_offset; p.n_local = n_local;
    p.sample_idx = sample_idx; p.n_paths = n_paths; p.max_bounces = max_bounces;
    cpt::set_light_image_size(p, width, height);
    const int blocks = (n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    const cudaStream_t st = (cudaStream_t)stream;
    if (bidir) {
        light_kernel<true><<<blocks, THREADS_PER_BLOCK, 0, st>>>(sc, p, pix, r, g, b);
    } else {
        light_kernel<false><<<blocks, THREADS_PER_BLOCK, 0, st>>>(sc, p, pix, r, g, b);
    }
    return (int)cudaGetLastError();
}

const char* cpt_light_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
