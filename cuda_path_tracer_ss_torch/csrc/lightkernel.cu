// Light-tracing kernel for NVIDIA Hopper (sm_90a): every light path of a
// batch — emission, all bounces, all camera connections — and the image they
// splat, in ONE launch.
//
// Replaces the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/lightkernel.py::_make_light_kernel
// (launched there by _light_records), with and without the bidirectional MIS
// weights, and the scatter-add that follows it there: Mosaic has no per-lane
// scatter, so the TPU kernel writes one record per path vertex and leaves
// their sum to an XLA scatter outside its body. On this card each gate that
// passes adds its rgb into the unnormalised image [width * height][3] with
// float atomics whose result is unused (RED): the image sink. A record sink
// writes the old records instead, [max_bounces + 1][n_local] planes (pixel
// index, r, g, b), zero where no splat was made; it serves the comparison
// with the plain version record by record and is on no render path. Four
// instantiations of one source: <BIDIR, SPLAT>. One thread per light path
// over a 1-D grid; the ragged edge is masked by i < n_local.
//
// Bound on this card: FP32 arithmetic throughput — a path sweeps the scene
// twice per bounce (nearest hit, visibility of the eye) — while the image
// sink moves the tables and 12 bytes per pixel. Caustic 512x512, 2,097,152
// paths, 8 bounces: 0.109 ms of FP32 operations with the bidirectional
// weights (chip_smoke.py [bound]).
//
// What held it back (records summed by an index_add_; NVIDIA H100 80GB HBM3,
// 700 W): the kernel took 2.72 ms, the index_add_ of its 18.9 M records 32 ms
// (89 % of them empty, all aimed at pixel 0, where L2 serialises their
// atomics). What the design does about it: no records and no index_add_ on
// the render path. About one splat per path passes its gates (0.99), spread
// over the image (the hottest pixel takes 217 of 2.1 M), so the atomics
// barely meet: render_lighttrace_fast there 1.63-1.69 / 2.48-2.52 ms (plain /
// bidirectional weights) against 33.88-33.91 / 34.74-34.78 (k1_turns.py, in
// turns on one card).
//
// Not kept, measured in turns on that card (k1_turns.py, patched copies):
// per-lane regeneration over a persistent grid (a lane opens its next path
// as soon as one ends, one bounce per iteration) more than doubles the lane
// efficiency of the bounce loop (0.32 -> 0.74-0.76: light paths make 1.97
// bounces on average, a warp of 32 runs about 6) yet ran 18 % / 12 % slower
// and lost 10 of 10 pairs in each weight mode, in two calls. The emission
// vertex alone takes 0.17-0.20 ms in either schedule; where the rest goes is
// open (PERF.md). One float4 atomic per splat in place of three float
// atomics: no gain.
//
// Plain C interface, loaded with ctypes: no PyTorch headers. The launch
// functions enqueue on the given stream, do not synchronise, and return
// cudaGetLastError() taken right after the launch.
#include <cuda_runtime.h>

#include "lightkernel.cuh"

namespace {

constexpr int THREADS_PER_BLOCK = 128;

// The image sink: one float atomic per channel into the pixel's rgb.
struct ImageSink {
    float* img;
    __device__ __forceinline__ void splat(int, int, int pixel, float r, float g,
                                          float b) const {
        float* px = img + 3 * (size_t)pixel;
        atomicAdd(px, r);
        atomicAdd(px + 1, g);
        atomicAdd(px + 2, b);
    }
};

template <bool BIDIR, bool SPLAT>
__global__ void light_kernel(cpt::SceneTables sc, cpt::LightParams p, cpt::RecordSink records,
                             float* __restrict__ img) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= p.n_local) return;
    // the JAX light kernel takes no grid: linear sweeps, folded at compile time
    const cpt::SceneTables tables = cpt::grid_tables<false>(sc);
    if constexpr (SPLAT) {
        cpt::light_path<BIDIR>(tables, p, i, ImageSink{img});
    } else {
        cpt::light_path<BIDIR>(tables, p, i, records);
    }
}

using LightKernel = void (*)(cpt::SceneTables, cpt::LightParams, cpt::RecordSink, float*);

LightKernel light_kernel_of(bool bidir, bool splat) {
    if (splat) return bidir ? light_kernel<true, true> : light_kernel<false, true>;
    return bidir ? light_kernel<true, false> : light_kernel<false, false>;
}

// Resident blocks per SM of `kernel` and the SM count of the current device.
cudaError_t residency(LightKernel kernel, int& blocks_per_sm, int& sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kernel,
                                                            THREADS_PER_BLOCK, 0);
    }
    return err;
}

int launch(bool bidir, bool splat, const float* spheres, int num_spheres,
           const float* triangles, int num_triangles, const float* materials, int num_materials,
           const float* point_lights, int num_point_lights, const float* area_lights,
           int num_area_lights, const float* cam_host, int seed, int path_offset, int n_local,
           int sample_idx, int n_paths, int max_bounces, int width, int height,
           cpt::RecordSink records, float* img, void* stream) {
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
    const long long blocks = ((long long)n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    light_kernel_of(bidir, splat)<<<(int)blocks, THREADS_PER_BLOCK, 0, (cudaStream_t)stream>>>(
        sc, p, records, img);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Records pix/r/g/b[max_bounces + 1][n_local] of the light paths with global
// indices [path_offset, path_offset + n_local) of a batch of n_paths, into
// planes the caller has zeroed. Table pointers are device pointers as for
// cpt_render_megakernel; cam_host points at 16 host floats (slot 15: the
// count ratio nu, read when bidir != 0).
int cpt_light_records(const float* spheres, int num_spheres,
                      const float* triangles, int num_triangles,
                      const float* materials, int num_materials,
                      const float* point_lights, int num_point_lights,
                      const float* area_lights, int num_area_lights,
                      const float* cam_host,
                      int seed, int path_offset, int n_local, int sample_idx,
                      int n_paths, int max_bounces, int width, int height, int bidir,
                      int* pix, float* r, float* g, float* b, void* stream) {
    cpt::RecordSink records{pix, r, g, b, (size_t)n_local};
    return launch(bidir != 0, false, spheres, num_spheres, triangles, num_triangles, materials,
                  num_materials, point_lights, num_point_lights, area_lights, num_area_lights,
                  cam_host, seed, path_offset, n_local, sample_idx, n_paths, max_bounces, width,
                  height, records, nullptr, stream);
}

// The same paths splatted into img[width * height][3] (float32, zeroed by the
// caller, unnormalised): the sum of their records, added with atomics.
int cpt_light_image(const float* spheres, int num_spheres,
                    const float* triangles, int num_triangles,
                    const float* materials, int num_materials,
                    const float* point_lights, int num_point_lights,
                    const float* area_lights, int num_area_lights,
                    const float* cam_host,
                    int seed, int path_offset, int n_local, int sample_idx,
                    int n_paths, int max_bounces, int width, int height, int bidir,
                    float* img, void* stream) {
    cpt::RecordSink none{nullptr, nullptr, nullptr, nullptr, 0};
    return launch(bidir != 0, true, spheres, num_spheres, triangles, num_triangles, materials,
                  num_materials, point_lights, num_point_lights, area_lights, num_area_lights,
                  cam_host, seed, path_offset, n_local, sample_idx, n_paths, max_bounces, width,
                  height, none, img, stream);
}

// What a launch of instantiation <bidir, splat> gets on the current device:
// *registers per thread, *blocks_per_sm resident blocks of THREADS_PER_BLOCK
// threads, *sms the device's SM count, *threads_per_block. Returns 0 or a
// CUDA error.
int cpt_light_occupancy(int bidir, int splat, int* registers, int* blocks_per_sm, int* sms,
                        int* threads_per_block) {
    const LightKernel kernel = light_kernel_of(bidir != 0, splat != 0);
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *registers = attr.numRegs;
    *threads_per_block = THREADS_PER_BLOCK;
    return (int)residency(kernel, *blocks_per_sm, *sms);
}

const char* cpt_light_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
