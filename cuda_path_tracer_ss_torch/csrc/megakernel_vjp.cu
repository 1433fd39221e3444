// Replay-VJP megakernel for NVIDIA Hopper (sm_90a): the gradient of a render
// with respect to the scene tables and the camera, in ONE launch.
//
// Replaces the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py::_make_backward_kernel
// (launched there by _backward_grads) in grad modes "linear" and "full", each
// for untextured and for textured scenes (color maps; normal maps in full
// mode), each replaying through linear sweeps or the supercell grid's (the
// forward's own sweeps, megakernel.cuh). One thread per pixel over a 1-D grid,
// the ragged edge masked by
// i < n_local; the
// per-pixel math is in megakernel_vjp.cuh and replays the path with the
// forward kernel's own device functions (megakernel.cuh).
//
// Checkpoints: a global scratch buffer laid out [bounce][plane][thread], so a
// warp reads and writes neighbouring addresses; max_bounces stays a runtime
// argument (the caller sizes the buffer). A textured replay allocates only the
// planes its mode needs (megakernel_vjp.cuh: tex_layout).
//
// Accumulation: blocks run concurrently and in no order, so nothing depends on
// block order. Where the gradient rows fit (rows <= SHARED_ROWS_MAX) every block
// sums into its own rows in shared memory with atomicAdd and writes them once
// to out[block][rows]; the caller sums over blocks. Larger row counts (4 rows
// per sphere on a scene of thousands of spheres, 3 per texel of a large atlas)
// add straight into out[rows] with global atomicAdd. Either way the order of
// float additions differs from run to run: results agree to rounding, not to
// the bit. Texel rows take one atomicAdd per bilinear corner and channel.
//
// Bound on this card: the replay is one forward render's FP32 work, the
// reverse sweep adds per stored bounce, and every checkpoint is written and
// read once; on a small scene the checkpoint bytes over the memory rate come
// out just above the operations over the FP32 rate. The kernel runs far from
// both: divergent paths and dependent sqrt / div chains, like the forward.
//
// Plain C interface, loaded with ctypes: no PyTorch headers. The launch
// function enqueues on the given stream, does not synchronise, and returns
// cudaGetLastError() taken right after the launch.
#include <cuda_runtime.h>

#include "megakernel_vjp.cuh"

namespace {

constexpr int THREADS_PER_BLOCK = 128;
constexpr int SHARED_ROWS_MAX = 8192;  // 32 KB of the 48 KB a block gets without opting in

// The one sink of every gradient contribution. Most contributions of a path
// are exact zeros (g = 0, a dead branch): those are not sent.
struct AtomicSink {
    float* rows;
    __device__ __forceinline__ void add(int row, float v) const {
        if (v != 0.0f) atomicAdd(rows + row, v);
    }
};

template <bool FULL, bool SHARED, bool TEXTURED, bool GRID>
__global__ void backward_kernel(cpt::SceneTables sc, cpt::RenderParams p, cpt::GradLayout L,
                                cpt::TexLayout T, const float* __restrict__ g,
                                float* __restrict__ scratch, float* __restrict__ out) {
    extern __shared__ float block_rows[];
    if (SHARED) {
        for (int r = threadIdx.x; r < L.rows; r += blockDim.x) block_rows[r] = 0.0f;
        __syncthreads();
    }
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < p.n_local) {
        cpt::CheckpointStore st;
        st.base = scratch + i;
        st.stride = (size_t)p.n_local;
        st.planes = T.planes;
        AtomicSink sink;
        sink.rows = SHARED ? block_rows : out;
        cpt::backward_pixel<FULL, TEXTURED>(cpt::grid_tables<GRID>(sc), p, L, T,
                                            p.pixel_offset + i, g[3 * i], g[3 * i + 1],
                                            g[3 * i + 2], st, sink);
    }
    if (SHARED) {
        __syncthreads();
        float* mine = out + (size_t)blockIdx.x * L.rows;
        for (int r = threadIdx.x; r < L.rows; r += blockDim.x) mine[r] = block_rows[r];
    }
}

template <bool FULL, bool SHARED, bool TEXTURED>
void launch_backward_t(const cpt::SceneTables& sc, const cpt::RenderParams& p,
                       const cpt::GradLayout& L, const cpt::TexLayout& T, const float* g,
                       float* scratch, float* out, int blocks, size_t smem, cudaStream_t s) {
    if (sc.grid.idx != nullptr) {
        backward_kernel<FULL, SHARED, TEXTURED, true><<<blocks, THREADS_PER_BLOCK, smem, s>>>(
            sc, p, L, T, g, scratch, out);
    } else {
        backward_kernel<FULL, SHARED, TEXTURED, false><<<blocks, THREADS_PER_BLOCK, smem, s>>>(
            sc, p, L, T, g, scratch, out);
    }
}

template <bool FULL, bool SHARED>
void launch_backward(const cpt::SceneTables& sc, const cpt::RenderParams& p,
                     const cpt::GradLayout& L, const cpt::TexLayout& T, const float* g,
                     float* scratch, float* out, int blocks, size_t smem, cudaStream_t s) {
    if (T.on) {
        launch_backward_t<FULL, SHARED, true>(sc, p, L, T, g, scratch, out, blocks, smem, s);
    } else {
        launch_backward_t<FULL, SHARED, false>(sc, p, L, T, g, scratch, out, blocks, smem, s);
    }
}

}  // namespace

extern "C" {

int cpt_backward_threads_per_block() { return THREADS_PER_BLOCK; }
int cpt_backward_shared_rows_max() { return SHARED_ROWS_MAX; }

// Gradient rows (megakernel_vjp.cuh: GradLayout) of the render of flat pixels
// [pixel_offset, pixel_offset + n_local) for the per-sample cotangent
// g[n_local][3]. Tables, texture bundle, grid bundle and camera as
// cpt_render_megakernel takes them (a grid selects the grid instantiation). `full` selects the path adjoint; on a textured scene
// `tex_grads` adds the texel rows (3 per atlas texel) and `tex_nmap` says that
// some material has a normal map. scratch holds max(max_bounces, 1) * planes *
// n_local floats (planes: tex_layout(...).planes; 33 in full mode, 16 in
// linear mode without textures). With
// `shared` != 0, out is [blocks][rows], every entry written, blocks =
// ceil(n_local / cpt_backward_threads_per_block()); with `shared` == 0, out is
// [rows], zeroed by the caller and added to atomically.
int cpt_backward_megakernel(const float* spheres, int num_spheres,
                            const float* triangles, int num_triangles,
                            const float* materials, int num_materials,
                            const float* point_lights, int num_point_lights,
                            const float* area_lights, int num_area_lights,
                            const float* background,
                            const float* tex_atlas, const float* tex_meta,
                            const float* tex_triuv, const float* tex_matids, int num_textures,
                            int texels, const int* grid_idx, const float* grid_scal,
                            const int* grid_meta, const float* cam_host,
                            int seed, int pixel_offset, int n_local, int sample_offset,
                            int spp, int max_bounces, int width, int height,
                            int full, int tex_grads, int tex_nmap, int shared, const float* g,
                            float* scratch, float* out, void* stream) {
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
    cpt::set_image_size(p, width, height);
    const cpt::TexLayout T = cpt::tex_layout(full != 0, num_textures > 0, tex_grads != 0,
                                             tex_nmap != 0);
    const cpt::GradLayout L = cpt::grad_layout(num_spheres, num_materials, num_point_lights,
                                               num_area_lights, full != 0,
                                               T.grads ? texels : 0);
    if (shared && L.rows > SHARED_ROWS_MAX) return (int)cudaErrorInvalidValue;
    const int blocks = (n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    const size_t smem = shared ? (size_t)L.rows * sizeof(float) : 0;
    cudaStream_t s = (cudaStream_t)stream;
    if (full) {
        if (shared) launch_backward<true, true>(sc, p, L, T, g, scratch, out, blocks, smem, s);
        else launch_backward<true, false>(sc, p, L, T, g, scratch, out, blocks, 0, s);
    } else {
        if (shared) launch_backward<false, true>(sc, p, L, T, g, scratch, out, blocks, smem, s);
        else launch_backward<false, false>(sc, p, L, T, g, scratch, out, blocks, 0, s);
    }
    return (int)cudaGetLastError();
}

const char* cpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
