// Replay-VJP megakernel for NVIDIA Hopper (sm_90a): the gradient of a render
// with respect to the scene tables and the camera, in ONE launch.
//
// Replaces the TPU kernel
// cuda_path_tracer_ss_tpu/ops/pallas/megakernel_vjp.py::_make_backward_kernel
// (launched there by _backward_grads) in every grad mode: "linear" and "full"
// of the reference-parity estimator, "geo" (full plus the triangle and
// area-light vertex rows) and the physical estimator's adjoint with or without
// geo, each for untextured and for textured scenes (color maps; normal maps
// in full, geo and physical mode), replaying through linear sweeps or the
// supercell grid's (the forward's own sweeps, megakernel.cuh). Only what can
// be reached is instantiated: geo and physical imply the full path adjoint,
// and geo never takes the grid (geometry that moves would leave its cell lists
// stale). One thread per pixel over a 1-D grid, the ragged edge masked by
// i < n_local; the per-pixel math is in megakernel_vjp.cuh and replays the
// path with the forward kernel's own device functions (megakernel.cuh).
//
// Schedule: per-lane path regeneration in two flat passes (backward_pixel):
// one loop replays every path of the pixel, one bounce per iteration, a lane
// starting its next sample's eye ray as soon as its path ends, and pushes the
// bounces onto the lane's checkpoint stack; a second loop pops the stack, one
// reverse bounce per iteration. A warp's lanes so stay busy whatever the
// lengths of their paths; only when the stack is full do the two passes
// alternate in rounds.
//
// Checkpoints: a global scratch buffer of `capacity` slots per thread (the
// caller sizes both; at least max(max_bounces, 1) slots). Each lane's slots
// lie together, [thread][slot][plane] with slots padded to four planes
// (megakernel_vjp.cuh: CheckpointStore): lanes of a warp sit at different
// stack depths, and in this layout every sector a lane touches holds its
// own planes, the bulk of them written and read as float4. A textured replay
// allocates only the planes its mode needs (megakernel_vjp.cuh: tex_layout).
//
// Accumulation: blocks run concurrently and in no order, so nothing depends on
// block order. Where the gradient rows fit (rows <= SHARED_ROWS_MAX) every block
// sums into its own rows in shared memory with atomicAdd and writes them once
// to out[block][rows]; the caller sums over blocks. Larger row counts (4 rows
// per sphere on a scene of thousands of spheres, 3 per texel of a large atlas)
// add straight into out[rows] with global atomicAdd (as do geo mode's 18 rows
// per triangle on a mesh of a few hundred triangles). The 13 camera rows,
// which every path of full, geo and physical mode adds to, are kept apart:
// each thread sums its own in a column of shared memory, and the block
// reduces them once at its end (one add per row into the block's rows, or
// one global atomicAdd per row). Either way the order of float additions
// differs from run to run: results agree to rounding, not to the bit. Texel
// rows take one atomicAdd per bilinear corner and channel.
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
// The camera rows: each thread's 13 in a column of shared memory, rows
// CAM_PITCH floats apart so that neither the threads' adds nor the block's
// per-row sums meet in a bank.
constexpr int CAM_PITCH = THREADS_PER_BLOCK + 1;

// The one sink of every gradient contribution but the camera's. Most
// contributions of a path are exact zeros (g = 0, a dead branch): those are
// not sent.
struct AtomicSink {
    float* rows;
    __device__ __forceinline__ void add(int row, float v) const {
        if (v != 0.0f) atomicAdd(rows + row, v);
    }
};

// A thread's own camera rows: row r at col[r * CAM_PITCH]; no other thread
// touches them until the block's reduction.
struct CameraColumn {
    float* col;
    __device__ __forceinline__ void add(int row, float v) const { col[row * CAM_PITCH] += v; }
};

template <bool FULL, bool SHARED, bool TEXTURED, bool GRID, bool PHYSICAL, bool GEO>
__global__ void backward_kernel(cpt::SceneTables sc, cpt::RenderParams p, cpt::GradLayout L,
                                cpt::TexLayout T, int capacity, const float* __restrict__ g,
                                float* __restrict__ scratch, float* __restrict__ out) {
    constexpr bool COLUMNS = FULL;  // camera rows exist in full, geo and physical mode
    extern __shared__ float smem[];
    float* block_rows = smem;                       // SHARED: the block's rows
    float* cam_rows = smem + (SHARED ? L.rows : 0);  // COLUMNS: CAM_ROWS x CAM_PITCH
    if (SHARED) {
        for (int r = threadIdx.x; r < L.rows; r += blockDim.x) block_rows[r] = 0.0f;
    }
    if (COLUMNS) {
        for (int r = threadIdx.x; r < cpt::CAM_ROWS * CAM_PITCH; r += blockDim.x) {
            cam_rows[r] = 0.0f;
        }
    }
    if (SHARED || COLUMNS) __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < p.n_local) {
        cpt::CheckpointStore st;
        st.slot_floats = T.slot_floats;
        st.base = scratch + (size_t)i * capacity * T.slot_floats;
        AtomicSink sink;
        sink.rows = SHARED ? block_rows : out;
        const cpt::SceneTables tables = cpt::grid_tables<GRID>(sc);
        const int pixel = p.pixel_offset + i;
        if constexpr (COLUMNS) {
            CameraColumn cam;
            cam.col = cam_rows + threadIdx.x;
            cpt::backward_pixel<FULL, TEXTURED, PHYSICAL, GEO>(
                tables, p, L, T, pixel, g[3 * i], g[3 * i + 1], g[3 * i + 2], st, capacity, sink,
                cam, 0);
        } else {
            cpt::backward_pixel<FULL, TEXTURED, PHYSICAL, GEO>(
                tables, p, L, T, pixel, g[3 * i], g[3 * i + 1], g[3 * i + 2], st, capacity, sink,
                sink, L.row_cam0);
        }
    }
    if constexpr (COLUMNS) {
        // one sum per camera row over the block's threads
        __syncthreads();
        if (threadIdx.x < cpt::CAM_ROWS) {
            const float* row = cam_rows + threadIdx.x * CAM_PITCH;
            float sum = 0.0f;
            for (int t = 0; t < THREADS_PER_BLOCK; ++t) sum += row[t];
            if (SHARED) {
                block_rows[L.row_cam0 + threadIdx.x] += sum;
            } else if (sum != 0.0f) {
                atomicAdd(out + L.row_cam0 + threadIdx.x, sum);
            }
        }
    }
    if (SHARED) {
        __syncthreads();
        float* mine = out + (size_t)blockIdx.x * L.rows;
        for (int r = threadIdx.x; r < L.rows; r += blockDim.x) mine[r] = block_rows[r];
    }
}

// One launch of the instantiation the flags select.
struct Launch {
    cpt::SceneTables sc;
    cpt::RenderParams p;
    cpt::GradLayout L;
    cpt::TexLayout T;
    int capacity;
    const float* g;
    float* scratch;
    float* out;
    int blocks;
    size_t smem;
    cudaStream_t s;

    template <bool FULL, bool SHARED, bool TEXTURED, bool GRID, bool PHYSICAL, bool GEO>
    void run() const {
        backward_kernel<FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO>
            <<<blocks, THREADS_PER_BLOCK, smem, s>>>(sc, p, L, T, capacity, g, scratch, out);
    }

    // textured or not, grid or not (geo: never the grid)
    template <bool FULL, bool SHARED, bool PHYSICAL, bool GEO>
    int mode() const {
        const bool grid = sc.grid.idx != nullptr;
        if constexpr (GEO) {
            if (grid) return (int)cudaErrorInvalidValue;
            if (T.on) run<FULL, SHARED, true, false, PHYSICAL, GEO>();
            else run<FULL, SHARED, false, false, PHYSICAL, GEO>();
        } else {
            if (T.on && grid) run<FULL, SHARED, true, true, PHYSICAL, GEO>();
            else if (T.on) run<FULL, SHARED, true, false, PHYSICAL, GEO>();
            else if (grid) run<FULL, SHARED, false, true, PHYSICAL, GEO>();
            else run<FULL, SHARED, false, false, PHYSICAL, GEO>();
        }
        return 0;
    }

    template <bool SHARED>
    int grad_mode(bool full, bool physical, bool geo) const {
        if (physical && geo) return mode<true, SHARED, true, true>();
        if (physical) return mode<true, SHARED, true, false>();
        if (geo) return mode<true, SHARED, false, true>();
        if (full) return mode<true, SHARED, false, false>();
        return mode<false, SHARED, false, false>();
    }
};

}  // namespace

extern "C" {

int cpt_backward_threads_per_block() { return THREADS_PER_BLOCK; }
int cpt_backward_shared_rows_max() { return SHARED_ROWS_MAX; }

// Gradient rows (megakernel_vjp.cuh: GradLayout) of the render of flat pixels
// [pixel_offset, pixel_offset + n_local) for the per-sample cotangent
// g[n_local][3]. Tables, texture bundle, grid bundle and camera as
// cpt_render_megakernel takes them (a grid selects the grid instantiation).
// `full` selects the path adjoint, `physical` the physical estimator's and
// `geo` the triangle rows (both imply full; geo takes no grid); on a textured
// scene `tex_grads` adds the texel rows (3 per atlas texel) and `tex_nmap` says
// that some material has a normal map. scratch holds capacity * slot_floats
// * n_local floats: `capacity` slots per thread, at least max(max_bounces, 1)
// (tex_layout(...).slot_floats: the planes and two meta planes padded to 4; 20
// in linear mode,
// 36 in full and geo mode, 40 in physical mode, without textures). With
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
                            int full, int physical, int geo, int tex_grads, int tex_nmap,
                            int shared, int capacity, const float* g, float* scratch,
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
    cpt::set_grid(sc, grid_idx, grid_scal, grid_meta);
    cpt::RenderParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.pixel_offset = pixel_offset; p.n_local = n_local;
    p.sample_offset = sample_offset; p.spp = spp; p.max_bounces = max_bounces;
    cpt::set_image_size(p, width, height);
    const bool any_full = full || physical || geo;
    const cpt::TexLayout T = cpt::tex_layout(any_full, num_textures > 0, tex_grads != 0,
                                             tex_nmap != 0, physical != 0);
    const cpt::GradLayout L = cpt::grad_layout(num_spheres, num_triangles, num_materials,
                                               num_point_lights, num_area_lights, any_full,
                                               T.grads ? texels : 0, physical != 0, geo != 0);
    if (shared && L.rows > SHARED_ROWS_MAX) return (int)cudaErrorInvalidValue;
    if (capacity < (max_bounces > 1 ? max_bounces : 1)) return (int)cudaErrorInvalidValue;
    Launch launch;
    launch.sc = sc; launch.p = p; launch.L = L; launch.T = T; launch.capacity = capacity;
    launch.g = g; launch.scratch = scratch; launch.out = out;
    launch.blocks = (n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    launch.smem = ((shared ? (size_t)L.rows : 0)
                   + (any_full ? (size_t)cpt::CAM_ROWS * CAM_PITCH : 0))
                  * sizeof(float);
    launch.s = (cudaStream_t)stream;
    const int refused = shared ? launch.grad_mode<true>(full, physical, geo)
                               : launch.grad_mode<false>(full, physical, geo);
    if (refused) return refused;
    return (int)cudaGetLastError();
}

const char* cpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
