// Replay-VJP megakernel for NVIDIA Hopper (sm_90a): the gradient of a render
// with respect to the scene tables and the camera, in one launch (two on the
// split schedule, below).
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
// Split schedule (template parameter PHASE of backward_kernel): where one
// round holds every path, the stack already lies in device memory between
// the two passes, and they run as two launches on the stream: a replay
// launch (PHASE_REPLAY: pass 1, each lane's slots in use kept in tops[]) and
// a reverse launch (PHASE_REVERSE: pass 2 from tops[]), each under its own
// register budget. Only a few values live across the seam (pixel, g, top,
// the camera column); the fused launch (PHASE_FUSED) holds registers for the
// larger of its two loops plus what the compiler keeps live across both.
// The split launches carry __launch_bounds__(THREADS_PER_BLOCK, 4): at most
// 128 registers, so that 4 blocks of 128 threads (16 warps) fit an SM's
// 65,536 registers and a 256x256 launch's 512 blocks are resident at once on
// the H100's 132 SMs (528 slots), where the fused physical kernel's 190
// registers (192 allocated: 2 blocks per SM, 264 slots) run them in 1.94
// waves. The wrapper takes the split for physical mode without geo on
// untextured scenes (linear sweeps or the grid), and only with a stack of
// one round; every other call (linear, full, geo, physical + geo, textured
// physical, stacks of several rounds) takes the fused launch. Per path the
// arithmetic is the same; only the order of the row additions differs.
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
// Latency, not instruction throughput, bounds those chains, so resident
// warps count: on an H100 at cornell 256x256 x 16 spp x 8 bounces the
// physical split schedule (replay 128 registers with a few hundred bytes of
// spills, reverse 126, 4 blocks per SM) takes 4.8 ms against the fused
// launch's 8.3 (2 blocks per SM), about 2.0 % of its FP32 bound against
// 1.2 %.
//
// Plain C interface, loaded with ctypes: no PyTorch headers. The launch
// function enqueues on the given stream, does not synchronise, and returns
// cudaGetLastError() taken right after each launch.
#include <cuda_runtime.h>

#include <type_traits>

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

// A launch's schedule: both passes of every round (PHASE_FUSED), or one of
// the split schedule's two launches (the replay, then the reverse sweep).
constexpr int PHASE_FUSED = 0;
constexpr int PHASE_REPLAY = 1;
constexpr int PHASE_REVERSE = 2;
// Resident blocks per SM the split schedule's launches are compiled for: at
// most 65,536 / (4 * THREADS_PER_BLOCK) = 128 registers a thread.
constexpr int SPLIT_MIN_BLOCKS = 4;

// The dynamic shared memory of a launch: the block's rows (SHARED) and the
// camera columns (full, geo and physical mode; not in the replay, which adds
// nothing to the camera rows).
size_t smem_bytes(bool shared, int rows, bool any_full, int phase) {
    return ((shared ? (size_t)rows : 0)
            + (any_full && phase != PHASE_REPLAY ? (size_t)cpt::CAM_ROWS * CAM_PITCH : 0))
           * sizeof(float);
}

// A pixel's sweep with the camera rows in `cam` from `cam_row0`: all rounds
// of both passes (PHASE_FUSED), or the reverse sweep of the `top` slots the
// replay launch left on the stack (PHASE_REVERSE).
template <bool FULL, bool TEXTURED, bool PHYSICAL, bool GEO, int PHASE, class CamSink>
__device__ __forceinline__ void sweep_pixel(const cpt::SceneTables& sc, const cpt::RenderParams& p,
                                            const cpt::GradLayout& L, const cpt::TexLayout& T,
                                            int pixel, float gx, float gy, float gz,
                                            const cpt::CheckpointStore& st, int capacity, int top,
                                            AtomicSink& sink, CamSink& cam, int cam_row0) {
    if constexpr (PHASE == PHASE_REVERSE) {
        cpt::backward_pixel_reverse<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, gx, gy, gz,
                                                                   st, top, sink, cam, cam_row0);
    } else {
        cpt::backward_pixel<FULL, TEXTURED, PHYSICAL, GEO>(sc, p, L, T, pixel, gx, gy, gz, st,
                                                           capacity, sink, cam, cam_row0);
    }
}

// The body of every launch: one thread per pixel, the block's rows and camera
// columns in shared memory, written to out[block][rows] at the end (SHARED)
// or added to out[rows] with global atomics. The replay launch writes each
// lane's slots in use to tops[i]; the reverse launch reads them.
template <bool FULL, bool SHARED, bool TEXTURED, bool GRID, bool PHYSICAL, bool GEO, int PHASE>
__device__ __forceinline__ void backward_block(const cpt::SceneTables& sc,
                                               const cpt::RenderParams& p,
                                               const cpt::GradLayout& L, const cpt::TexLayout& T,
                                               int capacity, const float* __restrict__ g,
                                               float* __restrict__ scratch, int* __restrict__ tops,
                                               float* __restrict__ out) {
    // camera rows exist in full, geo and physical mode; the replay adds to none
    constexpr bool COLUMNS = FULL && PHASE != PHASE_REPLAY;
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
        const float gx = g[3 * i], gy = g[3 * i + 1], gz = g[3 * i + 2];
        const int top = PHASE == PHASE_REVERSE ? tops[i] : 0;
        if constexpr (PHASE == PHASE_REPLAY) {
            tops[i] = cpt::backward_pixel_replay<FULL, TEXTURED, PHYSICAL, GEO>(
                tables, p, L, T, pixel, gx, gy, gz, st, capacity, sink);
        } else if constexpr (COLUMNS) {
            CameraColumn cam;
            cam.col = cam_rows + threadIdx.x;
            sweep_pixel<FULL, TEXTURED, PHYSICAL, GEO, PHASE>(tables, p, L, T, pixel, gx, gy, gz,
                                                              st, capacity, top, sink, cam, 0);
        } else {
            sweep_pixel<FULL, TEXTURED, PHYSICAL, GEO, PHASE>(tables, p, L, T, pixel, gx, gy, gz,
                                                              st, capacity, top, sink, sink,
                                                              L.row_cam0);
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

// The fused schedule, every instantiation: no launch bound (K2 physical
// holds 190-203 registers untextured, 2 blocks per SM).
template <bool FULL, bool SHARED, bool TEXTURED, bool GRID, bool PHYSICAL, bool GEO, int PHASE,
          std::enable_if_t<PHASE == PHASE_FUSED, int> = 0>
__global__ void backward_kernel(cpt::SceneTables sc, cpt::RenderParams p, cpt::GradLayout L,
                                cpt::TexLayout T, int capacity, const float* __restrict__ g,
                                float* __restrict__ scratch, int* __restrict__ tops,
                                float* __restrict__ out) {
    backward_block<FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO, PHASE>(sc, p, L, T, capacity, g,
                                                                       scratch, tops, out);
}

// The split schedule's two launches (physical mode, untextured, linear sweeps
// or the grid): each under its own register budget, 4 blocks per SM, so
// that a 256x256 launch's 512 blocks are resident at once on 132 SMs.
template <bool FULL, bool SHARED, bool TEXTURED, bool GRID, bool PHYSICAL, bool GEO, int PHASE,
          std::enable_if_t<PHASE != PHASE_FUSED, int> = 0>
__global__ void __launch_bounds__(THREADS_PER_BLOCK, SPLIT_MIN_BLOCKS)
    backward_kernel(cpt::SceneTables sc, cpt::RenderParams p, cpt::GradLayout L,
                    cpt::TexLayout T, int capacity, const float* __restrict__ g,
                    float* __restrict__ scratch, int* __restrict__ tops,
                    float* __restrict__ out) {
    backward_block<FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO, PHASE>(sc, p, L, T, capacity, g,
                                                                       scratch, tops, out);
}

using BackwardKernel = void (*)(cpt::SceneTables, cpt::RenderParams, cpt::GradLayout,
                                cpt::TexLayout, int, const float*, float*, int*, float*);

// One launch of the instantiation the flags and `phase` select, or, with
// `occupancy` set, what that instantiation gets on the current device:
// occupancy[0] resident blocks per SM at `smem` bytes, [1] registers and [2]
// local memory bytes (stack, spills) per thread.
struct Launch {
    cpt::SceneTables sc;
    cpt::RenderParams p;
    cpt::GradLayout L;
    cpt::TexLayout T;
    int capacity;
    const float* g;
    float* scratch;
    int* tops;
    float* out;
    int blocks;
    size_t smem;
    cudaStream_t s;
    bool textured, grid;
    int phase;
    int* occupancy = nullptr;

    template <bool FULL, bool SHARED, bool TEXTURED, bool GRID, bool PHYSICAL, bool GEO, int PHASE>
    int run() const {
        if (occupancy == nullptr) {
            backward_kernel<FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO, PHASE>
                <<<blocks, THREADS_PER_BLOCK, smem, s>>>(sc, p, L, T, capacity, g, scratch, tops,
                                                         out);
            return 0;
        }
        const BackwardKernel kernel = backward_kernel<FULL, SHARED, TEXTURED, GRID, PHYSICAL,
                                                      GEO, PHASE>;
        cudaFuncAttributes attr = {};
        cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
        if (err == cudaSuccess) {
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(occupancy, kernel,
                                                                THREADS_PER_BLOCK, smem);
        }
        occupancy[1] = attr.numRegs;
        occupancy[2] = (int)attr.localSizeBytes;
        return (int)err;
    }

    // the phase: the split schedule's launches exist for the physical mode's
    // untextured instantiations alone
    template <bool FULL, bool SHARED, bool TEXTURED, bool GRID, bool PHYSICAL, bool GEO>
    int phased() const {
        if constexpr (PHYSICAL && !GEO && !TEXTURED) {
            if (phase == PHASE_REPLAY)
                return run<FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO, PHASE_REPLAY>();
            if (phase == PHASE_REVERSE)
                return run<FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO, PHASE_REVERSE>();
        }
        if (phase != PHASE_FUSED) return (int)cudaErrorInvalidValue;
        return run<FULL, SHARED, TEXTURED, GRID, PHYSICAL, GEO, PHASE_FUSED>();
    }

    // textured or not, grid or not (geo: never the grid)
    template <bool FULL, bool SHARED, bool PHYSICAL, bool GEO>
    int mode() const {
        if constexpr (GEO) {
            if (grid) return (int)cudaErrorInvalidValue;
            if (textured) return phased<FULL, SHARED, true, false, PHYSICAL, GEO>();
            return phased<FULL, SHARED, false, false, PHYSICAL, GEO>();
        } else {
            if (textured && grid) return phased<FULL, SHARED, true, true, PHYSICAL, GEO>();
            if (textured) return phased<FULL, SHARED, true, false, PHYSICAL, GEO>();
            if (grid) return phased<FULL, SHARED, false, true, PHYSICAL, GEO>();
            return phased<FULL, SHARED, false, false, PHYSICAL, GEO>();
        }
    }

    template <bool SHARED>
    int grad_mode(bool full, bool physical, bool geo) const {
        if (physical && geo) return mode<true, SHARED, true, true>();
        if (physical) return mode<true, SHARED, true, false>();
        if (geo) return mode<true, SHARED, false, true>();
        if (full) return mode<true, SHARED, false, false>();
        return mode<false, SHARED, false, false>();
    }

    int dispatch(bool shared, bool full, bool physical, bool geo) const {
        return shared ? grad_mode<true>(full, physical, geo)
                      : grad_mode<false>(full, physical, geo);
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
//
// `split` != 0 runs the split schedule: a replay launch, then a reverse
// launch on the same stream, the stack in scratch between them and each
// lane's slots in use in tops[n_local]. Only for physical mode without geo
// on an untextured scene, and only with a stack that holds every path
// (capacity >= max(max_bounces, 1) * spp); with `shared`, out is then
// [2][blocks][rows] (the replay's rows, then the reverse sweep's).
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
                            int shared, int capacity, int split, const float* g, float* scratch,
                            int* tops, float* out, void* stream) {
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
    const int span = max_bounces > 1 ? max_bounces : 1;
    if (shared && L.rows > SHARED_ROWS_MAX) return (int)cudaErrorInvalidValue;
    if (capacity < span) return (int)cudaErrorInvalidValue;
    if (split && ((long long)capacity < (long long)span * spp || tops == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    Launch launch;
    launch.sc = sc; launch.p = p; launch.L = L; launch.T = T; launch.capacity = capacity;
    launch.g = g; launch.scratch = scratch; launch.tops = tops; launch.out = out;
    launch.blocks = (n_local + THREADS_PER_BLOCK - 1) / THREADS_PER_BLOCK;
    launch.s = (cudaStream_t)stream;
    launch.textured = T.on;
    launch.grid = sc.grid.idx != nullptr;
    const int phases[2] = {split ? PHASE_REPLAY : PHASE_FUSED, PHASE_REVERSE};
    for (int k = 0; k < (split ? 2 : 1); ++k) {
        launch.phase = phases[k];
        launch.smem = smem_bytes(shared, L.rows, any_full, launch.phase);
        if (k == 1 && shared) launch.out = out + (size_t)launch.blocks * L.rows;
        const int refused = launch.dispatch(shared, full, physical, geo);
        if (refused) return refused;
        const int err = (int)cudaGetLastError();
        if (err) return err;
    }
    return 0;
}

// What a launch of cpt_backward_megakernel with these flags and `rows`
// gradient rows (the shared route when rows <= cpt_backward_shared_rows_max())
// gets on the current device in schedule phase `phase` (0 the fused launch,
// 1 the split schedule's replay, 2 its reverse sweep): *registers per
// thread and *local_bytes of local memory per thread (stack frame and
// spills) of the instantiation; returns its resident blocks per SM at the
// launch's shared memory (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or
// minus a CUDA error.
int cpt_backward_occupancy(int full, int physical, int geo, int textured, int grid, int rows,
                           int phase, int* registers, int* local_bytes) {
    const bool shared = rows <= SHARED_ROWS_MAX;
    const bool any_full = full || physical || geo;
    int occupancy[3] = {0, 0, 0};
    Launch launch;
    launch.textured = textured != 0;
    launch.grid = grid != 0;
    launch.phase = phase;
    launch.smem = smem_bytes(shared, rows, any_full, phase);
    launch.occupancy = occupancy;
    const int err = launch.dispatch(shared, full, physical, geo);
    if (err) return -err;
    *registers = occupancy[1];
    *local_bytes = occupancy[2];
    return occupancy[0];
}

const char* cpt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
