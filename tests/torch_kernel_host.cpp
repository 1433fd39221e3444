// Test-only host build of the CUDA megakernel's device math: the package's
// csrc/megakernel.cuh compiled by a host C++ compiler, one loop iteration per
// pixel, so that the kernel's arithmetic can be held against the plain PyTorch
// version on a machine without a GPU. Built by torch_port_helpers.py:
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -I <package>/csrc ...
#include "megakernel.cuh"

extern "C" {

// Same arguments as cpt_render_megakernel, every pointer a host pointer,
// without the launch parameters.
int cpt_render_megakernel_host(const float* spheres, int num_spheres,
                               const float* triangles, int num_triangles,
                               const float* materials, int num_materials,
                               const float* point_lights, int num_point_lights,
                               const float* area_lights, int num_area_lights,
                               const float* background, const float* cam_host,
                               int seed, int pixel_offset, int n_local, int sample_offset,
                               int spp, int max_bounces, int width, int height, float* out) {
    cpt::SceneTables sc;
    sc.spheres = spheres; sc.num_spheres = num_spheres;
    sc.triangles = triangles; sc.num_triangles = num_triangles;
    sc.materials = materials; sc.num_materials = num_materials;
    sc.point_lights = point_lights; sc.num_point_lights = num_point_lights;
    sc.area_lights = area_lights; sc.num_area_lights = num_area_lights;
    sc.background = background;
    cpt::RenderParams p;
    for (int k = 0; k < cpt::CAM_FLOATS; ++k) p.cam[k] = cam_host[k];
    p.seed = seed; p.pixel_offset = pixel_offset; p.n_local = n_local;
    p.sample_offset = sample_offset; p.spp = spp; p.max_bounces = max_bounces;
    cpt::set_image_size(p, width, height);
    for (int i = 0; i < n_local; ++i) {
        cpt::render_pixel(sc, p, pixel_offset + i, out[3 * i], out[3 * i + 1], out[3 * i + 2]);
    }
    return 0;
}

}  // extern "C"
