/**
 * Golden-parity harness, part 1: scene + octree field dump.
 *
 * Compiles the REFERENCE'S OWN host C++ (SimulationBox.cpp,
 * BacteriaBox.cpp, octree.cpp, xorshift.h — all CUDA-free; see
 * golden/build.sh) and drives it to emit machine-readable ground truth
 * for direct parity measurement against the JAX rebuild:
 *
 *   scene_mnps.csv    x,y,z,r,M of every MNP incl. periodic images
 *                     (apply_bcs_on_mnps, SimulationBox.cpp:348-527)
 *   scene_cells.csv   cell centers (BacteriaBox::init_cells,
 *                     BacteriaBox.cpp:49-72)
 *   scene_waters.csv  initial water positions, Morton-sorted
 *                     (BacteriaBox.cpp:80-105, SimulationBox.cpp:131-147)
 *   field_probes.csv  per probe point: the octree's cached field in BOTH
 *                     conventions —
 *                       B_cpu: Octree::get_field as written
 *                              (octree.cpp:132-161; resident dipoles
 *                              re-added UNmasked, octree.cpp:151-158)
 *                       B_gpu: the GPU traversal's convention
 *                              (cuda_sim.cu:269-286): identical except
 *                              residents use the masked dipole_field
 *                              (cuda_sim.cu:107-114, zero inside cell_r)
 *                     plus n_res (resident count) for diagnostics.
 *
 * This file is OUR code: it only #includes the reference headers and
 * calls their public API.  The one formula reproduced here is the
 * 3-line point-dipole B_z (octree.cpp:206-210) needed to convert between
 * the two resident conventions; everything else is API calls.
 *
 * Usage: ref_scene_dump <seed> <out_dir> [probe_n] [n_near_per_mnp]
 *   probe lattice: probe_n^3 uniform over [0, bound)^3 (offset half-cell)
 *   near probes:   n_near_per_mnp points at log-spaced radii 0.05..2.0 µm
 *                  around each of the first 64 intra-box MNPs
 */

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>

#include "BacteriaBox.h"
#include "octree.h"
#include "parameters.h"
#include "rand_walk.h"
#include "xorshift.h"

#include "ref_common.h"

// The reference declares `extern ParameterStruct p` (parameters.h:128)
// and defines it in cuda_sim.cu:41, which we do not compile; the
// dummy-flag ctor fills the derived members (parameters.h:106-122).
ParameterStruct p(0);


int main(int argc, char **argv) {
    if (argc < 3) {
        fprintf(stderr,
                "usage: %s <seed> <out_dir> [probe_n=24] [near_per_mnp=32]\n",
                argv[0]);
        return 2;
    }
    uint64_t seed = strtoull(argv[1], nullptr, 10);
    std::string out = argv[2];
    int probe_n = argc > 3 ? atoi(argv[3]) : 24;
    int near_per_mnp = argc > 4 ? atoi(argv[4]) : 32;

    XORShift<> gen(seed);
    BacteriaBox box(&gen);
    box.populateSimulation();

    Octree *tree = box.getOctree();
    int n_mnp = box.getMNPCount();
    MNP_info *mnps = box.getMNPs();
    Triple *cells = box.getCells();
    water_info *waters = box.getWaters();

    FILE *f = fopen((out + "/scene_mnps.csv").c_str(), "w");
    fprintf(f, "x,y,z,r,M\n");
    for (int i = 0; i < n_mnp; i++)
        fprintf(f, "%.17g,%.17g,%.17g,%.17g,%.17g\n", mnps[i].x, mnps[i].y,
                mnps[i].z, mnps[i].r, mnps[i].M);
    fclose(f);

    f = fopen((out + "/scene_cells.csv").c_str(), "w");
    fprintf(f, "x,y,z\n");
    for (int i = 0; i < p.num_cells; i++)
        fprintf(f, "%.17g,%.17g,%.17g\n", cells[i].x, cells[i].y, cells[i].z);
    fclose(f);

    f = fopen((out + "/scene_waters.csv").c_str(), "w");
    fprintf(f, "x,y,z\n");
    for (int i = 0; i < p.num_water; i++)
        fprintf(f, "%.17g,%.17g,%.17g\n", waters[i].x, waters[i].y,
                waters[i].z);
    fclose(f);

    // Probe set: uniform lattice (cell-centered so no probe sits exactly
    // on an octree face) + log-spaced shells around intra-box MNPs.
    f = fopen((out + "/field_probes.csv").c_str(), "w");
    fprintf(f, "x,y,z,B_cpu,B_gpu,n_res\n");
    double h = p.bound / probe_n;
    for (int i = 0; i < probe_n; i++)
        for (int j = 0; j < probe_n; j++)
            for (int k = 0; k < probe_n; k++) {
                water_info w;
                w.x = (i + 0.5) * h;
                w.y = (j + 0.5) * h;
                w.z = (k + 0.5) * h;
                int n_res;
                double bg = golden_field_gpu(tree, &w, &n_res);
                double bc = tree->get_field(&w);
                fprintf(f, "%.17g,%.17g,%.17g,%.17g,%.17g,%d\n", w.x, w.y,
                        w.z, bc, bg, n_res);
            }
    // near-dipole shells: fixed-seed sampling, independent of the scene RNG
    std::mt19937_64 prng(12345);
    std::uniform_real_distribution<double> u(-1.0, 1.0);
    int n_centers = p.num_cells < 64 ? p.num_cells : 64;
    for (int c = 0; c < n_centers; c++) {
        for (int s = 0; s < near_per_mnp; s++) {
            // near_per_mnp == 1 would divide 0/0 (NaN radius -> NaN
            // probe coords past the bounds check -> UB in the octree
            // walk); a single shell sits at the minimum radius
            double r = near_per_mnp < 2 ? 0.05
                : 0.05 * pow(2.0 / 0.05, s / (double)(near_per_mnp - 1));
            double dx = u(prng), dy = u(prng), dz = u(prng);
            double n = sqrt(NORMSQ(dx, dy, dz));
            if (n < 1e-9) continue;
            water_info w;
            w.x = mnps[c].x + dx / n * r;
            w.y = mnps[c].y + dy / n * r;
            w.z = mnps[c].z + dz / n * r;
            if (w.x < 0 || w.x >= p.bound || w.y < 0 || w.y >= p.bound ||
                w.z < 0 || w.z >= p.bound)
                continue;
            int n_res;
            double bg = golden_field_gpu(tree, &w, &n_res);
            double bc = tree->get_field(&w);
            fprintf(f, "%.17g,%.17g,%.17g,%.17g,%.17g,%d\n", w.x, w.y, w.z,
                    bc, bg, n_res);
        }
    }
    fclose(f);

    // reference-format scene dump (print_simulation_stats,
    // SimulationBox.cpp:214-237) writes ./simulation_stats.csv
    box.print_simulation_stats();

    fprintf(stderr, "dumped scene (%d MNPs incl. images) to %s\n", n_mnp,
            out.c_str());
    return 0;
}
