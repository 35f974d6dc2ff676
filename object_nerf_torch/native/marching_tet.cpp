// Native marching-tetrahedra iso-surface extraction (host code, not a device
// kernel).
//
// Own copy of object_nerf_tpu/native/marching_tet.cpp: the counterpart of the
// reference's compiled mesh dependency (PyMCubes' C++ marching cubes,
// tools/extract_mesh.py:120). The density grid comes off the GPU; the surface
// walk is host work that the reference also runs in compiled code. Same
// algorithm and tables as the numpy tools/marching.py (6-tet cube
// decomposition around the 0-6 diagonal, edge-interpolated vertices
// deduplicated by canonical edge key, degenerate faces dropped); the numpy
// path stays selectable and is the parity oracle.
//
// Plain C ABI for ctypes: mt_run builds the mesh into an opaque handle,
// mt_copy moves it into caller-allocated numpy buffers, mt_free releases it.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (native/__init__.py;
// OpenMP parallelizes the per-x-slab triangle emission, the edge dedup is a
// single-threaded hash pass).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <unordered_map>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// cube corner offsets, bit order (x, y, z) — tools/marching.py _CORNERS
const int CORNERS[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1},
};

// 6-tet decomposition of the cube around the 0-6 diagonal — _TETS
const int TETS[6][4] = {
    {0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
    {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6},
};

// tet edges by local vertex pair — _EDGES
const int EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// triangles (edge-index triples) per inside-bitmask case; -1 pads — _CASES
const int CASES[16][2][3] = {
    {{-1, -1, -1}, {-1, -1, -1}},  // 0
    {{0, 1, 2}, {-1, -1, -1}},     // 1
    {{0, 3, 4}, {-1, -1, -1}},     // 2
    {{1, 3, 4}, {1, 4, 2}},        // 3
    {{1, 3, 5}, {-1, -1, -1}},     // 4
    {{0, 3, 5}, {0, 5, 2}},        // 5
    {{0, 1, 5}, {0, 5, 4}},        // 6
    {{2, 4, 5}, {-1, -1, -1}},     // 7
    {{2, 4, 5}, {-1, -1, -1}},     // 8
    {{0, 1, 5}, {0, 5, 4}},        // 9
    {{0, 3, 5}, {0, 5, 2}},        // 10
    {{1, 3, 5}, {-1, -1, -1}},     // 11
    {{1, 3, 4}, {1, 4, 2}},        // 12
    {{0, 3, 4}, {-1, -1, -1}},     // 13
    {{0, 1, 2}, {-1, -1, -1}},     // 14
    {{-1, -1, -1}, {-1, -1, -1}},  // 15
};

struct TriCorner {       // one triangle corner = a point on a cube edge
    int64_t lo, hi;      // canonical (sorted) global flat point ids
    double w;            // interpolation weight from lo toward hi
};

struct Mesh {
    std::vector<float> verts;    // (V, 3) interleaved
    std::vector<int64_t> faces;  // (F, 3) interleaved
};

struct EmitBuf {
    std::vector<TriCorner> corners;  // 3 per triangle, in face order
};

inline void emit_slab(const float* vol, const uint8_t* inside,
                      int64_t nx, int64_t ny, int64_t nz, float level,
                      int64_t x0, int64_t x1, EmitBuf& out) {
    const int64_t syz = ny * nz;  // x stride
    for (int64_t x = x0; x < x1; ++x) {
        for (int64_t y = 0; y < ny - 1; ++y) {
            const int64_t base = x * syz + y * nz;
            for (int64_t z = 0; z < nz - 1; ++z) {
                const int64_t p = base + z;
                // corner inside-bits, same bit order as the numpy path
                unsigned b = 0;
                for (int c = 0; c < 8; ++c) {
                    const int64_t q =
                        p + CORNERS[c][0] * syz + CORNERS[c][1] * nz +
                        CORNERS[c][2];
                    b |= static_cast<unsigned>(inside[q]) << c;
                }
                if (b == 0u || b == 255u) continue;  // surface-cube cull
                float vals[8];
                int64_t gids[8];
                for (int c = 0; c < 8; ++c) {
                    const int64_t q =
                        p + CORNERS[c][0] * syz + CORNERS[c][1] * nz +
                        CORNERS[c][2];
                    vals[c] = vol[q];
                    gids[c] = q;  // global flat id == linear index
                }
                for (int t = 0; t < 6; ++t) {
                    const unsigned tc =
                        ((b >> TETS[t][0]) & 1u) |
                        (((b >> TETS[t][1]) & 1u) << 1) |
                        (((b >> TETS[t][2]) & 1u) << 2) |
                        (((b >> TETS[t][3]) & 1u) << 3);
                    if (tc == 0u || tc == 15u) continue;
                    for (int k = 0; k < 2; ++k) {
                        const int* e = CASES[tc][k];
                        if (e[0] < 0) continue;
                        for (int j = 0; j < 3; ++j) {
                            const int la = TETS[t][EDGES[e[j]][0]];
                            const int lb = TETS[t][EDGES[e[j]][1]];
                            // f32 weight math, matching the numpy oracle
                            // bit-for-bit (its w chain stays float32)
                            const float va = vals[la], vb = vals[lb];
                            float denom = vb - va;
                            if (std::fabs(denom) < 1e-12f) denom = 1e-12f;
                            float w = (level - va) / denom;
                            if (w < 0.0f) w = 0.0f;
                            if (w > 1.0f) w = 1.0f;
                            int64_t ga = gids[la], gb = gids[lb];
                            if (ga > gb) {  // canonicalize direction
                                std::swap(ga, gb);
                                w = 1.0f - w;
                            }
                            out.corners.push_back({ga, gb,
                                                   static_cast<double>(w)});
                        }
                    }
                }
            }
        }
    }
}

}  // namespace

extern "C" {

// vol: (nx, ny, nz) C-contiguous f32. Returns an opaque Mesh* (never null;
// empty mesh if no surface).
void* mt_run(const float* vol, int64_t nx, int64_t ny, int64_t nz,
             float level) {
    const int64_t n = nx * ny * nz;
    std::vector<uint8_t> inside(static_cast<size_t>(n));
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < n; ++i) inside[i] = vol[i] >= level;

    // per-thread emission over x-slabs, merged in x order so the face
    // stream is deterministic regardless of thread count
    int nthreads = 1;
#ifdef _OPENMP
    nthreads = omp_get_max_threads();
#endif
    const int64_t cx = nx - 1;
    if (nthreads > cx && cx > 0) nthreads = static_cast<int>(cx);
    if (nthreads < 1) nthreads = 1;
    std::vector<EmitBuf> bufs(static_cast<size_t>(nthreads));
#ifdef _OPENMP
#pragma omp parallel num_threads(nthreads)
    {
        const int ti = omp_get_thread_num();
        const int64_t x0 = cx * ti / nthreads;
        const int64_t x1 = cx * (ti + 1) / nthreads;
        emit_slab(vol, inside.data(), nx, ny, nz, level, x0, x1, bufs[ti]);
    }
#else
    emit_slab(vol, inside.data(), nx, ny, nz, level, 0, cx, bufs[0]);
#endif

    // dedup corners by canonical edge key → vertex ids; first occurrence
    // wins (w is identical for every instance of an edge anyway). Open
    // addressing with linear probing: ~6 unique edges per vertex of a
    // 512³ surface mesh means tens of millions of lookups, and
    // std::unordered_map's per-node allocation + pointer chase measured
    // ~2.5× slower end-to-end on that path.
    size_t total = 0;
    for (auto& b : bufs) total += b.corners.size();
    auto* mesh = new Mesh();
    mesh->faces.reserve(total);
    struct Slot { int64_t key; int64_t vid; };  // one cache line pair
    size_t cap = 64;
    while (cap < total + 16) cap <<= 1;  // unique ≈ total/2 ⇒ load ≲ 0.5
    const size_t mask = cap - 1;
    // key 0 is impossible (lo < hi ⇒ key = lo*n + hi ≥ 1) ⇒ empty slot
    std::vector<Slot> slots(cap, Slot{0, 0});
    std::vector<TriCorner> uniq;
    uniq.reserve(total / 2 + 16);
    for (auto& b : bufs) {
        for (const auto& c : b.corners) {
            const int64_t key = c.lo * n + c.hi;  // lo < n ≤ 2^27 at 512³
            // Fibonacci hash of the key → starting slot
            size_t s = static_cast<size_t>(
                (static_cast<uint64_t>(key) * 11400714819323198485ull) >>
                1) & mask;
            int64_t vid;
            for (;;) {
                Slot& sl = slots[s];
                if (sl.key == 0) {
                    vid = static_cast<int64_t>(uniq.size());
                    sl.key = key;
                    sl.vid = vid;
                    uniq.push_back(c);
                    break;
                }
                if (sl.key == key) {
                    vid = sl.vid;
                    break;
                }
                s = (s + 1) & mask;
            }
            mesh->faces.push_back(vid);
        }
        b.corners.clear();
        b.corners.shrink_to_fit();
    }
    slots.clear(); slots.shrink_to_fit();

    // drop degenerate faces (repeated vertex ids), in place
    size_t nf = 0;
    for (size_t f = 0; f + 2 < mesh->faces.size(); f += 3) {
        const int64_t a = mesh->faces[f], bb = mesh->faces[f + 1],
                      cc = mesh->faces[f + 2];
        if (a != bb && bb != cc && a != cc) {
            mesh->faces[nf] = a;
            mesh->faces[nf + 1] = bb;
            mesh->faces[nf + 2] = cc;
            nf += 3;
        }
    }
    mesh->faces.resize(nf);

    // vertices in index coordinates: pa + w * (pb - pa), f64 math → f32
    mesh->verts.resize(uniq.size() * 3);
    const int64_t syz = ny * nz;
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int64_t i = 0; i < static_cast<int64_t>(uniq.size()); ++i) {
        const TriCorner& c = uniq[static_cast<size_t>(i)];
        const double pax = static_cast<double>(c.lo / syz);
        const double pay = static_cast<double>((c.lo % syz) / nz);
        const double paz = static_cast<double>(c.lo % nz);
        const double pbx = static_cast<double>(c.hi / syz);
        const double pby = static_cast<double>((c.hi % syz) / nz);
        const double pbz = static_cast<double>(c.hi % nz);
        mesh->verts[i * 3 + 0] = static_cast<float>(pax + c.w * (pbx - pax));
        mesh->verts[i * 3 + 1] = static_cast<float>(pay + c.w * (pby - pay));
        mesh->verts[i * 3 + 2] = static_cast<float>(paz + c.w * (pbz - paz));
    }
    return mesh;
}

int64_t mt_num_verts(void* h) {
    return static_cast<int64_t>(static_cast<Mesh*>(h)->verts.size() / 3);
}

int64_t mt_num_faces(void* h) {
    return static_cast<int64_t>(static_cast<Mesh*>(h)->faces.size() / 3);
}

void mt_copy(void* h, float* verts, int64_t* faces) {
    Mesh* m = static_cast<Mesh*>(h);
    if (!m->verts.empty())
        std::memcpy(verts, m->verts.data(), m->verts.size() * sizeof(float));
    if (!m->faces.empty())
        std::memcpy(faces, m->faces.data(),
                    m->faces.size() * sizeof(int64_t));
}

void mt_free(void* h) { delete static_cast<Mesh*>(h); }

}  // extern "C"
