// Native marching-cubes mesher for CT volumes.
//
// Host-side native component of diffdrr_tpu_torch (the port's own copy)
// implementing the reference's `method="marching_cubes"` mesh extraction
// (reference: diffdrr/visualization.py:200-279, which delegates to vtk). The 256-case triangle table is generated constructively in Python
// (native/mc_tables.py) and passed in; this file only marches: classify each
// cell, emit table triangles with linearly interpolated edge vertices,
// dedupe vertices through a global-edge hash map. Compiled on demand with
// g++ (native/build.py) and called through ctypes.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
const int kEdge[12][2] = {
    {0, 1}, {1, 2}, {2, 3}, {3, 0}, {4, 5}, {5, 6},
    {6, 7}, {7, 4}, {0, 4}, {1, 5}, {2, 6}, {3, 7}};

}  // namespace

extern "C" {

// Returns number of vertices; fills handles to malloc'd arrays the caller
// frees with mc_free. Data layout: volume[x*ny*nz + y*nz + z]; tri_table is
// (256, stride) int8 of edge ids, -1 terminated per row.
int64_t marching_cubes(
    const float* vol, int64_t nx, int64_t ny, int64_t nz, float level,
    const int8_t* tri_table, int64_t stride,
    float** out_verts, int64_t* out_nverts,
    int64_t** out_faces, int64_t* out_nfaces) {
  const int64_t cx = nx - 1, cy = ny - 1, cz = nz - 1;
  *out_verts = nullptr; *out_nverts = 0;
  *out_faces = nullptr; *out_nfaces = 0;
  if (cx <= 0 || cy <= 0 || cz <= 0) return 0;
  auto vat = [&](int64_t x, int64_t y, int64_t z) -> float {
    return vol[(x * ny + y) * nz + z];
  };

  std::vector<float> verts;
  std::vector<int64_t> faces;
  verts.reserve(1 << 16);
  faces.reserve(1 << 16);
  // Global edge key -> vertex id. Key identifies the lattice edge by its
  // lower lattice point and axis (0:x, 1:y, 2:z).
  std::unordered_map<int64_t, int64_t> edge_vert;
  edge_vert.reserve(1 << 16);
  // Local edge id -> axis of the lattice edge it lies along.
  int edge_axis[12];
  for (int e = 0; e < 12; ++e) {
    const int a = kEdge[e][0], b = kEdge[e][1];
    for (int d = 0; d < 3; ++d)
      if (kCorner[a][d] != kCorner[b][d]) edge_axis[e] = d;
  }

  float v[8];
  for (int64_t x = 0; x < cx; ++x) {
    for (int64_t y = 0; y < cy; ++y) {
      for (int64_t z = 0; z < cz; ++z) {
        int caseid = 0;
        for (int c = 0; c < 8; ++c) {
          v[c] = vat(x + kCorner[c][0], y + kCorner[c][1], z + kCorner[c][2]);
          if (v[c] > level) caseid |= (1 << c);
        }
        if (caseid == 0 || caseid == 0xFF) continue;
        const int8_t* row = tri_table + (int64_t)caseid * stride;
        for (int64_t k = 0; k + 2 < stride && row[k] >= 0; k += 3) {
          int64_t tri[3];
          for (int t = 0; t < 3; ++t) {
            const int e = row[k + t];
            const int a = kEdge[e][0], b = kEdge[e][1];
            // Lower lattice point of this edge = min of the two corners.
            const int64_t ex = x + (kCorner[a][0] & kCorner[b][0]);
            const int64_t ey = y + (kCorner[a][1] & kCorner[b][1]);
            const int64_t ez = z + (kCorner[a][2] & kCorner[b][2]);
            const int64_t key = (((ex * ny + ey) * nz) + ez) * 3 + edge_axis[e];
            auto it = edge_vert.find(key);
            if (it != edge_vert.end()) {
              tri[t] = it->second;
              continue;
            }
            float tt = (level - v[a]) / (v[b] - v[a]);
            if (tt < 0.f) tt = 0.f;
            if (tt > 1.f) tt = 1.f;
            const int64_t id = (int64_t)(verts.size() / 3);
            verts.push_back((float)x + kCorner[a][0] +
                            tt * (kCorner[b][0] - kCorner[a][0]));
            verts.push_back((float)y + kCorner[a][1] +
                            tt * (kCorner[b][1] - kCorner[a][1]));
            verts.push_back((float)z + kCorner[a][2] +
                            tt * (kCorner[b][2] - kCorner[a][2]));
            edge_vert.emplace(key, id);
            tri[t] = id;
          }
          // Interpolation can collapse two edge vertices onto a shared
          // corner; skip the degenerate sliver.
          if (tri[0] == tri[1] || tri[1] == tri[2] || tri[0] == tri[2])
            continue;
          faces.push_back(tri[0]);
          faces.push_back(tri[1]);
          faces.push_back(tri[2]);
        }
      }
    }
  }

  *out_nverts = (int64_t)(verts.size() / 3);
  *out_verts = (float*)std::malloc(verts.size() * sizeof(float));
  std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  *out_nfaces = (int64_t)(faces.size() / 3);
  *out_faces = (int64_t*)std::malloc(faces.size() * sizeof(int64_t));
  std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int64_t));
  return *out_nverts;
}

void mc_free(void* p) { std::free(p); }

}  // extern "C"
