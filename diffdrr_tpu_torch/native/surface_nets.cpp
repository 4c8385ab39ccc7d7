// Native Surface Nets mesher for CT volumes.
//
// Host-side native component of diffdrr_tpu_torch, the port's own copy of
// the JAX package's mesher (the reference delegates mesh extraction to
// vtk/pyvista, diffdrr/visualization.py:200-279; mesh extraction over 512^3
// volumes is far too slow in Python loops). Compiled on demand with g++ (see
// diffdrr_tpu_torch/native/build.py) and called through ctypes.
//
// Algorithm: naive Surface Nets — one vertex per cell that straddles the iso
// level (placed at the mean of the crossing-edge intersection points), one
// quad (two triangles) per volume edge crossing the level, connecting the
// four adjacent cells' vertices. Produces watertight quad-dominant meshes
// comparable to the reference's `flavor="surface_nets"` path.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Returns number of vertices; fills handles to malloc'd arrays the caller
// frees with sn_free. Data layout: volume[x*ny*nz + y*nz + z].
int64_t surface_nets(
    const float* vol, int64_t nx, int64_t ny, int64_t nz, float level,
    float** out_verts, int64_t* out_nverts,
    int64_t** out_faces, int64_t* out_nfaces) {
  const int64_t cx = nx - 1, cy = ny - 1, cz = nz - 1;
  if (cx <= 0 || cy <= 0 || cz <= 0) {
    *out_verts = nullptr; *out_nverts = 0;
    *out_faces = nullptr; *out_nfaces = 0;
    return 0;
  }
  auto vat = [&](int64_t x, int64_t y, int64_t z) -> float {
    return vol[(x * ny + y) * nz + z];
  };

  // Pass 1: find boundary cells, assign vertex ids, accumulate vertex
  // positions from edge crossings.
  std::vector<int64_t> cell_id((size_t)(cx * cy * cz), -1);
  std::vector<float> verts;
  verts.reserve(1 << 16);

  static const int corner[8][3] = {
      {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
      {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
  static const int edges[12][2] = {
      {0, 1}, {1, 2}, {2, 3}, {3, 0}, {4, 5}, {5, 6},
      {6, 7}, {7, 4}, {0, 4}, {1, 5}, {2, 6}, {3, 7}};

  int64_t nverts = 0;
  for (int64_t x = 0; x < cx; ++x) {
    for (int64_t y = 0; y < cy; ++y) {
      for (int64_t z = 0; z < cz; ++z) {
        float v[8];
        int inside = 0;
        for (int c = 0; c < 8; ++c) {
          v[c] = vat(x + corner[c][0], y + corner[c][1], z + corner[c][2]);
          if (v[c] > level) inside |= (1 << c);
        }
        if (inside == 0 || inside == 0xFF) continue;
        // Average of edge-crossing points (cell-local coords).
        float px = 0.f, py = 0.f, pz = 0.f;
        int ncross = 0;
        for (int e = 0; e < 12; ++e) {
          const int a = edges[e][0], b = edges[e][1];
          const bool ia = v[a] > level, ib = v[b] > level;
          if (ia == ib) continue;
          float t = (level - v[a]) / (v[b] - v[a]);
          px += corner[a][0] + t * (corner[b][0] - corner[a][0]);
          py += corner[a][1] + t * (corner[b][1] - corner[a][1]);
          pz += corner[a][2] + t * (corner[b][2] - corner[a][2]);
          ++ncross;
        }
        if (ncross == 0) continue;
        cell_id[(size_t)((x * cy + y) * cz + z)] = nverts++;
        verts.push_back((float)x + px / ncross);
        verts.push_back((float)y + py / ncross);
        verts.push_back((float)z + pz / ncross);
      }
    }
  }

  // Pass 2: for each volume edge along each axis that crosses the level,
  // emit a quad over the 4 cells sharing that edge.
  std::vector<int64_t> faces;
  faces.reserve(1 << 16);
  auto cid = [&](int64_t x, int64_t y, int64_t z) -> int64_t {
    if (x < 0 || y < 0 || z < 0 || x >= cx || y >= cy || z >= cz) return -1;
    return cell_id[(size_t)((x * cy + y) * cz + z)];
  };
  auto quad = [&](int64_t a, int64_t b, int64_t c, int64_t d, bool flip) {
    if (a < 0 || b < 0 || c < 0 || d < 0) return;
    if (flip) {
      faces.push_back(a); faces.push_back(d); faces.push_back(c);
      faces.push_back(a); faces.push_back(c); faces.push_back(b);
    } else {
      faces.push_back(a); faces.push_back(b); faces.push_back(c);
      faces.push_back(a); faces.push_back(c); faces.push_back(d);
    }
  };

  for (int64_t x = 0; x < nx; ++x) {
    for (int64_t y = 0; y < ny; ++y) {
      for (int64_t z = 0; z < nz; ++z) {
        const float v0 = vat(x, y, z);
        const bool i0 = v0 > level;
        // Edge along +x: shared by cells (x, y-1..y, z-1..z).
        if (x + 1 < nx && y > 0 && z > 0 && y < cy && z < cz) {
          const bool i1 = vat(x + 1, y, z) > level;
          if (i0 != i1)
            quad(cid(x, y - 1, z - 1), cid(x, y, z - 1), cid(x, y, z),
                 cid(x, y - 1, z), i0);
        }
        // Edge along +y.
        if (y + 1 < ny && x > 0 && z > 0 && x < cx && z < cz) {
          const bool i1 = vat(x, y + 1, z) > level;
          if (i0 != i1)
            quad(cid(x - 1, y, z - 1), cid(x - 1, y, z), cid(x, y, z),
                 cid(x, y, z - 1), i0);
        }
        // Edge along +z.
        if (z + 1 < nz && x > 0 && y > 0 && x < cx && y < cy) {
          const bool i1 = vat(x, y, z + 1) > level;
          if (i0 != i1)
            quad(cid(x - 1, y - 1, z), cid(x, y - 1, z), cid(x, y, z),
                 cid(x - 1, y, z), i0);
        }
      }
    }
  }

  *out_nverts = nverts;
  *out_verts = (float*)std::malloc(verts.size() * sizeof(float));
  std::memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  *out_nfaces = (int64_t)(faces.size() / 3);
  *out_faces = (int64_t*)std::malloc(faces.size() * sizeof(int64_t));
  std::memcpy(*out_faces, faces.data(), faces.size() * sizeof(int64_t));
  return nverts;
}

void sn_free(void* p) { std::free(p); }

// Taubin mesh smoothing (lambda/mu passes) operating in place on vertices.
void taubin_smooth(
    float* verts, int64_t nverts, const int64_t* faces, int64_t nfaces,
    int n_iter, float lam, float mu) {
  std::vector<std::vector<int64_t>> nbr((size_t)nverts);
  for (int64_t f = 0; f < nfaces; ++f) {
    const int64_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    nbr[(size_t)a].push_back(b); nbr[(size_t)a].push_back(c);
    nbr[(size_t)b].push_back(a); nbr[(size_t)b].push_back(c);
    nbr[(size_t)c].push_back(a); nbr[(size_t)c].push_back(b);
  }
  std::vector<float> delta((size_t)nverts * 3);
  for (int it = 0; it < 2 * n_iter; ++it) {
    const float w = (it % 2 == 0) ? lam : mu;
    for (int64_t i = 0; i < nverts; ++i) {
      const auto& nb = nbr[(size_t)i];
      if (nb.empty()) {
        delta[3 * i] = delta[3 * i + 1] = delta[3 * i + 2] = 0.f;
        continue;
      }
      float sx = 0.f, sy = 0.f, sz = 0.f;
      for (int64_t j : nb) {
        sx += verts[3 * j]; sy += verts[3 * j + 1]; sz += verts[3 * j + 2];
      }
      const float inv = 1.0f / (float)nb.size();
      delta[3 * i] = sx * inv - verts[3 * i];
      delta[3 * i + 1] = sy * inv - verts[3 * i + 1];
      delta[3 * i + 2] = sz * inv - verts[3 * i + 2];
    }
    for (int64_t i = 0; i < nverts * 3; ++i) verts[i] += w * delta[i];
  }
}

}  // extern "C"
