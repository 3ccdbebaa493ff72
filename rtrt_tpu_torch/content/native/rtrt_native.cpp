// rtrt_native: host-side content pipeline, C++ twin of rtrt_tpu/content/*.
//
// Native counterparts of the reference's host C++ content components
// (SURVEY.md §2.6 ⚙): Perlin noise (reference: src/perlin.h), voxel terrain
// (src/terrain.cpp), isosurface meshing (src/marchingCubes.cpp — here
// marching tetrahedra, see content/marching.py for the design rationale),
// vertex welding (VertexMerger), smooth normals (src/kernel.cu:228-257),
// OBJ import (src/fileUtils.cu via assimp), and Loop subdivision on a
// half-edge structure (src/mesh.cpp / src/meshedit.cpp).
//
// Exposed as a plain C ABI consumed via ctypes (content/native.py); all
// output buffers are allocated here and released with rtrt_free.
//
// Build: make -C rtrt_tpu/native   ->  librtrt_native.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <map>
#include <random>
#include <unordered_map>
#include <vector>

extern "C" {

void rtrt_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Perlin noise (classic improved Perlin, seeded permutation)
// ---------------------------------------------------------------------------

struct Perlin {
  int perm[512];
  explicit Perlin(uint32_t seed) {
    int p[256];
    for (int i = 0; i < 256; ++i) p[i] = i;
    std::mt19937 rng(seed);
    for (int i = 255; i > 0; --i) {
      std::uniform_int_distribution<int> d(0, i);
      std::swap(p[i], p[d(rng)]);
    }
    for (int i = 0; i < 512; ++i) perm[i] = p[i & 255];
  }
  static double fade(double t) { return t * t * t * (t * (t * 6 - 15) + 10); }
  static double grad(int h, double x, double y, double z) {
    h &= 15;
    double u = h < 8 ? x : y;
    double v = h < 4 ? y : (h == 12 || h == 14 ? x : z);
    return ((h & 1) ? -u : u) + ((h & 2) ? -v : v);
  }
  double noise(double x, double y, double z) const {
    int xi = (int)floor(x) & 255, yi = (int)floor(y) & 255,
        zi = (int)floor(z) & 255;
    double xf = x - floor(x), yf = y - floor(y), zf = z - floor(z);
    double u = fade(xf), v = fade(yf), w = fade(zf);
    auto h = [&](int a, int b, int c) {
      return perm[perm[perm[a & 255] + (b & 255)] + (c & 255)];
    };
    auto lerp = [](double a, double b, double t) { return a + t * (b - a); };
    double x00 = lerp(grad(h(xi, yi, zi), xf, yf, zf),
                      grad(h(xi + 1, yi, zi), xf - 1, yf, zf), u);
    double x10 = lerp(grad(h(xi, yi + 1, zi), xf, yf - 1, zf),
                      grad(h(xi + 1, yi + 1, zi), xf - 1, yf - 1, zf), u);
    double x01 = lerp(grad(h(xi, yi, zi + 1), xf, yf, zf - 1),
                      grad(h(xi + 1, yi, zi + 1), xf - 1, yf, zf - 1), u);
    double x11 = lerp(grad(h(xi, yi + 1, zi + 1), xf, yf - 1, zf - 1),
                      grad(h(xi + 1, yi + 1, zi + 1), xf - 1, yf - 1, zf - 1),
                      u);
    return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w);
  }
  double fbm(double x, double y, double z, int octaves, double lac,
             double gain) const {
    double total = 0, amp = 1, freq = 1, norm = 0;
    for (int i = 0; i < octaves; ++i) {
      total += amp * noise(x * freq, y * freq, z * freq);
      norm += amp;
      amp *= gain;
      freq *= lac;
    }
    return total / norm;
  }
};

// Batch fbm evaluation: out[i] = fbm(p[3i], p[3i+1], p[3i+2])
void rtrt_perlin_fbm3(const double* pts, int64_t n, uint32_t seed,
                      int octaves, double lacunarity, double gain,
                      float* out) {
  Perlin p(seed);
  for (int64_t i = 0; i < n; ++i)
    out[i] = (float)p.fbm(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], octaves,
                          lacunarity, gain);
}

// ---------------------------------------------------------------------------
// Terrain density field (corner lattice), matching content/terrain.py
// ---------------------------------------------------------------------------

void rtrt_terrain_density(int nx, int ny, int nz, double ox, double oy,
                          double oz, uint32_t seed, double height_scale,
                          float* out /* (nx+1)*(ny+1)*(nz+1) */) {
  Perlin p(seed);
  int64_t k = 0;
  for (int x = 0; x <= nx; ++x)
    for (int y = 0; y <= ny; ++y)
      for (int z = 0; z <= nz; ++z) {
        double wx = ox + x, wy = oy + y, wz = oz + z;
        double h = p.fbm(wx * 0.05, 0.0, wz * 0.05, 4, 2.0, 0.5) * height_scale;
        out[k++] = (float)(h - wy);
      }
}

// ---------------------------------------------------------------------------
// Marching tetrahedra (same 6-tet decomposition as content/marching.py)
// ---------------------------------------------------------------------------

static const int TETS[6][4] = {{0, 1, 3, 7}, {0, 1, 5, 7}, {0, 2, 3, 7},
                               {0, 2, 6, 7}, {0, 4, 5, 7}, {0, 4, 6, 7}};

struct V3 {
  float x, y, z;
};
static V3 v3(float x, float y, float z) { return {x, y, z}; }
static V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static V3 crossv(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static float dotv(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

static V3 interp(V3 pa, V3 pb, float da, float db) {
  float t = da / (da - db);
  return add(pa, mul(sub(pb, pa), t));
}

// Extract the 0-isosurface; density is (nx+1, ny+1, nz+1) row-major
// (x-major like rtrt_terrain_density).  Returns triangle soup.
void rtrt_march_tetrahedra(const float* density, int nx, int ny, int nz,
                           double ox, double oy, double oz, double scale,
                           float** out_tris, int64_t* out_ntris) {
  auto d = [&](int x, int y, int z) {
    return density[((int64_t)x * (ny + 1) + y) * (nz + 1) + z];
  };
  std::vector<float> tris;
  tris.reserve(1 << 20);
  auto emit = [&](V3 a, V3 b, V3 c, V3 inside) {
    V3 n = crossv(sub(b, a), sub(c, a));
    if (dotv(n, sub(inside, a)) > 0) std::swap(b, c);  // outward CCW
    for (V3 v : {a, b, c}) {
      tris.push_back(v.x);
      tris.push_back(v.y);
      tris.push_back(v.z);
    }
  };
  for (int x = 0; x < nx; ++x)
    for (int y = 0; y < ny; ++y)
      for (int z = 0; z < nz; ++z) {
        float cd[8];
        V3 cp[8];
        bool all_in = true, all_out = true;
        for (int i = 0; i < 8; ++i) {
          int cx = x + (i & 1), cy = y + ((i >> 1) & 1), cz = z + ((i >> 2) & 1);
          cd[i] = d(cx, cy, cz);
          cp[i] = v3((float)(ox + cx * scale), (float)(oy + cy * scale),
                     (float)(oz + cz * scale));
          (cd[i] > 0 ? all_out : all_in) = false;
        }
        if (all_in || all_out) continue;
        for (auto& tet : TETS) {
          float td[4];
          V3 tp[4];
          int inside = 0;
          for (int i = 0; i < 4; ++i) {
            td[i] = cd[tet[i]];
            tp[i] = cp[tet[i]];
            if (td[i] > 0) inside++;
          }
          if (inside == 0 || inside == 4) continue;
          int a[4], na = 0, b[4], nb = 0;  // inside / outside corner ids
          for (int i = 0; i < 4; ++i) (td[i] > 0 ? a[na++] : b[nb++]) = i;
          if (inside == 1 || inside == 3) {
            bool lone_in = inside == 1;
            int lone = lone_in ? a[0] : b[0];
            int* oth = lone_in ? b : a;
            V3 p0 = interp(tp[lone], tp[oth[0]], td[lone], td[oth[0]]);
            V3 p1 = interp(tp[lone], tp[oth[1]], td[lone], td[oth[1]]);
            V3 p2 = interp(tp[lone], tp[oth[2]], td[lone], td[oth[2]]);
            V3 ip = lone_in ? tp[lone]
                            : mul(add(add(tp[oth[0]], tp[oth[1]]), tp[oth[2]]),
                                  1.0f / 3.0f);
            emit(p0, p1, p2, ip);
          } else {  // 2-2: quad
            V3 p00 = interp(tp[a[0]], tp[b[0]], td[a[0]], td[b[0]]);
            V3 p01 = interp(tp[a[0]], tp[b[1]], td[a[0]], td[b[1]]);
            V3 p10 = interp(tp[a[1]], tp[b[0]], td[a[1]], td[b[0]]);
            V3 p11 = interp(tp[a[1]], tp[b[1]], td[a[1]], td[b[1]]);
            V3 ip = mul(add(tp[a[0]], tp[a[1]]), 0.5f);
            emit(p00, p01, p11, ip);
            emit(p00, p11, p10, ip);
          }
        }
      }
  *out_ntris = (int64_t)tris.size() / 9;
  *out_tris = (float*)malloc(tris.size() * sizeof(float));
  memcpy(*out_tris, tris.data(), tris.size() * sizeof(float));
}

// ---------------------------------------------------------------------------
// Vertex welding (quantized hash dedup, reference VertexMerger analog)
// ---------------------------------------------------------------------------

void rtrt_weld(const float* soup /* ntris*9 */, int64_t ntris, double tol,
               float** out_verts, int64_t* out_nverts, int32_t** out_indices,
               int64_t* out_ntris) {
  struct Key {
    int64_t x, y, z;
    bool operator==(const Key& o) const {
      return x == o.x && y == o.y && z == o.z;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return (size_t)(k.x * 73856093LL ^ k.y * 19349663LL ^ k.z * 83492791LL);
    }
  };
  std::unordered_map<Key, int32_t, KeyHash> map;
  std::vector<float> verts;
  std::vector<int32_t> idx;
  verts.reserve(ntris * 3);
  idx.reserve(ntris * 3);
  for (int64_t i = 0; i < ntris * 3; ++i) {
    const float* p = soup + 3 * i;
    Key k{(int64_t)llround(p[0] / tol), (int64_t)llround(p[1] / tol),
          (int64_t)llround(p[2] / tol)};
    auto it = map.find(k);
    int32_t vi;
    if (it == map.end()) {
      vi = (int32_t)(verts.size() / 3);
      map.emplace(k, vi);
      verts.insert(verts.end(), {p[0], p[1], p[2]});
    } else {
      vi = it->second;
    }
    idx.push_back(vi);
  }
  // drop degenerate triangles
  std::vector<int32_t> good;
  good.reserve(idx.size());
  for (size_t i = 0; i + 2 < idx.size(); i += 3) {
    int32_t a = idx[i], b = idx[i + 1], c = idx[i + 2];
    if (a != b && b != c && a != c) good.insert(good.end(), {a, b, c});
  }
  *out_nverts = (int64_t)(verts.size() / 3);
  *out_verts = (float*)malloc(verts.size() * sizeof(float));
  memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  *out_ntris = (int64_t)(good.size() / 3);
  *out_indices = (int32_t*)malloc(good.size() * sizeof(int32_t));
  memcpy(*out_indices, good.data(), good.size() * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// Smooth vertex normals (area-weighted)
// ---------------------------------------------------------------------------

void rtrt_smooth_normals(const float* verts, int64_t nverts,
                         const int32_t* indices, int64_t ntris, float* out) {
  memset(out, 0, nverts * 3 * sizeof(float));
  for (int64_t t = 0; t < ntris; ++t) {
    const int32_t* f = indices + 3 * t;
    V3 a = {verts[3 * f[0]], verts[3 * f[0] + 1], verts[3 * f[0] + 2]};
    V3 b = {verts[3 * f[1]], verts[3 * f[1] + 1], verts[3 * f[1] + 2]};
    V3 c = {verts[3 * f[2]], verts[3 * f[2] + 1], verts[3 * f[2] + 2]};
    V3 n = crossv(sub(b, a), sub(c, a));  // area-weighted
    for (int k = 0; k < 3; ++k) {
      out[3 * f[k]] += n.x;
      out[3 * f[k] + 1] += n.y;
      out[3 * f[k] + 2] += n.z;
    }
  }
  for (int64_t v = 0; v < nverts; ++v) {
    float* n = out + 3 * v;
    float l = sqrtf(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (l > 1e-12f) {
      n[0] /= l;
      n[1] /= l;
      n[2] /= l;
    }
  }
}

// ---------------------------------------------------------------------------
// OBJ import (v + f triangulated; assimp-free)
// ---------------------------------------------------------------------------

int rtrt_load_obj(const char* path, float** out_verts, int64_t* out_nverts,
                  int32_t** out_indices, int64_t* out_ntris) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  std::vector<float> verts;
  std::vector<int32_t> idx;
  char line[4096];
  while (fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3)
        verts.insert(verts.end(), {x, y, z});
    } else if (line[0] == 'f' && line[1] == ' ') {
      std::vector<int32_t> face;
      char* tok = strtok(line + 2, " \t\r\n");
      while (tok) {
        long i = strtol(tok, nullptr, 10);
        face.push_back(i > 0 ? (int32_t)(i - 1)
                             : (int32_t)(verts.size() / 3 + i));
        tok = strtok(nullptr, " \t\r\n");
      }
      for (size_t k = 1; k + 1 < face.size(); ++k)
        idx.insert(idx.end(), {face[0], face[k], face[k + 1]});
    }
  }
  fclose(f);
  *out_nverts = (int64_t)(verts.size() / 3);
  *out_verts = (float*)malloc(verts.size() * sizeof(float));
  memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  *out_ntris = (int64_t)(idx.size() / 3);
  *out_indices = (int32_t*)malloc(idx.size() * sizeof(int32_t));
  memcpy(*out_indices, idx.data(), idx.size() * sizeof(int32_t));
  return 0;
}

// ---------------------------------------------------------------------------
// Loop subdivision on an indexed triangle mesh (half-edge adjacency built
// internally) — the native mesh-edit op (reference: src/meshedit.cpp:410)
// ---------------------------------------------------------------------------

void rtrt_subdivide_loop(const float* verts, int64_t nverts,
                         const int32_t* indices, int64_t ntris, int levels,
                         float** out_verts, int64_t* out_nverts,
                         int32_t** out_indices, int64_t* out_ntris) {
  std::vector<V3> v(nverts);
  for (int64_t i = 0; i < nverts; ++i)
    v[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  std::vector<int32_t> f(indices, indices + ntris * 3);

  for (int lvl = 0; lvl < levels; ++lvl) {
    int64_t nv = (int64_t)v.size();
    int64_t nt = (int64_t)f.size() / 3;
    // edge -> (new vertex id, opposite vertices accumulated)
    std::map<std::pair<int32_t, int32_t>, int32_t> edge_vert;
    std::map<std::pair<int32_t, int32_t>, std::vector<int32_t>> edge_opp;
    std::vector<std::vector<int32_t>> ring(nv);
    auto ekey = [](int32_t a, int32_t b) {
      return std::make_pair(std::min(a, b), std::max(a, b));
    };
    for (int64_t t = 0; t < nt; ++t)
      for (int e = 0; e < 3; ++e) {
        int32_t a = f[3 * t + e], b = f[3 * t + (e + 1) % 3],
                c = f[3 * t + (e + 2) % 3];
        edge_opp[ekey(a, b)].push_back(c);
        ring[a].push_back(b);
        ring[b].push_back(a);
      }
    // dedup rings
    for (auto& r : ring) {
      std::sort(r.begin(), r.end());
      r.erase(std::unique(r.begin(), r.end()), r.end());
    }
    std::vector<V3> nvrt = v;
    // reposition old vertices (Loop beta rule; boundary: midpoint rule)
    for (int64_t i = 0; i < nv; ++i) {
      int n = (int)ring[i].size();
      if (n < 3) continue;
      double beta = n == 3 ? 3.0 / 16.0 : 3.0 / (8.0 * n);
      V3 s = {0, 0, 0};
      for (int32_t j : ring[i]) s = add(s, v[j]);
      nvrt[i] = add(mul(v[i], (float)(1.0 - n * beta)), mul(s, (float)beta));
    }
    // edge vertices
    for (auto& kv : edge_opp) {
      int32_t a = kv.first.first, b = kv.first.second;
      V3 p;
      if (kv.second.size() >= 2) {
        p = add(mul(add(v[a], v[b]), 3.0f / 8.0f),
                mul(add(v[kv.second[0]], v[kv.second[1]]), 1.0f / 8.0f));
      } else {
        p = mul(add(v[a], v[b]), 0.5f);  // boundary edge
      }
      edge_vert[kv.first] = (int32_t)nvrt.size();
      nvrt.push_back(p);
    }
    // 1:4 topology split
    std::vector<int32_t> nf;
    nf.reserve(nt * 12);
    for (int64_t t = 0; t < nt; ++t) {
      int32_t a = f[3 * t], b = f[3 * t + 1], c = f[3 * t + 2];
      int32_t ab = edge_vert[ekey(a, b)], bc = edge_vert[ekey(b, c)],
              ca = edge_vert[ekey(c, a)];
      int32_t quads[4][3] = {
          {a, ab, ca}, {ab, b, bc}, {ca, bc, c}, {ab, bc, ca}};
      for (auto& q : quads) nf.insert(nf.end(), {q[0], q[1], q[2]});
    }
    v = std::move(nvrt);
    f = std::move(nf);
  }

  *out_nverts = (int64_t)v.size();
  *out_verts = (float*)malloc(v.size() * 3 * sizeof(float));
  memcpy(*out_verts, v.data(), v.size() * 3 * sizeof(float));
  *out_ntris = (int64_t)(f.size() / 3);
  *out_indices = (int32_t*)malloc(f.size() * sizeof(int32_t));
  memcpy(*out_indices, f.data(), f.size() * sizeof(int32_t));
}

// ---------------------------------------------------------------------------
// 63-bit morton sort of triangles (the offline mesh baker,
// reference: tool/meshProcessor.cpp:36-64)
// ---------------------------------------------------------------------------

static uint64_t expand63(uint64_t x) {
  x &= 0x1FFFFF;
  x = (x | (x << 32)) & 0x1F00000000FFFFULL;
  x = (x | (x << 16)) & 0x1F0000FF0000FFULL;
  x = (x | (x << 8)) & 0x100F00F00F00F00FULL;
  x = (x | (x << 4)) & 0x10C30C30C30C30C3ULL;
  x = (x | (x << 2)) & 0x1249249249249249ULL;
  return x;
}

// Reorders soup (ntris*9 floats) in place by centroid morton code.
void rtrt_morton_sort_tris(float* soup, int64_t ntris) {
  float lo[3] = {1e30f, 1e30f, 1e30f}, hi[3] = {-1e30f, -1e30f, -1e30f};
  for (int64_t i = 0; i < ntris * 3; ++i)
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], soup[3 * i + k]);
      hi[k] = std::max(hi[k], soup[3 * i + k]);
    }
  std::vector<std::pair<uint64_t, int64_t>> keys(ntris);
  for (int64_t t = 0; t < ntris; ++t) {
    double c[3] = {0, 0, 0};
    for (int i = 0; i < 3; ++i)
      for (int k = 0; k < 3; ++k) c[k] += soup[9 * t + 3 * i + k] / 3.0;
    uint64_t m = 0;
    for (int k = 0; k < 3; ++k) {
      double ext = std::max(1e-12, (double)hi[k] - lo[k]);
      uint64_t q = (uint64_t)std::min(
          2097151.0, std::max(0.0, (c[k] - lo[k]) / ext * 2097151.0));
      m |= expand63(q) << (2 - k);
    }
    keys[t] = {m, t};
  }
  std::sort(keys.begin(), keys.end());
  std::vector<float> tmp(ntris * 9);
  for (int64_t t = 0; t < ntris; ++t)
    memcpy(&tmp[9 * t], &soup[9 * keys[t].second], 9 * sizeof(float));
  memcpy(soup, tmp.data(), tmp.size() * sizeof(float));
}

// ---------------------------------------------------------------------------
// Binned-SAH BVH builder (init-time, static scenes)
//
// The per-frame path keeps the LBVH (bvh/build.py — the analog of the
// reference's every-frame rebuild, src/bvh.cu:7-97); static scenes can
// afford a far better tree ONCE at init.  A binned SAH build (Wald 2007)
// yields ~1.5-2x fewer node visits per ray than morton LBVH, which
// directly divides the packet kernel's per-tile step unions.
//
// Output is a FLAT binary tree in the packet-kernel's node-record layout:
//   boxes:    m*12 floats  [Llo(3) Lhi(3) Rlo(3) Rhi(3)] per internal node
//   children: m*2  int32   pre-packed stack entries (bvh/types.py):
//               internal -> node id in bits 0..21 (idx | batch<<11)
//               leaf     -> LEAF_BIT | slot%1024 | (slot/1024)<<11
//                           (decodes to tri base = slot, GROUP=1)
//   perm:     n int32      sorted leaf slot -> input triangle index
// Root = node 0; m = n-1 (singleton leaves).
// ---------------------------------------------------------------------------

namespace {

struct SahBuilder {
  static constexpr int kBins = 16;
  const float* tris;  // n*9
  std::vector<float> tb;       // n*6 triangle AABBs
  std::vector<float> tc;       // n*3 centroids
  std::vector<int32_t> order;  // permuted in place during the build
  std::vector<float> boxes;    // m*12
  std::vector<int32_t> children;  // m*2

  void tri_bounds(int64_t t, float* lo, float* hi) const {
    for (int k = 0; k < 3; ++k) {
      float a = tris[9 * t + k], b = tris[9 * t + 3 + k],
            c = tris[9 * t + 6 + k];
      lo[k] = std::min(a, std::min(b, c));
      hi[k] = std::max(a, std::max(b, c));
    }
  }

  void range_bounds(int64_t lo, int64_t hi, float* blo, float* bhi) const {
    for (int k = 0; k < 3; ++k) { blo[k] = 1e30f; bhi[k] = -1e30f; }
    for (int64_t i = lo; i < hi; ++i) {
      const float* b = &tb[6 * order[i]];
      for (int k = 0; k < 3; ++k) {
        blo[k] = std::min(blo[k], b[k]);
        bhi[k] = std::max(bhi[k], b[3 + k]);
      }
    }
  }

  static double area(const float* lo, const float* hi) {
    double dx = std::max(0.f, hi[0] - lo[0]);
    double dy = std::max(0.f, hi[1] - lo[1]);
    double dz = std::max(0.f, hi[2] - lo[2]);
    return dx * dy + dy * dz + dz * dx;
  }

  // Builds [lo, hi); returns the packed child entry and fills bb (6 floats).
  int32_t build(int64_t lo, int64_t hi, float* bb, int depth = 0) {
    if (hi - lo == 1) {
      int64_t slot = lo;  // ranges are position-stable: final slot == lo
      memcpy(bb, &tb[6 * order[lo]], 6 * sizeof(float));
      return (int32_t)((1 << 23) | ((slot / 1024) << 11) | (slot % 1024));
    }
    // centroid bounds pick the split axis
    float clo[3] = {1e30f, 1e30f, 1e30f}, chi[3] = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = lo; i < hi; ++i) {
      const float* c = &tc[3 * order[i]];
      for (int k = 0; k < 3; ++k) {
        clo[k] = std::min(clo[k], c[k]);
        chi[k] = std::max(chi[k], c[k]);
      }
    }
    int axis = 0;
    float ext = chi[0] - clo[0];
    for (int k = 1; k < 3; ++k)
      if (chi[k] - clo[k] > ext) { ext = chi[k] - clo[k]; axis = k; }

    int64_t mid = -1;
    // lopsided SAH chains can recurse O(n) deep — force median past 64
    if (ext > 1e-12f && depth < 64) {
      // binned SAH sweep on the widest centroid axis
      float blo_[kBins][3], bhi_[kBins][3];
      int64_t cnt[kBins] = {0};
      for (int b = 0; b < kBins; ++b)
        for (int k = 0; k < 3; ++k) { blo_[b][k] = 1e30f; bhi_[b][k] = -1e30f; }
      float scale = kBins / ext;
      auto bin_of = [&](int32_t t) {
        int b = (int)((tc[3 * t + axis] - clo[axis]) * scale);
        return std::min(kBins - 1, std::max(0, b));
      };
      for (int64_t i = lo; i < hi; ++i) {
        int32_t t = order[i];
        int b = bin_of(t);
        ++cnt[b];
        for (int k = 0; k < 3; ++k) {
          blo_[b][k] = std::min(blo_[b][k], tb[6 * t + k]);
          bhi_[b][k] = std::max(bhi_[b][k], tb[6 * t + 3 + k]);
        }
      }
      // suffix bounds/counts, then prefix sweep for min cost
      double rarea[kBins + 1];
      int64_t rcnt[kBins + 1];
      float rlo[3] = {1e30f, 1e30f, 1e30f}, rhi[3] = {-1e30f, -1e30f, -1e30f};
      rarea[kBins] = 0; rcnt[kBins] = 0;
      for (int b = kBins - 1; b >= 0; --b) {
        for (int k = 0; k < 3; ++k) {
          rlo[k] = std::min(rlo[k], blo_[b][k]);
          rhi[k] = std::max(rhi[k], bhi_[b][k]);
        }
        rarea[b] = area(rlo, rhi);
        rcnt[b] = rcnt[b + 1] + cnt[b];
      }
      double best = 1e300;
      int best_b = -1;
      float llo[3] = {1e30f, 1e30f, 1e30f}, lhi[3] = {-1e30f, -1e30f, -1e30f};
      int64_t lcnt = 0;
      for (int b = 0; b < kBins - 1; ++b) {
        for (int k = 0; k < 3; ++k) {
          llo[k] = std::min(llo[k], blo_[b][k]);
          lhi[k] = std::max(lhi[k], bhi_[b][k]);
        }
        lcnt += cnt[b];
        if (lcnt == 0 || rcnt[b + 1] == 0) continue;
        double cost = area(llo, lhi) * lcnt + rarea[b + 1] * rcnt[b + 1];
        if (cost < best) { best = cost; best_b = b; }
      }
      if (best_b >= 0) {
        int32_t* first = &order[lo];
        int32_t* last = &order[hi];
        int32_t* p = std::partition(first, last, [&](int32_t t) {
          return bin_of(t) <= best_b;
        });
        mid = lo + (p - first);
      }
    }
    if (mid <= lo || mid >= hi) {
      // degenerate centroids or empty side: median split on the axis
      mid = (lo + hi) / 2;
      std::nth_element(&order[lo], &order[mid], &order[hi],
                       [&](int32_t a, int32_t b) {
                         return tc[3 * a + axis] < tc[3 * b + axis];
                       });
    }
    int32_t id = (int32_t)(boxes.size() / 12);
    boxes.resize(boxes.size() + 12);
    children.resize(children.size() + 2);
    float lbb[6], rbb[6];
    int32_t le = build(lo, mid, lbb, depth + 1);
    int32_t re = build(mid, hi, rbb, depth + 1);
    memcpy(&boxes[12 * id], lbb, 3 * sizeof(float));       // Llo
    memcpy(&boxes[12 * id + 3], lbb + 3, 3 * sizeof(float));  // Lhi
    memcpy(&boxes[12 * id + 6], rbb, 3 * sizeof(float));   // Rlo
    memcpy(&boxes[12 * id + 9], rbb + 3, 3 * sizeof(float));  // Rhi
    children[2 * id] = le;
    children[2 * id + 1] = re;
    for (int k = 0; k < 3; ++k) {
      bb[k] = std::min(lbb[k], rbb[k]);
      bb[3 + k] = std::max(lbb[3 + k], rbb[3 + k]);
    }
    return id;  // internal entry: node id in bits 0..21, no flags
  }
};

}  // namespace

void rtrt_build_sah(const float* tris /* n*9 */, int64_t n,
                    float** out_boxes, int32_t** out_children,
                    int32_t** out_perm, int64_t* out_m) {
  SahBuilder b;
  b.tris = tris;
  b.tb.resize(n * 6);
  b.tc.resize(n * 3);
  for (int64_t t = 0; t < n; ++t) {
    b.tri_bounds(t, &b.tb[6 * t], &b.tb[6 * t + 3]);
    for (int k = 0; k < 3; ++k)
      b.tc[3 * t + k] = 0.5f * (b.tb[6 * t + k] + b.tb[6 * t + 3 + k]);
  }
  b.order.resize(n);
  for (int64_t i = 0; i < n; ++i) b.order[i] = (int32_t)i;
  b.boxes.reserve((n - 1) * 12);
  b.children.reserve((n - 1) * 2);
  float bb[6];
  b.build(0, n, bb);
  int64_t m = (int64_t)(b.boxes.size() / 12);
  *out_boxes = (float*)malloc(m * 12 * sizeof(float));
  *out_children = (int32_t*)malloc(m * 2 * sizeof(int32_t));
  *out_perm = (int32_t*)malloc(n * sizeof(int32_t));
  memcpy(*out_boxes, b.boxes.data(), m * 12 * sizeof(float));
  memcpy(*out_children, b.children.data(), m * 2 * sizeof(int32_t));
  memcpy(*out_perm, b.order.data(), n * sizeof(int32_t));
  *out_m = m;
}

// ---------------------------------------------------------------------------
// 4-wide collapse of the binary SAH tree (Wald 2008-style greedy collapse)
//
// Each 4-wide node starts as a binary node's two children and repeatedly
// inlines the largest-surface-area INTERNAL child's own children until it
// holds 4.  Halves the tile-step count of the packet traversal (one fetch
// serves two binary levels; the stride-32 record costs the same dynamic
// sublane read + lane rotate as the stride-16 one).
//
// Output record layout (8 f32-quadruples = 32 lanes, 4 records per
// 128-lane table row):
//   [24 child-AABB floats (4x lo(3)+hi(3)) | 4 child entries | 4 pad]
// Empty slots carry an inverted box (+inf lo / -inf hi: no slab hit) and
// entry -1.  Entries otherwise as rtrt_build_sah (internal = 4-wide node
// id in bits 0..21, leaf = LEAF_BIT | slot fields).
// ---------------------------------------------------------------------------

namespace {

struct Collapse4 {
  const std::vector<float>* bboxes;      // binary boxes (m*12)
  const std::vector<int32_t>* bchildren; // binary children (m*2)
  std::vector<float> nodes;              // out: q*32

  struct Cand {
    int32_t entry;
    float bb[6];
  };

  static double area6(const float* bb) {
    double dx = std::max(0.f, bb[3] - bb[0]);
    double dy = std::max(0.f, bb[4] - bb[1]);
    double dz = std::max(0.f, bb[5] - bb[2]);
    return dx * dy + dy * dz + dz * dx;
  }

  int32_t collapse(int32_t bin_id) {
    const std::vector<float>& bx = *bboxes;
    const std::vector<int32_t>& ch = *bchildren;
    Cand cs[4];
    int nc = 0;
    for (int side = 0; side < 2; ++side) {
      cs[nc].entry = ch[2 * bin_id + side];
      memcpy(cs[nc].bb, &bx[12 * bin_id + 6 * side], 6 * sizeof(float));
      ++nc;
    }
    while (nc < 4) {
      int pick = -1;
      double best = -1;
      for (int i = 0; i < nc; ++i) {
        if (cs[i].entry & (1 << 23)) continue;  // leaf
        double a = area6(cs[i].bb);
        if (a > best) { best = a; pick = i; }
      }
      if (pick < 0) break;
      int32_t inner = cs[pick].entry & 0x3FFFFF;
      // replace picked with its left child; append right child
      cs[pick].entry = ch[2 * inner];
      memcpy(cs[pick].bb, &bx[12 * inner], 6 * sizeof(float));
      cs[nc].entry = ch[2 * inner + 1];
      memcpy(cs[nc].bb, &bx[12 * inner + 6], 6 * sizeof(float));
      ++nc;
    }
    int32_t id = (int32_t)(nodes.size() / 32);
    nodes.resize(nodes.size() + 32);
    // recursion below grows `nodes` (invalidating pointers into it), so
    // assemble the record locally and copy it in afterwards
    float rec[32] = {0};
    for (int i = 0; i < 4; ++i) {
      float* bbout = rec + 6 * i;
      int32_t e;
      if (i < nc) {
        memcpy(bbout, cs[i].bb, 6 * sizeof(float));
        e = (cs[i].entry & (1 << 23)) ? cs[i].entry
                                      : collapse(cs[i].entry & 0x3FFFFF);
      } else {
        bbout[0] = bbout[1] = bbout[2] = 1e30f;
        bbout[3] = bbout[4] = bbout[5] = -1e30f;
        e = -1;
      }
      // entries ride as exact f32 values (< 2^24), like the binary tables
      rec[24 + i] = (float)e;
    }
    memcpy(&nodes[32 * id], rec, 32 * sizeof(float));
    return id;
  }
};

}  // namespace

// Collapse an EXISTING binary tree (boxes m*12, children m*2, root 0) into
// 4-wide records — used by the python side so the binary tree (consumed by
// the wavefront oracle) and the 4-wide packet tables share one build.
void rtrt_collapse4(const float* boxes, const int32_t* children, int64_t m,
                    float** out_nodes /* q*32 */, int64_t* out_q) {
  Collapse4 c;
  std::vector<float> bv(boxes, boxes + m * 12);
  std::vector<int32_t> cv(children, children + m * 2);
  c.bboxes = &bv;
  c.bchildren = &cv;
  c.nodes.reserve(m * 32 / 2);
  c.collapse(0);
  int64_t q = (int64_t)(c.nodes.size() / 32);
  *out_nodes = (float*)malloc(q * 32 * sizeof(float));
  memcpy(*out_nodes, c.nodes.data(), q * 32 * sizeof(float));
  *out_q = q;
}

void rtrt_build_sah4(const float* tris /* n*9 */, int64_t n,
                     float** out_nodes /* q*32 */, int32_t** out_perm,
                     int64_t* out_q) {
  float* bboxes;
  int32_t* bchildren;
  int32_t* perm;
  int64_t m;
  rtrt_build_sah(tris, n, &bboxes, &bchildren, &perm, &m);
  Collapse4 c;
  std::vector<float> bv(bboxes, bboxes + m * 12);
  std::vector<int32_t> cv(bchildren, bchildren + m * 2);
  c.bboxes = &bv;
  c.bchildren = &cv;
  c.nodes.reserve(m * 32 / 2);
  c.collapse(0);
  free(bboxes);
  free(bchildren);
  int64_t q = (int64_t)(c.nodes.size() / 32);
  *out_nodes = (float*)malloc(q * 32 * sizeof(float));
  memcpy(*out_nodes, c.nodes.data(), q * 32 * sizeof(float));
  *out_perm = perm;
  *out_q = q;
}

}  // extern "C"
