// OBJ/MTL loader behind the mini-assimp shim (tools/refbuild).
// Mirrors rgk/io/obj.py so reference goldens and this renderer
// agree on geometry: fan triangulation, per-usemtl mesh split,
// (v,vt,vn)-triple unification, area-weighted smooth normals or
// faceted normals, Lengyel UV tangents.
#include "include/assimp/mini_assimp.h"

#include <cmath>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <map>
#include <sstream>
#include <unordered_map>

namespace {

struct V3 {
    float x, y, z;
};

struct Corner {
    int v = -1, vt = -1, vn = -1;
    bool operator==(const Corner& o) const {
        return v == o.v && vt == o.vt && vn == o.vn;
    }
};

struct CornerHash {
    size_t operator()(const Corner& c) const {
        size_t h = size_t(c.v) * 1000003u;
        h = (h + size_t(c.vt + 1)) * 1000003u;
        return h + size_t(c.vn + 1);
    }
};

struct Group {
    std::string material;
    std::vector<Corner> corners;  // 3 per triangle
};

struct ObjData {
    std::vector<V3> pos, nrm;
    std::vector<V3> uv;
    std::vector<Group> groups;
    std::vector<std::string> mtllibs;
};

int parse_rel(const char* tok, int n) {
    int v = std::atoi(tok);
    return v > 0 ? v - 1 : n + v;
}

Corner parse_corner(const std::string& tok, int nv, int nt, int nn) {
    Corner c;
    size_t s1 = tok.find('/');
    if (s1 == std::string::npos) {
        c.v = parse_rel(tok.c_str(), nv);
        return c;
    }
    c.v = parse_rel(tok.substr(0, s1).c_str(), nv);
    size_t s2 = tok.find('/', s1 + 1);
    std::string t = tok.substr(s1 + 1, s2 == std::string::npos
                                       ? std::string::npos : s2 - s1 - 1);
    if (!t.empty()) c.vt = parse_rel(t.c_str(), nt);
    if (s2 != std::string::npos) {
        std::string nstr = tok.substr(s2 + 1);
        if (!nstr.empty()) c.vn = parse_rel(nstr.c_str(), nn);
    }
    return c;
}

bool parse_obj(const std::string& path, ObjData& out, std::string& err) {
    std::ifstream f(path);
    if (!f.is_open()) {
        err = "cannot open " + path;
        return false;
    }
    std::map<std::string, size_t> group_ids;
    int current = -1;
    auto ensure_group = [&](const std::string& name) {
        auto it = group_ids.find(name);
        if (it != group_ids.end()) return int(it->second);
        group_ids[name] = out.groups.size();
        Group g;
        g.material = name;
        out.groups.push_back(g);
        return int(out.groups.size() - 1);
    };

    std::string line, key, tok;
    std::vector<Corner> cs;
    while (std::getline(f, line)) {
        std::istringstream ls(line);
        if (!(ls >> key) || key[0] == '#') continue;
        if (key == "v") {
            V3 p{0, 0, 0};
            ls >> p.x >> p.y >> p.z;
            out.pos.push_back(p);
        } else if (key == "vt") {
            V3 t{0, 0, 0};
            ls >> t.x >> t.y;
            out.uv.push_back(t);
        } else if (key == "vn") {
            V3 n{0, 0, 0};
            ls >> n.x >> n.y >> n.z;
            out.nrm.push_back(n);
        } else if (key == "f") {
            cs.clear();
            while (ls >> tok)
                cs.push_back(parse_corner(tok, out.pos.size(),
                                          out.uv.size(), out.nrm.size()));
            if (cs.size() < 3) continue;
            if (current < 0) current = ensure_group("");
            Group& g = out.groups[current];
            for (size_t i = 1; i + 1 < cs.size(); i++) {  // fan
                g.corners.push_back(cs[0]);
                g.corners.push_back(cs[i]);
                g.corners.push_back(cs[i + 1]);
            }
        } else if (key == "usemtl") {
            std::string rest;
            std::getline(ls, rest);
            size_t b = rest.find_first_not_of(" \t\r");
            size_t e = rest.find_last_not_of(" \t\r");
            current = ensure_group(
                b == std::string::npos ? "" : rest.substr(b, e - b + 1));
        } else if (key == "mtllib") {
            std::string rest;
            std::getline(ls, rest);
            size_t b = rest.find_first_not_of(" \t\r");
            size_t e = rest.find_last_not_of(" \t\r");
            if (b != std::string::npos)
                out.mtllibs.push_back(rest.substr(b, e - b + 1));
        }
    }
    return true;
}

std::string dirname_of(const std::string& path) {
    size_t s = path.find_last_of('/');
    return s == std::string::npos ? "" : path.substr(0, s + 1);
}

void parse_mtl(const std::string& path,
               std::map<std::string, aiMaterial>& mats) {
    std::ifstream f(path);
    if (!f.is_open()) return;
    std::string line, key;
    aiMaterial* cur = nullptr;
    while (std::getline(f, line)) {
        std::istringstream ls(line);
        if (!(ls >> key) || key[0] == '#') continue;
        if (key == "newmtl") {
            std::string rest;
            std::getline(ls, rest);
            size_t b = rest.find_first_not_of(" \t\r");
            size_t e = rest.find_last_not_of(" \t\r");
            std::string name =
                b == std::string::npos ? "" : rest.substr(b, e - b + 1);
            cur = &mats[name];
            cur->name = name;
        } else if (!cur) {
            continue;
        } else if (key == "Kd") {
            ls >> cur->diffuse.r >> cur->diffuse.g >> cur->diffuse.b;
        } else if (key == "Ks") {
            ls >> cur->specular.r >> cur->specular.g >> cur->specular.b;
        } else if (key == "Ke") {
            ls >> cur->emissive.r >> cur->emissive.g >> cur->emissive.b;
        } else if (key == "Ns") {
            ls >> cur->shininess;
        } else if (key == "Ni") {
            ls >> cur->refracti;
        } else if (key == "d") {
            ls >> cur->opacity;
        } else if (key == "map_Kd" || key == "map_Ks" || key == "map_bump" ||
                   key == "map_Bump" || key == "bump") {
            // rgk/io/obj.py takes the last token (skips -options)
            std::string tok, last;
            while (ls >> tok) last = tok;
            if (key == "map_Kd") cur->diffuse_tex = last;
            else if (key == "map_Ks") cur->specular_tex = last;
            else cur->height_tex = last;
        }
    }
}

inline V3 sub(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 crossv(V3 a, V3 b) {
    return V3{a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x};
}
inline float lenv(V3 a) {
    return std::sqrt(a.x * a.x + a.y * a.y + a.z * a.z);
}

aiMesh* build_mesh(const ObjData& obj, const Group& g,
                   unsigned mat_index, bool smooth) {
    aiMesh* mesh = new aiMesh;
    mesh->mMaterialIndex = mat_index;

    // Unify (v, vt, vn) triples — aiProcess_JoinIdenticalVertices.
    std::unordered_map<Corner, unsigned, CornerHash> uniq;
    std::vector<Corner> verts;
    std::vector<unsigned> tri;
    tri.reserve(g.corners.size());
    for (const Corner& c : g.corners) {
        auto it = uniq.find(c);
        if (it == uniq.end()) {
            it = uniq.emplace(c, unsigned(verts.size())).first;
            verts.push_back(c);
        }
        tri.push_back(it->second);
    }

    size_t nv = verts.size(), nf = tri.size() / 3;
    mesh->vtx.resize(nv);
    mesh->uvw.resize(nv);
    bool all_file_normals = !obj.nrm.empty();
    for (size_t i = 0; i < nv; i++) {
        mesh->vtx[i] = aiVector3D(obj.pos[verts[i].v].x,
                                  obj.pos[verts[i].v].y,
                                  obj.pos[verts[i].v].z);
        if (verts[i].vt >= 0)
            mesh->uvw[i] = aiVector3D(obj.uv[verts[i].vt].x,
                                      obj.uv[verts[i].vt].y, 0.0f);
        if (verts[i].vn < 0) all_file_normals = false;
    }

    // Face normals (area-weighted direction: cross(B-A, C-A)).
    std::vector<V3> fn(nf);
    std::vector<float> fl(nf);
    for (size_t f = 0; f < nf; f++) {
        V3 a = obj.pos[verts[tri[f * 3]].v];
        V3 b = obj.pos[verts[tri[f * 3 + 1]].v];
        V3 c = obj.pos[verts[tri[f * 3 + 2]].v];
        V3 n = crossv(sub(b, a), sub(c, a));
        float l = lenv(n);
        fl[f] = l;
        float il = 1.0f / (l > 1e-20f ? l : 1e-20f);
        fn[f] = V3{n.x * il, n.y * il, n.z * il};
    }

    mesh->nrm.resize(nv);
    if (all_file_normals) {
        for (size_t i = 0; i < nv; i++)
            mesh->nrm[i] = aiVector3D(obj.nrm[verts[i].vn].x,
                                      obj.nrm[verts[i].vn].y,
                                      obj.nrm[verts[i].vn].z);
    } else if (smooth) {
        // Accumulate area-weighted normals at shared *positions* so
        // coincident corners agree (obj.py _assemble_mesh smooth path).
        std::unordered_map<int, V3> acc;
        for (size_t f = 0; f < nf; f++)
            for (int k = 0; k < 3; k++) {
                V3& a = acc[verts[tri[f * 3 + k]].v];
                a.x += fn[f].x * fl[f];
                a.y += fn[f].y * fl[f];
                a.z += fn[f].z * fl[f];
            }
        for (size_t i = 0; i < nv; i++) {
            V3 a = acc[verts[i].v];
            float l = lenv(a);
            float il = 1.0f / (l > 1e-20f ? l : 1e-20f);
            mesh->nrm[i] = aiVector3D(a.x * il, a.y * il, a.z * il);
        }
    } else {
        // Faceted: replicate the face normal to its corners (last
        // writer wins for corners shared across faces).
        for (size_t f = 0; f < nf; f++)
            for (int k = 0; k < 3; k++)
                mesh->nrm[tri[f * 3 + k]] =
                    aiVector3D(fn[f].x, fn[f].y, fn[f].z);
    }

    // Lengyel UV tangents (aiProcess_CalcTangentSpace analogue,
    // matching obj.py _generate_tangents).
    mesh->tan.assign(nv, aiVector3D(0, 0, 0));
    for (size_t f = 0; f < nf; f++) {
        unsigned ia = tri[f * 3], ib = tri[f * 3 + 1], ic = tri[f * 3 + 2];
        V3 pa{mesh->vtx[ia].x, mesh->vtx[ia].y, mesh->vtx[ia].z};
        V3 pb{mesh->vtx[ib].x, mesh->vtx[ib].y, mesh->vtx[ib].z};
        V3 pc{mesh->vtx[ic].x, mesh->vtx[ic].y, mesh->vtx[ic].z};
        V3 e1 = sub(pb, pa), e2 = sub(pc, pa);
        float du1 = mesh->uvw[ib].x - mesh->uvw[ia].x;
        float dv1 = mesh->uvw[ib].y - mesh->uvw[ia].y;
        float du2 = mesh->uvw[ic].x - mesh->uvw[ia].x;
        float dv2 = mesh->uvw[ic].y - mesh->uvw[ia].y;
        float det = du1 * dv2 - du2 * dv1;
        float r = std::fabs(det) > 1e-12f ? 1.0f / det : 0.0f;
        V3 t{(e1.x * dv2 - e2.x * dv1) * r, (e1.y * dv2 - e2.y * dv1) * r,
             (e1.z * dv2 - e2.z * dv1) * r};
        for (unsigned idx : {ia, ib, ic}) {
            mesh->tan[idx].x += t.x;
            mesh->tan[idx].y += t.y;
            mesh->tan[idx].z += t.z;
        }
    }
    for (size_t i = 0; i < nv; i++) {
        V3 t{mesh->tan[i].x, mesh->tan[i].y, mesh->tan[i].z};
        float l = lenv(t);
        float il = 1.0f / (l > 1e-20f ? l : 1e-20f);
        mesh->tan[i] = aiVector3D(t.x * il, t.y * il, t.z * il);
    }

    // Index pool + faces.
    mesh->index_pool = tri;
    mesh->faces.resize(nf);
    for (size_t f = 0; f < nf; f++) {
        mesh->faces[f].mNumIndices = 3;
        mesh->faces[f].mIndices = &mesh->index_pool[f * 3];
    }

    mesh->mNumVertices = unsigned(nv);
    mesh->mNumFaces = unsigned(nf);
    mesh->mVertices = mesh->vtx.data();
    mesh->mNormals = mesh->nrm.data();
    mesh->mTangents = mesh->tan.data();
    mesh->mTextureCoords[0] = mesh->uvw.data();
    mesh->mFaces = mesh->faces.data();
    return mesh;
}

}  // namespace

aiScene::~aiScene() {
    for (aiMesh* m : meshes) delete m;
    for (aiMaterial* m : materials) delete m;
    delete mRootNode;
}

namespace Assimp {

Importer::~Importer() { delete scene_; }

const aiScene* Importer::ApplyPostProcessing(unsigned) { return scene_; }

const aiScene* Importer::ReadFile(const std::string& path, unsigned flags) {
    delete scene_;
    scene_ = nullptr;

    ObjData obj;
    if (!parse_obj(path, obj, error_)) return nullptr;

    std::map<std::string, aiMaterial> mtl;
    std::string base = dirname_of(path);
    for (const std::string& lib : obj.mtllibs) parse_mtl(base + lib, mtl);

    bool smooth = (flags & aiProcess_GenSmoothNormals) != 0;

    aiScene* sc = new aiScene;
    for (const Group& g : obj.groups) {
        if (g.corners.empty()) continue;
        aiMaterial* mat = new aiMaterial;
        auto it = mtl.find(g.material);
        if (it != mtl.end()) *mat = it->second;
        mat->name = g.material;
        unsigned mat_index = unsigned(sc->materials.size());
        sc->materials.push_back(mat);
        sc->meshes.push_back(build_mesh(obj, g, mat_index, smooth));
    }

    sc->mNumMeshes = unsigned(sc->meshes.size());
    sc->mMeshes = sc->meshes.data();
    sc->mNumMaterials = unsigned(sc->materials.size());
    sc->mMaterials = sc->materials.data();

    aiNode* root = new aiNode;
    root->mesh_ids.resize(sc->meshes.size());
    for (unsigned i = 0; i < sc->mNumMeshes; i++) root->mesh_ids[i] = i;
    root->mNumMeshes = unsigned(root->mesh_ids.size());
    root->mMeshes = root->mesh_ids.data();
    sc->mRootNode = root;

    scene_ = sc;
    return sc;
}

}  // namespace Assimp
