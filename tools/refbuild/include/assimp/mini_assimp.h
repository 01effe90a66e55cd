// Minimal assimp-compatible shim — OBJ/MTL only, just the API surface the
// RGKrt reference uses (config.cpp loadAssimpScene, scene.cpp LoadAi*,
// bxdf.cpp LoadFromAiMaterial).  Hand-written for this repo
// (tools/refbuild); NOT the real assimp.
//
// Semantics deliberately mirror rgk/io/obj.py so golden images from
// the reference build and renders from this renderer see the same
// geometry: fan triangulation, (v,vt,vn)-triple vertex unification,
// per-usemtl mesh split, area-weighted smooth / faceted normals,
// Lengyel UV tangents, raw MTL Ns stored as shininess*4 is NOT applied
// (the reference divides by 4; storing 4*Ns would double-correct —
// see bxdf.cpp:106 comment trail).
#ifndef RGK_MINI_ASSIMP_H
#define RGK_MINI_ASSIMP_H

#include <cstring>
#include <string>
#include <vector>

// ----------------------------------------------------------- basic types
struct aiString {
    std::string s;
    aiString() {}
    explicit aiString(const std::string& v) : s(v) {}
    const char* C_Str() const { return s.c_str(); }
};

struct aiVector3D {
    float x, y, z;
    aiVector3D() : x(0), y(0), z(0) {}
    aiVector3D(float x_, float y_, float z_) : x(x_), y(y_), z(z_) {}
};

struct aiColor3D {
    float r, g, b;
    aiColor3D() : r(0), g(0), b(0) {}
    aiColor3D(float r_, float g_, float b_) : r(r_), g(g_), b(b_) {}
};

// Row-major 4x4, operator[] yields a row (real-assimp layout).
struct aiMatrix4x4 {
    float m[4][4];
    aiMatrix4x4() {
        std::memset(m, 0, sizeof(m));
        m[0][0] = m[1][1] = m[2][2] = m[3][3] = 1.0f;
    }
    float* operator[](int r) { return m[r]; }
    const float* operator[](int r) const { return m[r]; }
};

struct aiFace {
    unsigned int mNumIndices = 0;
    unsigned int* mIndices = nullptr;
};

// ----------------------------------------------------------- enums / flags
enum aiTextureType {
    aiTextureType_DIFFUSE = 1,
    aiTextureType_SPECULAR = 2,
    aiTextureType_HEIGHT = 5,
};

enum aiPrimitiveType {
    aiPrimitiveType_POINT = 0x1,
    aiPrimitiveType_LINE = 0x2,
    aiPrimitiveType_TRIANGLE = 0x4,
};

#define aiProcess_Triangulate            0x8u
#define aiProcess_GenNormals             0x20u
#define aiProcess_GenSmoothNormals       0x40u
#define aiProcess_JoinIdenticalVertices  0x2u
#define aiProcess_GenUVCoords            0x40000u
#define aiProcess_FindDegenerates        0x10000u
#define aiProcess_CalcTangentSpace       0x1u
#define aiProcess_TransformUVCoords      0x80000u

#define AI_CONFIG_PP_SBP_REMOVE "PP_SBP_REMOVE"

// material keys: (name, type, index) triples like real assimp
#define AI_MATKEY_NAME           "?mat.name", 0, 0
#define AI_MATKEY_COLOR_DIFFUSE  "$clr.diffuse", 0, 0
#define AI_MATKEY_COLOR_SPECULAR "$clr.specular", 0, 0
#define AI_MATKEY_COLOR_EMISSIVE "$clr.emissive", 0, 0
#define AI_MATKEY_SHININESS      "$mat.shininess", 0, 0
#define AI_MATKEY_REFRACTI       "$mat.refracti", 0, 0
#define AI_MATKEY_OPACITY        "$mat.opacity", 0, 0

enum aiReturn { aiReturn_SUCCESS = 0, aiReturn_FAILURE = -1 };

// ----------------------------------------------------------- material
struct aiMaterial {
    std::string name;
    aiColor3D diffuse{0.6f, 0.6f, 0.6f};
    aiColor3D specular{0.0f, 0.0f, 0.0f};
    aiColor3D emissive{0.0f, 0.0f, 0.0f};
    float shininess = 0.0f;
    float refracti = 1.0f;
    float opacity = 1.0f;
    std::string diffuse_tex, specular_tex, height_tex;

    aiReturn Get(const char* key, unsigned, unsigned, aiString& out) const {
        if (!std::strcmp(key, "?mat.name")) { out = aiString(name); return aiReturn_SUCCESS; }
        return aiReturn_FAILURE;
    }
    aiReturn Get(const char* key, unsigned, unsigned, aiColor3D& out) const {
        if (!std::strcmp(key, "$clr.diffuse")) { out = diffuse; return aiReturn_SUCCESS; }
        if (!std::strcmp(key, "$clr.specular")) { out = specular; return aiReturn_SUCCESS; }
        if (!std::strcmp(key, "$clr.emissive")) { out = emissive; return aiReturn_SUCCESS; }
        return aiReturn_FAILURE;
    }
    aiReturn Get(const char* key, unsigned, unsigned, float& out) const {
        if (!std::strcmp(key, "$mat.shininess")) { out = shininess; return aiReturn_SUCCESS; }
        if (!std::strcmp(key, "$mat.refracti")) { out = refracti; return aiReturn_SUCCESS; }
        if (!std::strcmp(key, "$mat.opacity")) { out = opacity; return aiReturn_SUCCESS; }
        return aiReturn_FAILURE;
    }
    unsigned GetTextureCount(aiTextureType t) const {
        const std::string& p = t == aiTextureType_DIFFUSE ? diffuse_tex
            : t == aiTextureType_SPECULAR ? specular_tex : height_tex;
        return p.empty() ? 0 : 1;
    }
    aiReturn GetTexture(aiTextureType t, unsigned, aiString* out) const {
        const std::string& p = t == aiTextureType_DIFFUSE ? diffuse_tex
            : t == aiTextureType_SPECULAR ? specular_tex : height_tex;
        if (p.empty()) return aiReturn_FAILURE;
        *out = aiString(p);
        return aiReturn_SUCCESS;
    }
};

// ----------------------------------------------------------- mesh / node / scene
struct aiMesh {
    unsigned int mNumVertices = 0;
    unsigned int mNumFaces = 0;
    aiVector3D* mVertices = nullptr;
    aiVector3D* mNormals = nullptr;
    aiVector3D* mTangents = nullptr;
    aiVector3D* mTextureCoords[8] = {};
    aiFace* mFaces = nullptr;
    unsigned int mMaterialIndex = 0;

    std::vector<aiVector3D> vtx, nrm, tan, uvw;
    std::vector<aiFace> faces;
    std::vector<unsigned int> index_pool;
    ~aiMesh() {}
};

struct aiNode {
    aiMatrix4x4 mTransformation;
    unsigned int mNumMeshes = 0;
    unsigned int* mMeshes = nullptr;
    unsigned int mNumChildren = 0;
    aiNode** mChildren = nullptr;
    std::vector<unsigned int> mesh_ids;
};

struct aiScene {
    unsigned int mNumMeshes = 0;
    aiMesh** mMeshes = nullptr;
    unsigned int mNumMaterials = 0;
    aiMaterial** mMaterials = nullptr;
    aiNode* mRootNode = nullptr;

    std::vector<aiMesh*> meshes;
    std::vector<aiMaterial*> materials;
    ~aiScene();
};

// ----------------------------------------------------------- importer
namespace Assimp {

class Importer {
public:
    ~Importer();
    void SetPropertyInteger(const char*, int, bool* = nullptr) {}
    const aiScene* ReadFile(const std::string& path, unsigned flags);
    const aiScene* ApplyPostProcessing(unsigned flags);
    const char* GetErrorString() const { return error_.c_str(); }

private:
    aiScene* scene_ = nullptr;
    std::string error_;
};

}  // namespace Assimp

#endif  // RGK_MINI_ASSIMP_H
