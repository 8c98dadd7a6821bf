// The fast path's deferred shading pass for the PyTorch port's frames:
// G-buffer planes, SSAO, the PCF table and the IBL tables in, clamped
// tonemapped colour out.
//
// Replaces mo_renderer_tpu/passes/shading.py shading_pass_fast:717 -- K9.
// The reference has no pallas_call here: XLA fuses the jnp code into a few
// fusions on the TPU.  The port's plain version (passes/shading.py,
// _shading_fast_plain) runs it as ~2400 PyTorch ops a frame at 1080p, each
// one pass over a (H, W, 3) plane; this kernel is all of it.
//
// What bounds it on this card: bytes in principle -- per shading pixel 15
// floats of G-buffer planes, the depth and SSAO read once, 3 floats
// written, plus one or two table rows gathered per even-grid sample (~80 B
// a pixel, ~0.03 ms at the 1088 x 960 checkerboard frame) -- in practice
// instruction throughput and latency: a lit pixel evaluates the lights,
// SH9 and the 13 x 13 Chebyshev environment BRDF, ~1000 FP32 operations,
// and the table rows are dependent gathers.  Measured on the card
// (PERF.md), the two phases below barely overlap and resident warps are
// what the kernel runs short of.
//
// Design: one launch; a block of 512 threads owns a tile of 16 rows x 32
// columns of the shading domain, at 64 registers a thread (two blocks an
// SM: __launch_bounds__).
// 1. The block loads the per-frame constants into shared memory once: the
//    light rows, light_pv, SH9, the eye and the camera basis, the specular
//    chain's level tables.  A light table of more than kLightChunkRows
//    rows (the kStreamed instance) is not loaded here: after step 2 the
//    block streams it through the same shared memory a chunk at a time,
//    every thread summing its pixel's lights in light order
//    (shade_lights), and step 3 takes that sum.
// 2. It evaluates the even-grid samples (2i, sx*j) of its tile plus the
//    one row and column past it that the upsamples and the mask-aware taps
//    read (sx = 1 on the checkerboard domain, 2 on a full frame), into
//    shared memory: the mirror/sky tap c0 (the sky samples re-pointed at
//    mip 0 of the specular table, the environment), the parent-mip tap c1
//    (from the merged child+parent row, or its own row), the sky flag, and
//    the PCF factor on the divisor's grid (divisor 2: the even grid;
//    divisor 4: the samples with i and j even, on their own grid, from a
//    warp of their own).  A halo sample is evaluated by each block that
//    reads it: ~13-27% more even-grid work, none of it through device
//    memory.
// 3. After a barrier, one thread a pixel.  With IBL a sky pixel (depth >=
//    1) keeps the sky colour, the mirror tap, which is all it reads: the
//    plain version computes the lights and the ambient there too and then
//    discards them (where(sky_mask, sky, ...)).  Any other pixel: the
//    lights, SH9 irradiance, the environment BRDF (its 338 coefficients in
//    __constant__ memory: every lane of a warp reads the same one, a
//    broadcast operand of the fused multiply-add), the split-sum ambient,
//    the upsamples of the tile's even-grid samples (the mask-aware one for
//    the mirror tap), the combine, tonemap and clamp.  The full-rate taps of
//    the spec_* flags and the full-rate PCF (divisor 1) are evaluated here.
// The G-buffer planes and SSAO are read where they are, through their
// strides: no copy of a view.  Nothing is read on the host and nothing is
// allocated here, so a CUDA graph captures the launch.  The even-grid
// samples reach device memory only through the optional debug pointers
// (null on the frame's path), which a check holds against the plain
// version sample by sample; so does every discrete choice made at full
// rate (dbg: the full-rate taps' table rows, the environment row of a sky
// pixel, the mask-aware upsample's pick, the PCF window at divisor 1).
//
// Arithmetic: this unit alone builds with -fmad=true -prec-div=false
// -prec-sqrt=false (kernels/_build.py UNIT_FLAGS): the compiler contracts a
// multiply and an add into one fused multiply-add, which rounds once where
// the plain version rounds twice, and divides and takes square roots to
// within 2 ulps; c ** 5 is four products and the spot cone's power
// __powf.  The lights, SH9, the environment BRDF, the split sum, the
// upsamples and the tonemap move by a few ulps, inside the pass's bar.
// Every value that feeds a compare or an integer is computed with the
// pinned helpers below (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: never contracted, always correctly rounded), so it rounds
// once per operation as the plain version's torch op does:
// - the light projection and every PCF tap (shadow_fast): its texel anchor,
//   the tap fractions and the compare `current > closest`, the pass's one
//   hard discontinuity;
// - the reflection direction, its cube face and face coordinates, and the
//   texel index and fractions of every specular tap (reflection_dir,
//   cube_face_uv, quad_index), on the even grid and at full rate;
// - the sky rays and the environment texel they pick (sky_dir, env_index);
// - the mip level floor(clamp(roughness * 7)): one multiply, which nothing
//   contracts.
// The sky flag is depth >= 1, a compare of the input itself.  The plain
// version's order on the card is the bar: a dot product that feeds a
// choice (the view vector's length, n.v in the reflection, the sky ray's
// length) adds its three products as PyTorch's CUDA sum(-1) over a
// 3-channel plane does, (x + z) + y (pdot3, shared with
// csrc/shading_ref.cu); a sky ray's (i + 0.5) / n is a multiply by the
// correctly rounded reciprocal, as PyTorch's CUDA division by a Python
// scalar is.  Where the plain version's order is a library's, the kernel
// follows the card's: the light projection and SH9 (cuBLAS matrix
// products) are fused multiply-add chains in k order.
#include "shading_common.cuh"

// What the kernel reads, filled by passes/shading.py shade_args (its
// ShadeArgs ctypes structure mirrors this one field for field).
struct ShadeArgs {
  // G-buffer planes on the shading domain (H, W, 3): position, normal,
  // base colour, emissive, orm
  const float* planes[5];
  long long strides[5][3];  // elements: row, column, channel
  const float* depth;       // (H, W)
  long long depth_strides[2];
  const float* ssao;  // (H, W)
  long long ssao_strides[2];
  float* out;         // (H, W, 3) contiguous
  // debug outputs, null on the frame's path: the even-grid samples
  float* c0h;       // (Hh, Wh, 3): mirror / sky tap on the even grid
  float* c1h;       // (Hh, Wh, 3): parent-mip tap on the even grid
  uint8_t* skyh;    // (Hh, Wh): depth >= 1 on the even grid
  float* pcf;       // (Hq, Wq): PCF factor on the divisor's grid
  int* rows_h;      // (Hh, Wh, 2): the mirror tap's table row, the parent's
  const float* lights;
  const float* eye;       // (3,)
  const float* light_pv;  // (4, 4) row-major
  const float* right;     // (3,)
  const float* up;        // (3,)
  const float* direction; // (3,)
  const float* near_;     // ()
  const float* near_wh;   // (2,)
  const float* sh9;       // (9, 3)
  const int* spec_rows;   // (N, 4) RGBE quads
  const int* merged_rows; // (N, 8) child + parent quads
  const int* sizes;       // (levels,)
  const int* offsets;     // (levels,)
  const void* pcf_rows;   // (R, 8) int32 u16 windows or float32 wide rows
  int h, w;               // the shading domain
  int hh, wh;             // the even grid
  int hq, wq;             // the PCF grid (divisor 2: the even grid)
  int cb;
  int has_ibl, mirror_half, parent_half;
  int merged;  // both taps from one row of merged_rows
  int num_levels, env_size, env_off;
  int pcf_layout, shadow_size, pcf_div;
  int row_offset, full_height, sky_w;
  int light_stride, n_lights;
  int* dbg;  // debug, null on the frame's path: (H, W, kDbgChannels)
};

namespace {

// the PCF table layouts (passes/shading.py PCF_*)
// (2, u16 windows at every texel, is the remaining case)
constexpr int kPcfNone = 0;
constexpr int kPcfU16Half = 1;
constexpr int kPcfF32Wide = 3;

// the debug output's channels per pixel (-1 where no choice is made there):
// the table row of the full-rate mirror tap (at a sky pixel the
// environment's) and of the full-rate parent tap, the even-grid sample the
// mirror tap's mask-aware upsample takes (i * wh + j), the PCF window's
// anchor at divisor 1 (y0 << 16 | x0)
constexpr int kDbgMirrorRow = 0;
constexpr int kDbgParentRow = 1;
constexpr int kDbgMirrorPick = 2;
constexpr int kDbgPcfAnchor = 3;
constexpr int kDbgChannels = 4;

// channel ``c`` of pixel (y, x) of the debug output, where there is one
// (the frame's path passes none: no pointer is kept live for it)
__device__ __forceinline__ void debug_choice(const ShadeArgs& a, int y, int x,
                                             int c, int v) {
  if (a.dbg != nullptr) a.dbg[((size_t)y * a.w + x) * kDbgChannels + c] = v;
}

// the tile: 16 x 32 pixels of the shading domain, one thread each; its
// even-grid samples with the row and column past them (the checkerboard
// domain's even grid has the tile's width, a full frame's half of it), and
// at divisor 4 the PCF grid's.  Two blocks an SM cap a thread at 64
// registers: more warps in flight paid more than the registers (PERF.md).
constexpr int kTileH = 16;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kMinBlocks = 2;  // resident blocks an SM must fit (registers)
constexpr int kEvenH = kTileH / 2 + 1;
constexpr int kEvenW = kTileW + 1;

constexpr int kDeg = 12;

// Chebyshev coefficients of the environment BRDF, COEFFS[2*i + c][j] of
// kernels/env_brdf_coeffs.py rounded to float32 as the plain version's
// tensor-by-scalar products round them (tests/test_torch_shading.py holds
// the two tables equal).
__constant__ float kEnvBrdf[2 * (kDeg + 1)][kDeg + 1] = {
    {0.5880749225616455f, 0.31482210755348206f, -0.06927309930324554f, -0.01410242822021246f, -0.015311765484511852f, 0.02973618172109127f, -0.02563677541911602f, 0.019577767699956894f, -0.017665255814790726f, 0.010888717137277126f, -0.008950711227953434f, 0.005851624999195337f, -0.003769149072468281f},
    {0.16951754689216614f, -0.20747192203998566f, -0.014707483351230621f, 0.09655094891786575f, -0.06981408596038818f, 0.046060241758823395f, -0.04841623082756996f, 0.050902776420116425f, -0.05041246861219406f, 0.04325279965996742f, -0.03274185582995415f, 0.01954229362308979f, -0.025550775229930878f},
    {0.021117113530635834f, -0.47301509976387024f, 0.15533342957496643f, -0.010319141671061516f, 0.033686596900224686f, -0.04881493002176285f, 0.0464026965200901f, -0.03752549737691879f, 0.033656589686870575f, -0.02064916491508484f, 0.01696208119392395f, -0.011455904692411423f, 0.007238161284476519f},
    {-0.17158712446689606f, 0.20328088104724884f, 0.047505032271146774f, -0.1553935408592224f, 0.13347890973091125f, -0.1005958542227745f, 0.09954526275396347f, -0.10107564181089401f, 0.09997133165597916f, -0.08581031858921051f, 0.0649285614490509f, -0.03877846896648407f, 0.05027630552649498f},
    {-0.10345953702926636f, -0.009765625931322575f, -0.120109423995018f, 0.08945328742265701f, -0.06172635406255722f, 0.04238145425915718f, -0.041808441281318665f, 0.03729698061943054f, -0.03370892256498337f, 0.020822839811444283f, -0.017142871394753456f, 0.011358006857335567f, -0.007231414318084717f},
    {-0.030853549018502235f, 0.057973507791757584f, -0.06976506114006042f, 0.09558720141649246f, -0.11391077935695648f, 0.10853441804647446f, -0.10286318510770798f, 0.09890890121459961f, -0.09714867919683456f, 0.08338738232851028f, -0.06304795295000076f, 0.03778412938117981f, -0.048742782324552536f},
    {-0.027233650907874107f, -0.024545205757021904f, 0.01936071552336216f, -0.06967218965291977f, 0.07303358614444733f, -0.046468060463666916f, 0.039040032774209976f, -0.03426701948046684f, 0.0309450626373291f, -0.018867332488298416f, 0.015581072308123112f, -0.010390698909759521f, 0.006623664405196905f},
    {0.06663227081298828f, -0.11003272980451584f, 0.07555343210697174f, -0.0666000097990036f, 0.08599728345870972f, -0.09723096340894699f, 0.0991620346903801f, -0.09534694999456406f, 0.09280473738908768f, -0.07938532531261444f, 0.05993327498435974f, -0.03595593199133873f, 0.04613905027508736f},
    {-0.03860856220126152f, 0.07944691926240921f, -0.045602940022945404f, 0.03281773626804352f, -0.05409593507647514f, 0.04631393775343895f, -0.0392635352909565f, 0.03224070370197296f, -0.028756679967045784f, 0.017722899094223976f, -0.014504825696349144f, 0.009655949659645557f, -0.006098607089370489f},
    {-0.036419764161109924f, 0.0712435394525528f, -0.0687011182308197f, 0.06045200675725937f, -0.06298632174730301f, 0.07126472890377045f, -0.08161148428916931f, 0.08423347026109695f, -0.08405879139900208f, 0.07240185141563416f, -0.054927580058574677f, 0.032836999744176865f, -0.04304832965135574f},
    {0.03386349976062775f, -0.05983959138393402f, 0.06507009267807007f, -0.03971439227461815f, 0.037558503448963165f, -0.032877855002880096f, 0.032353077083826065f, -0.027878781780600548f, 0.02494213730096817f, -0.015128613449633121f, 0.012440315447747707f, -0.00824913289397955f, 0.005305914208292961f},
    {0.027270179241895676f, -0.057143885642290115f, 0.06452672183513641f, -0.06231687217950821f, 0.057465892285108566f, -0.05453229695558548f, 0.06152317300438881f, -0.06743042171001434f, 0.07085606455802917f, -0.06246264651417732f, 0.04789983108639717f, -0.02863575890660286f, 0.03845537081360817f},
    {-0.019148919731378555f, 0.050827451050281525f, -0.04838670417666435f, 0.048735857009887695f, -0.04221487417817116f, 0.02902921289205551f, -0.02785542979836464f, 0.02512274496257305f, -0.022542154416441917f, 0.014012739062309265f, -0.011511708609759808f, 0.007698156405240297f, -0.004770651459693909f},
    {-0.030547797679901123f, 0.0602019727230072f, -0.06276659667491913f, 0.06275361031293869f, -0.06075706705451012f, 0.05355032533407211f, -0.052176833152770996f, 0.05368100479245186f, -0.05694833770394325f, 0.051149964332580566f, -0.039701685309410095f, 0.023977309465408325f, -0.03313713148236275f},
    {0.017567098140716553f, -0.038995061069726944f, 0.035551171749830246f, -0.03404398262500763f, 0.038473941385746f, -0.027472464367747307f, 0.02280653826892376f, -0.01972639188170433f, 0.018143286928534508f, -0.011390279978513718f, 0.009283994324505329f, -0.006143119186162949f, 0.0038714143447577953f},
    {0.031237274408340454f, -0.061098020523786545f, 0.06180214881896973f, -0.06179947778582573f, 0.06303705275058746f, -0.05892205983400345f, 0.05464515835046768f, -0.05036502704024315f, 0.04915659502148628f, -0.04270850121974945f, 0.032761164009571075f, -0.01978933997452259f, 0.027422931045293808f},
    {-0.013690744526684284f, 0.028779853135347366f, -0.02707391232252121f, 0.022384479641914368f, -0.025882292538881302f, 0.02102738432586193f, -0.01813606359064579f, 0.014862222597002983f, -0.013513725250959396f, 0.008171260356903076f, -0.006828514859080315f, 0.004571470897644758f, -0.0029928514268249273f},
    {-0.027115894481539726f, 0.0536063089966774f, -0.054816603660583496f, 0.054748475551605225f, -0.05656876415014267f, 0.05582551285624504f, -0.05449299141764641f, 0.05015375465154648f, -0.046136870980262756f, 0.03789336606860161f, -0.028134332969784737f, 0.016659915447235107f, -0.022939205169677734f},
    {0.011877131648361683f, -0.02653166651725769f, 0.02429211512207985f, -0.021464837715029716f, 0.021065691486001015f, -0.01693660579621792f, 0.01621313951909542f, -0.013814128004014492f, 0.011757969856262207f, -0.007305650040507317f, 0.00604320177808404f, -0.004032484721392393f, 0.002473504049703479f},
    {0.019991423934698105f, -0.039626769721508026f, 0.0409107431769371f, -0.040976688265800476f, 0.042276009917259216f, -0.0425398014485836f, 0.04409452900290489f, -0.043214794248342514f, 0.04076163098216057f, -0.03337744623422623f, 0.02446119673550129f, -0.014417288824915886f, 0.018660036846995354f},
    {-0.007934930734336376f, 0.017838289961218834f, -0.01641344465315342f, 0.014518571086227894f, -0.014589931815862656f, 0.010785004124045372f, -0.010048513300716877f, 0.00891726091504097f, -0.008101148530840874f, 0.005034776870161295f, -0.00397980771958828f, 0.002581820823252201f, -0.0015658719930797815f},
    {-0.00878696795552969f, 0.01735510677099228f, -0.018592121079564095f, 0.019183682277798653f, -0.020688386633992195f, 0.021595394238829613f, -0.024265538901090622f, 0.02622176520526409f, -0.027393899857997894f, 0.024201685562729836f, -0.018673324957489967f, 0.011584682390093803f, -0.014206456020474434f},
    {0.005524216685444117f, -0.012299172580242157f, 0.011432159692049026f, -0.009887133724987507f, 0.010822328738868237f, -0.00799255445599556f, 0.006610802840441465f, -0.00610103365033865f, 0.005727470386773348f, -0.003546213498339057f, 0.002861126558855176f, -0.001971758436411619f, 0.001310716150328517f},
    {-0.0012165224179625511f, 0.0024741818197071552f, -0.0013494030572474003f, 0.0002678062010090798f, 0.0016417682636529207f, -0.003092751372605562f, 0.005613862536847591f, -0.008343586698174477f, 0.01142352819442749f, -0.011989377439022064f, 0.01049287524074316f, -0.0071904524229466915f, 0.00899976771324873f},
    {-0.004388496745377779f, 0.009385719895362854f, -0.008630648255348206f, 0.00821900274604559f, -0.007937212474644184f, 0.006381741724908352f, -0.005723766051232815f, 0.004605020396411419f, -0.003953181207180023f, 0.0027994057163596153f, -0.002297349041327834f, 0.001477214740589261f, -0.0007811021059751511f},
    {0.009647891856729984f, -0.019230997189879417f, 0.017951102927327156f, -0.016561005264520645f, 0.014054764993488789f, -0.011807195842266083f, 0.008707345463335514f, -0.005644944962114096f, 0.0019392671529203653f, 0.0003952013503294438f, -0.0018833749927580357f, 0.0017892566975206137f, -0.006824064999818802f},
};


__device__ __forceinline__ V3 plane3(const ShadeArgs& a, int k, int y, int x) {
  const float* p = a.planes[k] + y * a.strides[k][0] + x * a.strides[k][1];
  const long long c = a.strides[k][2];
  return v3(p[0], p[c], p[2 * c]);
}
__device__ __forceinline__ float plane_c(const ShadeArgs& a, int k, int y,
                                         int x, int c) {
  return a.planes[k][y * a.strides[k][0] + x * a.strides[k][1] +
                     c * a.strides[k][2]];
}
__device__ __forceinline__ float depth_at(const ShadeArgs& a, int y, int x) {
  return a.depth[y * a.depth_strides[0] + x * a.depth_strides[1]];
}

// ---- sampling (device/sampling.py) ----------------------------------------

struct QuadIndex {
  int idx;
  float fx, fy;
  int x0, y0;
};

// mipcube_quad_index_anchor / bilinear_weights(CLAMP_TO_EDGE) of one
// s x s face at row offset ``off`` (pinned)
__device__ QuadIndex quad_index(int off, int s, FaceUV c) {
  const float sf = (float)s;
  const float x = psub(pmul(c.u, sf), 0.5f);
  const float y = psub(pmul(c.v, sf), 0.5f);
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  QuadIndex q;
  q.fx = x0 < 0.0f ? 0.0f : psub(x, x0);
  q.fy = y0 < 0.0f ? 0.0f : psub(y, y0);
  q.x0 = min(max((int)x0, 0), s - 1);
  q.y0 = min(max((int)y0, 0), s - 1);
  q.idx = off + c.face * s * s + q.y0 * s + q.x0;
  return q;
}

__device__ __forceinline__ QuadIndex mip_quad_index(const FrameConsts& k,
                                                    int level, FaceUV c) {
  return quad_index(k.offsets[level], k.sizes[level], c);
}

// unpack_rgbe
__device__ __forceinline__ V3 unpack_rgbe(int bits) {
  const unsigned v = (unsigned)bits;
  const unsigned e = (v >> 24) & 0xFFu;
  const float s = e > 0u ? exp2f(((float)e - 128.0f) - 8.0f) : 0.0f;
  return v3(((float)(v & 0xFFu) + 0.5f) * s,
            ((float)((v >> 8) & 0xFFu) + 0.5f) * s,
            ((float)((v >> 16) & 0xFFu) + 0.5f) * s);
}

// quad_lerp_rgbe
__device__ V3 quad_lerp_rgbe(const int* q, float fx, float fy) {
  const V3 t00 = unpack_rgbe(q[0]);
  const V3 t10 = unpack_rgbe(q[1]);
  const V3 t01 = unpack_rgbe(q[2]);
  const V3 t11 = unpack_rgbe(q[3]);
  const float gx = 1.0f - fx, gy = 1.0f - fy;
  const V3 top = add(scale(t00, gx), scale(t10, fx));
  const V3 bot = add(scale(t01, gx), scale(t11, fx));
  return add(scale(top, gy), scale(bot, fy));
}

// ---- BRDF (kernels/brdf.py) -------------------------------------------------

// the real SH basis constants (kernels/ibl.py _SH_C)
__constant__ float kSh[5] = {(float)0.282095, (float)0.488603,
                             (float)1.092548, (float)0.315392,
                             (float)0.546274};

// env_brdf_poly: (scale, bias)
__device__ void env_brdf_poly(float ndotv, float rough, float* scale_out,
                              float* bias_out) {
  const float half = 0.5f / 512.0f;
  const float x = 2.0f * sqrtf(clampf(ndotv, half, 1.0f - half)) - 1.0f;
  const float y = 2.0f * sqrtf(clampf(rough, half, 1.0f - half)) - 1.0f;
  float tx[kDeg + 1], ty[kDeg + 1];
  tx[0] = 1.0f;
  tx[1] = x;
  ty[0] = 1.0f;
  ty[1] = y;
#pragma unroll
  for (int i = 2; i <= kDeg; ++i) {
    tx[i] = (2.0f * x) * tx[i - 1] - tx[i - 2];
    ty[i] = (2.0f * y) * ty[i - 1] - ty[i - 2];
  }
  float acc[2] = {0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int i = 0; i <= kDeg; ++i) {
      const float* row = kEnvBrdf[2 * i + c];
      float inner = row[0] * tx[0];
#pragma unroll
      for (int j = 1; j <= kDeg; ++j) inner = inner + row[j] * tx[j];
      acc[c] = acc[c] + ty[i] * inner;
    }
  }
  *scale_out = acc[0];
  *bias_out = acc[1];
}

// sh9_eval: the basis times the (9, 3) coefficients
__device__ V3 sh9_eval(const float* co, V3 d) {
  const float b[9] = {
      kSh[0],
      kSh[1] * d.y,
      kSh[1] * d.z,
      kSh[1] * d.x,
      (kSh[2] * d.x) * d.y,
      (kSh[2] * d.y) * d.z,
      kSh[3] * ((3.0f * d.z) * d.z - 1.0f),
      (kSh[2] * d.x) * d.z,
      kSh[4] * (d.x * d.x - d.y * d.y),
  };
  float r[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = b[0] * co[c];
#pragma unroll
    for (int k = 1; k < 9; ++k) acc = fmaf(b[k], co[3 * k + c], acc);
    r[c] = acc;
  }
  return v3(r[0], r[1], r[2]);
}

// ---- sky rays (_sky_dirs) and the environment row (_env_quad_index) ---------

// (pinned; the plain version's (i + 0.5) / n divides by a Python int,
// which PyTorch's CUDA division takes as a multiply by the correctly
// rounded reciprocal)
__device__ V3 sky_dir(const ShadeArgs& a, const FrameConsts& k, int row,
                      int col) {
  const float v = pmul(padd((float)(row + a.row_offset), 0.5f),
                       pdiv(1.0f, (float)a.full_height));
  const float u = pmul(padd((float)col, 0.5f), pdiv(1.0f, (float)a.sky_w));
  return sky_ray(k, u, v);
}

__device__ __forceinline__ QuadIndex env_index(const ShadeArgs& a,
                                               const FrameConsts& k, int row,
                                               int col) {
  return quad_index(a.env_off, a.env_size,
                    cube_face_uv(sky_dir(a, k, row, col)));
}

// ---- PCF (calculate_shadow_fast), pinned throughout -------------------------

__constant__ float kPoisson[9][2] = {
    {(float)-0.94201624, (float)-0.39906216},
    {(float)0.94558609, (float)-0.76890725},
    {(float)-0.094184101, (float)-0.92938870},
    {(float)0.34495938, (float)0.29387760},
    {(float)-0.91588581, (float)0.45771432},
    {(float)-0.81544232, (float)-0.87912464},
    {(float)-0.38277543, (float)0.27676845},
    {(float)0.97484398, (float)0.75648379},
    {(float)0.44323325, (float)-0.97511554},
};

__device__ __forceinline__ float select3(int k, float v0, float v1, float v2) {
  return k == 0 ? v0 : (k == 1 ? v1 : v2);
}

// a * (1 - f) + b * f
__device__ __forceinline__ float plerp(float a, float b, float f) {
  return padd(pmul(a, psub(1.0f, f)), pmul(b, f));
}

// (dy, dx): the pixel whose debug output takes the window's anchor, or
// dy < 0 (an even-grid sample)
__device__ float shadow_fast(const ShadeArgs& a, const FrameConsts& k, V3 p,
                             int dy, int dx) {
  const float* m = k.light_pv;
  float lp[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // [p, 1] @ light_pv.t(): the matrix product's multiply-add chain
    float acc = pmul(p.x, m[4 * r]);
    acc = fmaf(p.y, m[4 * r + 1], acc);
    acc = fmaf(p.z, m[4 * r + 2], acc);
    lp[r] = fmaf(1.0f, m[4 * r + 3], acc);
  }
  const float wc = fabsf(lp[3]) > (float)1e-20 ? lp[3] : 1.0f;
  const float px = pdiv(lp[0], wc), py = pdiv(lp[1], wc),
              pz = pdiv(lp[2], wc);
  const float uvx = padd(pmul(px, 0.5f), 0.5f);
  const float uvy = padd(pmul(py, 0.5f), 0.5f);
  const bool beyond_far = pz > 1.0f;
  const float current = psub(pz, (float)0.000005);

  const int s = a.shadow_size;
  const float sf = (float)s;
  const float hi = (float)(s - 3);
  const float xf = clampf(psub(pmul(uvx, sf), 0.5f), 1.0f, hi);
  const float yf = clampf(psub(pmul(uvy, sf), 0.5f), 1.0f, hi);
  const float x0 = floorf(xf);
  const float y0 = floorf(yf);
  const float ax = psub(xf, x0);
  const float ay = psub(yf, y0);
  const int x0i = (int)x0;
  const int y0i = (int)y0;
  if (dy >= 0) {
    debug_choice(a, dy, dx, kDbgPcfAnchor,
                 ((y0i & 0xFFFF) << 16) | (x0i & 0xFFFF));
  }

  float win[4][4];
  if (a.pcf_layout == kPcfF32Wide) {
    const float* rows = (const float*)a.pcf_rows;
    const float* top = rows + (size_t)((y0i - 1) * s + (x0i - 1)) * 8;
    const float* bot = rows + (size_t)((y0i + 1) * s + (x0i - 1)) * 8;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      win[0][c] = top[c];
      win[1][c] = top[4 + c];
      win[2][c] = bot[c];
      win[3][c] = bot[4 + c];
    }
  } else {
    const int xa = x0i - 1, ya = y0i - 1;
    const bool half = a.pcf_layout == kPcfU16Half;
    const int idx = half ? (ya >> 1) * (s / 2) + (xa >> 1) : ya * s + xa;
    const int* q = (const int*)a.pcf_rows + (size_t)idx * 8;
    int words[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) words[i] = q[i];
    float phys[4][4];
    const float inv = (float)(1.0 / 65535.0);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned wv = (unsigned)words[(r * 4 + c) / 2];
        phys[r][c] = pmul((float)((wv >> (16 * (c & 1))) & 0xFFFFu), inv);
      }
    }
    // the half anchor: logical texel (r, c) lives at physical (r + ry,
    // c + rx), clamped to the window
    const int ry = half ? (ya & 1) : 0;
    const int rx = half ? (xa & 1) : 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r1 = min(r + 1, 3), c1 = min(c + 1, 3);
        const float lo = rx == 0 ? phys[r][c] : phys[r][c1];
        const float hi2 = rx == 0 ? phys[r1][c] : phys[r1][c1];
        win[r][c] = ry == 0 ? lo : hi2;
      }
    }
  }

  float shadow = 0.0f;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    const float sx = padd(ax, kPoisson[t][0]);
    const float sy = padd(ay, kPoisson[t][1]);
    const float kx = floorf(sx);
    const float ky = floorf(sy);
    const float fx = psub(sx, kx);
    const float fy = psub(sy, ky);
    const int cx = (int)kx + 1;
    const int cy = (int)ky + 1;
    float rows[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float left = select3(cx, win[r][0], win[r][1], win[r][2]);
      const float right = select3(cx, win[r][1], win[r][2], win[r][3]);
      rows[r] = plerp(left, right, fx);
    }
    const float top = select3(cy, rows[0], rows[1], rows[2]);
    const float bot = select3(cy, rows[1], rows[2], rows[3]);
    const float closest = plerp(top, bot, fy);
    shadow = padd(shadow, current > closest ? 1.0f : 0.0f);
  }
  shadow = pdiv(shadow, 9.0f);
  const float result = padd(pmul(psub(1.0f, shadow), 0.75f), 0.25f);
  return beyond_far ? 1.0f : result;
}

// ---- the tile's even-grid samples in shared memory --------------------------

struct Tile {
  float c0[kEvenH * kEvenW * 3];  // mirror / sky tap
  float c1[kEvenH * kEvenW * 3];  // parent-mip tap
  float pcf[kEvenH * kEvenW];     // PCF factor on the divisor's grid
  uint8_t sky[kEvenH * kEvenW];   // depth >= 1
};

// Where a block's even-grid (and PCF-grid) samples start, and the width of
// its rows in shared memory.
struct TileGrid {
  int i0, j0, ew;  // the even grid
  int qi0, qj0, qw;  // the PCF grid at divisor 4
};

__device__ __forceinline__ TileGrid tile_grid(const ShadeArgs& a, int y0,
                                              int x0) {
  TileGrid g;
  g.i0 = y0 / 2;
  g.j0 = a.cb ? x0 : x0 / 2;
  g.ew = a.cb ? kEvenW : kTileW / 2 + 1;
  g.qi0 = y0 / 4;
  g.qj0 = a.cb ? x0 / 2 : x0 / 4;
  g.qw = a.cb ? kTileW / 2 + 1 : kTileW / 4 + 1;
  return g;
}

__device__ __forceinline__ void store3(float* p, V3 v) {
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

// Even-grid sample (i, j), slot ``e`` of the tile: the mirror/sky tap, the
// sky flag, the parent tap and, at divisor 2, the PCF factor; written to
// the debug planes too when ``own`` (the block's own samples, not its halo).
__device__ void even_sample(const ShadeArgs& a, const FrameConsts& k,
                            Tile& t, int e, int i, int j, bool own) {
  const int y = 2 * i;
  const int x = a.cb ? j : 2 * j;
  const size_t gi = (size_t)i * a.wh + j;
  const V3 pos = plane3(a, 0, y, x);
  if (a.has_ibl && (a.mirror_half || a.parent_half)) {
    const V3 n = plane3(a, 1, y, x);
    const int nl = a.num_levels;
    const int l0 = mip_level(plane_c(a, 4, y, x, 1), nl);
    const FaceUV fc = cube_face_uv(reflection_dir(pos, n, load3(k.eye)));
    bool c1_done = false;
    int row0 = -1, row1 = -1;
    if (a.mirror_half) {
      QuadIndex q = mip_quad_index(k, l0, fc);
      const bool sky = depth_at(a, y, x) >= 1.0f;
      if (sky) {
        const QuadIndex en = env_index(a, k, y, 2 * j);
        q.idx = en.idx;
        q.fx = en.fx;
        q.fy = en.fy;
      }
      V3 c0;
      row0 = q.idx;
      if (a.merged) {
        const int* row = a.merged_rows + (size_t)q.idx * 8;
        c0 = quad_lerp_rgbe(row, q.fx, q.fy);
        // the parent's fractions from the child anchor's parity (the sky
        // samples' parent lanes are garbage, masked out through f)
        const bool last = l0 >= nl - 1;
        const float fpx = last ? q.fx : ((float)(q.x0 & 1) + q.fx) * 0.5f;
        const float fpy = last ? q.fy : ((float)(q.y0 & 1) + q.fy) * 0.5f;
        const V3 c1 = quad_lerp_rgbe(row + 4, fpx, fpy);
        store3(t.c1 + 3 * e, c1);
        if (own && a.c1h != nullptr) store3(a.c1h + gi * 3, c1);
        row1 = q.idx;
        c1_done = true;
      } else {
        c0 = quad_lerp_rgbe(a.spec_rows + (size_t)q.idx * 4, q.fx, q.fy);
      }
      store3(t.c0 + 3 * e, c0);
      t.sky[e] = sky ? 1 : 0;
      if (own && a.c0h != nullptr) {
        store3(a.c0h + gi * 3, c0);
        a.skyh[gi] = sky ? 1 : 0;
      }
    }
    if (a.parent_half && !c1_done) {
      const int l1 = min(l0 + 1, nl - 1);
      const QuadIndex q = mip_quad_index(k, l1, fc);
      const V3 c1 = quad_lerp_rgbe(a.spec_rows + (size_t)q.idx * 4, q.fx, q.fy);
      store3(t.c1 + 3 * e, c1);
      if (own && a.c1h != nullptr) store3(a.c1h + gi * 3, c1);
      row1 = q.idx;
    }
    if (own && a.rows_h != nullptr) {
      a.rows_h[2 * gi] = row0;
      a.rows_h[2 * gi + 1] = row1;
    }
  }
  if (a.pcf_layout != kPcfNone && a.pcf_div == 2) {
    const float f = shadow_fast(a, k, pos, -1, 0);
    t.pcf[e] = f;
    if (own && a.pcf != nullptr) a.pcf[gi] = f;
  }
}

// ---- upsamples (_upsample_pow2, _upsample_to_cb, _mask_aware) ---------------

// _upsample_pow2 of a grid of (ha, wa) samples, C channels, held in shared
// memory from sample (ti0, tj0) in rows of ``tw``, at output (y, x): rows
// by fy, then columns by fx; each output is a[i]*(1 - k/f) + a[i+1]*(k/f)
// per axis, the last sample repeated.  Where the column weight k/f is 0
// the output is the left sample itself (v0 * 1 + v1 * 0), so the right one
// is not read: at a checkerboard tile's last odd-row pixel it lies past the
// tile.
template <int C>
__device__ void up_pow2(const float* t, int tw, int ti0, int tj0, int ha,
                        int wa, int y, int x, int fy, int fx, float* out) {
  const int i = y / fy, ky = y - i * fy;
  const int j = x / fx, kx = x - j * fx;
  const int i1 = min(i + 1, ha - 1), j1 = min(j + 1, wa - 1);
  // k / f for f in {1, 2, 4}, exactly
  const float wy1 = (float)ky * (fy == 4 ? 0.25f : 0.5f), wy0 = 1.0f - wy1;
  const float wx1 = (float)kx * (fx == 4 ? 0.25f : 0.5f), wx0 = 1.0f - wx1;
  const int r0 = (i - ti0) * tw, r1 = (i1 - ti0) * tw;
  const int c0 = j - tj0, c1 = j1 - tj0;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float v0 = fy == 1 ? t[(r0 + c0) * C + c]
                             : t[(r0 + c0) * C + c] * wy0 +
                                   t[(r1 + c0) * C + c] * wy1;
    if (kx == 0) {
      out[c] = v0;
    } else {
      const float v1 = fy == 1 ? t[(r0 + c1) * C + c]
                               : t[(r0 + c1) * C + c] * wy0 +
                                     t[(r1 + c1) * C + c] * wy1;
      out[c] = v0 * wx0 + v1 * wx1;
    }
  }
}

// the upsample of a grid's samples to the shading domain: _upsample_to_cb
// with (fy, fxc) on the checkerboard domain (odd rows average the right
// neighbour, clamped at the domain's last column), else _upsample_pow2
template <int C>
__device__ void upsample(const ShadeArgs& a, const float* t, int tw, int ti0,
                         int tj0, int ha, int wa, int y, int x, int fy,
                         int fx, float* out) {
  if (!a.cb) {
    up_pow2<C>(t, tw, ti0, tj0, ha, wa, y, x, fy, fx, out);
    return;
  }
  up_pow2<C>(t, tw, ti0, tj0, ha, wa, y, x, fy, fx / 2, out);
  if (y & 1) {
    float r[C];
    up_pow2<C>(t, tw, ti0, tj0, ha, wa, y, min(x + 1, a.w - 1), fy, fx / 2,
               r);
#pragma unroll
    for (int c = 0; c < C; ++c) out[c] = (out[c] + r[c]) * 0.5f;
  }
}

// the mirror tap: the bilinear upsample of c0, except where its four
// samples straddle the sky silhouette: there the first of the phases
// (0,0), (0,1), (1,0), (1,1) whose sky flag matches the pixel's (the
// sample taken: a debug choice)
__device__ V3 mirror_tap(const ShadeArgs& a, const Tile& t,
                         const TileGrid& g, int y, int x, bool sky) {
  float up[3];
  upsample<3>(a, t.c0, g.ew, g.i0, g.j0, a.hh, a.wh, y, x, 2, 2, up);
  const int i = y >> 1;
  const int j = a.cb ? x : (x >> 1);
  int e[4];
  bool m[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int si = min(i + (p >> 1), a.hh - 1);
    const int sj = min(j + (p & 1), a.wh - 1);
    e[p] = (si - g.i0) * g.ew + (sj - g.j0);
    m[p] = t.sky[e[p]] != 0;
  }
  const bool uniform = (m[0] == m[1]) && (m[0] == m[2]) && (m[0] == m[3]);
  if (!uniform) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      if (m[p] == sky) {
        debug_choice(a, y, x, kDbgMirrorPick,
                     min(i + (p >> 1), a.hh - 1) * a.wh +
                         min(j + (p & 1), a.wh - 1));
        return load3(t.c0 + 3 * e[p]);
      }
    }
  }
  return v3(up[0], up[1], up[2]);
}

// ---- the pixel -------------------------------------------------------------

__device__ __forceinline__ void store_clamped(const ShadeArgs& a, int y,
                                              int x, V3 col) {
  float* o = a.out + ((size_t)y * a.w + x) * 3;
  o[0] = clampf(col.x, 0.0f, 1.0f);
  o[1] = clampf(col.y, 0.0f, 1.0f);
  o[2] = clampf(col.z, 0.0f, 1.0f);
}

// the sky pixel's colour: the mirror tap, which sky samples point at the
// environment
__device__ V3 sky_tap(const ShadeArgs& a, const FrameConsts& k,
                      const Tile& t, const TileGrid& g, int y, int x) {
  if (a.mirror_half) return mirror_tap(a, t, g, y, x, true);
  const QuadIndex e = env_index(a, k, y, x);
  debug_choice(a, y, x, kDbgMirrorRow, e.idx);
  return quad_lerp_rgbe(a.spec_rows + (size_t)e.idx * 4, e.fx, e.fy);
}

// The G-buffer of pixel (y, x) that the lights read, V and F0, as
// shade_pixel computes them (a streamed table's lights sum before it).
__device__ __forceinline__ Surface surface_at(const ShadeArgs& a,
                                              const FrameConsts& k, int y,
                                              int x) {
  Surface s;
  s.pos = plane3(a, 0, y, x);
  s.n = plane3(a, 1, y, x);
  s.base = plane3(a, 2, y, x);
  const V3 orm = plane3(a, 4, y, x);
  s.rough = orm.y;
  s.metallic = orm.z;
  s.v = normalize_eps(sub(load3(k.eye), s.pos));
  s.f0 = fresnel_f0(s.base, s.metallic);
  return s;
}

// Pixel (y, x) of the tile.  kStreamed: its lights' sum is ``streamed``
// (shade_lights); otherwise the whole light table is in ``lights``.
template <bool kStreamed>
__device__ void shade_pixel(const ShadeArgs& a, const FrameConsts& k,
                            const float* lights, const Tile& t,
                            const TileGrid& g, int y, int x, V3 streamed) {
#pragma unroll
  for (int c = 0; c < kDbgChannels; ++c) debug_choice(a, y, x, c, -1);
  const float depth = depth_at(a, y, x);
  if (a.has_ibl && depth >= 1.0f) {
    // the frame keeps the sky colour here (the plain version's
    // where(sky_mask, sky, ...)): the lights and the ambient it computes
    // at a sky pixel are discarded, so they are not evaluated
    store_clamped(a, y, x, sky_tap(a, k, t, g, y, x));
    return;
  }
  const V3 pos = plane3(a, 0, y, x);
  const V3 nrm = plane3(a, 1, y, x);
  const V3 base = plane3(a, 2, y, x);
  const V3 emis = plane3(a, 3, y, x);
  const V3 orm = plane3(a, 4, y, x);
  const float occlusion = orm.x, rough = orm.y, metallic = orm.z;
  const float ao = a.ssao[y * a.ssao_strides[0] + x * a.ssao_strides[1]];
  const V3 eye = load3(k.eye);

  const V3 v = normalize_eps(sub(eye, pos));
  const V3 f0 = fresnel_f0(base, metallic);

  // shade_lights: summed in light order from zero
  V3 lo = v3(0.0f, 0.0f, 0.0f);
  if constexpr (kStreamed) {
    lo = streamed;
  } else {
    for (int l = 0; l < a.n_lights; ++l) {
      lo = add(lo, surface_shading(pos, base, nrm, metallic, rough, v, f0,
                                   lights + l * kLightCols));
    }
  }

  float shadow = 1.0f;
  if (a.pcf_layout != kPcfNone) {
    if (a.pcf_div == 1) {
      shadow = shadow_fast(a, k, pos, y, x);
      if (a.pcf != nullptr) a.pcf[(size_t)y * a.w + x] = shadow;
    } else if (a.pcf_div == 2) {
      upsample<1>(a, t.pcf, g.ew, g.i0, g.j0, a.hq, a.wq, y, x, 2, 2,
                  &shadow);
    } else {
      upsample<1>(a, t.pcf, g.qw, g.qi0, g.qj0, a.hq, a.wq, y, x, 4, 4,
                  &shadow);
    }
  }

  V3 ambient = v3(0.0f, 0.0f, 0.0f);
  if (a.has_ibl) {  // not a sky pixel
    const int nl = a.num_levels;
    const float lod = clampf(pmul(rough, 7.0f), 0.0f, (float)(nl - 1));
    const float l0f = floorf(lod);
    const int l0 = (int)l0f;
    const float f = lod - l0f;
    FaceUV fc;
    if (!a.mirror_half || !a.parent_half) {
      fc = cube_face_uv(reflection_dir(pos, nrm, eye));
    }
    V3 c0, c1;
    if (a.mirror_half) {
      c0 = mirror_tap(a, t, g, y, x, false);
    } else {
      const QuadIndex q = mip_quad_index(k, l0, fc);
      debug_choice(a, y, x, kDbgMirrorRow, q.idx);
      c0 = quad_lerp_rgbe(a.spec_rows + (size_t)q.idx * 4, q.fx, q.fy);
    }
    if (a.parent_half) {
      float u[3];
      upsample<3>(a, t.c1, g.ew, g.i0, g.j0, a.hh, a.wh, y, x, 2, 2, u);
      c1 = v3(u[0], u[1], u[2]);
    } else {
      const QuadIndex q = mip_quad_index(k, min(l0 + 1, nl - 1), fc);
      debug_choice(a, y, x, kDbgParentRow, q.idx);
      c1 = quad_lerp_rgbe(a.spec_rows + (size_t)q.idx * 4, q.fx, q.fy);
    }
    // prefiltered = c0 * (1 - f) + c1 * f
    const V3 pref = add(scale(c0, 1.0f - f), scale(c1, f));
    const V3 irr = sh9_eval(k.sh9, nrm);
    // _ambient / image_based_lighting
    const float ndotv = maxf(dot3(nrm, v), 0.0f);
    float lut0, lut1;
    env_brdf_poly(ndotv, rough, &lut0, &lut1);
    ambient = split_sum(base, f0, ndotv, rough, metallic, occlusion, irr,
                        pref, lut0, lut1);
  }

  // (ambient + lo * shadow) * ssao + emissive, tonemap_unreal, clamp
  const V3 col = combine_tonemap(ambient, lo, shadow, ao, emis);
  store_clamped(a, y, x, col);
}

// ---- the kernel --------------------------------------------------------------

// kStreamed: a light table of more than kLightChunkRows rows, which
// streams through the shared memory a chunk at a time after step 2;
// otherwise the table is loaded whole in step 1.
template <bool kStreamed>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    shade_kernel(const ShadeArgs a) {
  __shared__ FrameConsts k;
  __shared__ Tile t;
  extern __shared__ float lights[];  // the light rows, or a chunk of them
  const int tid = threadIdx.x;

  // 1. the per-frame constants
  if (!kStreamed) {
    load_lights(lights, a.lights, a.n_lights, a.light_stride, tid, kThreads);
  }
  if (tid < 3) {
    k.eye[tid] = a.eye[tid];
    k.right[tid] = a.right[tid];
    k.up[tid] = a.up[tid];
    k.direction[tid] = a.direction[tid];
  }
  if (tid < 16) k.light_pv[tid] = a.light_pv[tid];
  if (tid < 2) k.near_wh[tid] = a.near_wh[tid];
  if (tid == 0) k.near_ = a.near_[0];
  if (a.has_ibl) {
    if (tid < 27) k.sh9[tid] = a.sh9[tid];
    if (tid < a.num_levels) {
      k.sizes[tid] = a.sizes[tid];
      k.offsets[tid] = a.offsets[tid];
    }
  }
  __syncthreads();

  // 2. the even-grid samples of the tile and its halo, then (divisor 4)
  // the PCF grid's
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;
  const TileGrid g = tile_grid(a, y0, x0);
  const bool taps = a.has_ibl && (a.mirror_half || a.parent_half);
  const bool pcf = a.pcf_layout != kPcfNone;
  const int n_even = (taps || (pcf && a.pcf_div == 2)) ? kEvenH * g.ew : 0;
  const int n_quad = (pcf && a.pcf_div == 4) ? (kTileH / 4 + 1) * g.qw : 0;
  // the PCF grid's samples start on a warp of their own: no warp runs both
  const int q0 = (n_even + 31) & ~31;
  for (int s = tid; s < q0 + n_quad; s += kThreads) {
    if (s < n_even) {
      const int ti = s / g.ew, tj = s - ti * g.ew;
      const int i = g.i0 + ti, j = g.j0 + tj;
      if (i < a.hh && j < a.wh) {
        even_sample(a, k, t, s, i, j, ti < kEvenH - 1 && tj < g.ew - 1);
      }
    } else if (s >= q0) {
      const int q = s - q0;
      const int ti = q / g.qw, tj = q - ti * g.qw;
      const int i = g.qi0 + ti, j = g.qj0 + tj;
      if (i < a.hq && j < a.wq) {
        const float f =
            shadow_fast(a, k, plane3(a, 0, 4 * i, a.cb ? 2 * j : 4 * j),
                        -1, 0);
        t.pcf[q] = f;
        if (a.pcf != nullptr && ti < kTileH / 4 && tj < g.qw - 1) {
          a.pcf[(size_t)i * a.wq + j] = f;
        }
      }
    }
  }
  __syncthreads();

  // 3. the tile's pixels; a streamed table's lights first, with every
  // thread of the block (shade_lights)
  const int y = y0 + tid / kTileW;
  const int x = x0 + tid % kTileW;
  V3 lo = v3(0.0f, 0.0f, 0.0f);
  if constexpr (kStreamed) {
    const bool lit = y < a.h && x < a.w &&
                     !(a.has_ibl && depth_at(a, y, x) >= 1.0f);
    Surface s = {};
    if (lit) s = surface_at(a, k, y, x);
    lo = shade_lights<kThreads>(lights, a.lights, a.n_lights, a.light_stride,
                                tid, lit, s);
  }
  if (y < a.h && x < a.w) {
    shade_pixel<kStreamed>(a, k, lights, t, g, y, x, lo);
  }
}

// The instance for ``n_lights`` rows, with its opt-in to the shared memory
// past 48 KB a block where the rows need it (the static tile and constants
// with a whole chunk of rows).
template <bool kStreamed>
cudaError_t launch(const ShadeArgs& a, size_t light_bytes, cudaStream_t s) {
  if (light_bytes + sizeof(FrameConsts) + sizeof(Tile) > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        shade_kernel<kStreamed>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)light_bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.w + kTileW - 1) / kTileW, (a.h + kTileH - 1) / kTileH);
  shade_kernel<kStreamed><<<grid, kThreads, light_bytes, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One launch over the shading domain on ``stream``; returns
// cudaGetLastError() after it, or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int mo_shading(const ShadeArgs* args, void* stream) {
  if (args->has_ibl && args->num_levels > kMaxLevels) {
    return (int)cudaErrorInvalidValue;
  }
  if (args->h <= 0 || args->w <= 0) return (int)cudaGetLastError();
  const bool streamed = args->n_lights > kLightChunkRows;
  const size_t light_bytes =
      (size_t)(streamed ? kLightChunkRows : args->n_lights) * kLightCols *
      sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(streamed ? launch<true>(*args, light_bytes, s)
                        : launch<false>(*args, light_bytes, s));
}

// sizeof(ShadeArgs), for the wrapper's check of its ctypes layout
extern "C" int mo_shading_args_size() { return (int)sizeof(ShadeArgs); }
