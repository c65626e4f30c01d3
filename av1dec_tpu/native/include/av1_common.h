// av1dec_tpu native front-half — common constants and structures.
//
// Constants and struct fields mirror the AV1 Bitstream & Decoding Process
// Specification (cited as [SPEC §x.y]).  This is the host-side half of the
// decoder: everything here feeds the entropy decode layer whose output is
// dense "plan" tensors consumed by the JAX pixel pipeline.
#pragma once

#include <cstdint>
#include <cstring>
#include <vector>

namespace av1 {

// ---- OBU types [SPEC §5.3.1] ----
enum ObuType : int {
  OBU_SEQUENCE_HEADER = 1,
  OBU_TEMPORAL_DELIMITER = 2,
  OBU_FRAME_HEADER = 3,
  OBU_TILE_GROUP = 4,
  OBU_METADATA = 5,
  OBU_FRAME = 6,
  OBU_REDUNDANT_FRAME_HEADER = 7,
  OBU_TILE_LIST = 8,
  OBU_PADDING = 15,
};

// ---- Frame types [SPEC §6.8.2] ----
enum FrameType : int {
  KEY_FRAME = 0,
  INTER_FRAME = 1,
  INTRA_ONLY_FRAME = 2,
  SWITCH_FRAME = 3,
};

// ---- Limits [SPEC §3, Annex A] ----
constexpr int NUM_REF_FRAMES = 8;
constexpr int REFS_PER_FRAME = 7;
constexpr int TOTAL_REFS_PER_FRAME = 8;  // incl. INTRA_FRAME
constexpr int MAX_TILE_COLS = 64;
constexpr int MAX_TILE_ROWS = 64;
constexpr int MAX_TILE_AREA = 4096 * 2304;
constexpr int MAX_TILE_WIDTH = 4096;
constexpr int MAX_SEGMENTS = 8;
constexpr int SEG_LVL_MAX = 8;
constexpr int PRIMARY_REF_NONE = 7;
constexpr int SUPERRES_NUM = 8;
constexpr int SUPERRES_DENOM_MIN = 9;
constexpr int SUPERRES_DENOM_BITS = 3;
constexpr int MAX_LOOP_FILTER = 63;
constexpr int WARPEDMODEL_PREC_BITS = 16;
constexpr int GM_ABS_ALPHA_BITS = 12;
constexpr int GM_ALPHA_PREC_BITS = 15;
constexpr int GM_ABS_TRANS_ONLY_BITS = 9;
constexpr int GM_TRANS_ONLY_PREC_BITS = 3;
constexpr int GM_ABS_TRANS_BITS = 12;
constexpr int GM_TRANS_PREC_BITS = 6;
constexpr int SELECT_SCREEN_CONTENT_TOOLS = 2;
constexpr int SELECT_INTEGER_MV = 2;

// Reference slots as signalled in the frame header [SPEC §6.10.24]
enum RefFrame : int {
  NONE_FRAME = -1,
  INTRA_FRAME = 0,
  LAST_FRAME = 1,
  LAST2_FRAME = 2,
  LAST3_FRAME = 3,
  GOLDEN_FRAME = 4,
  BWDREF_FRAME = 5,
  ALTREF2_FRAME = 6,
  ALTREF_FRAME = 7,
};

// ---- Global motion types [SPEC §5.9.24] ----
enum GmType : int {
  IDENTITY = 0,
  TRANSLATION = 1,
  ROTZOOM = 2,
  AFFINE = 3,
};

// ---- Interpolation filters [SPEC §6.8.9] ----
enum InterpFilter : int {
  EIGHTTAP = 0,
  EIGHTTAP_SMOOTH = 1,
  EIGHTTAP_SHARP = 2,
  BILINEAR = 3,
  SWITCHABLE = 4,
};

// ---- TX modes [SPEC §6.8.21] ----
enum TxMode : int { ONLY_4X4 = 0, TX_MODE_LARGEST = 1, TX_MODE_SELECT = 2 };

// ---- Color [SPEC §6.4.2] ----
constexpr int CP_UNSPECIFIED = 2;
constexpr int TC_UNSPECIFIED = 2;
constexpr int MC_UNSPECIFIED = 2;
constexpr int MC_IDENTITY = 0;
constexpr int CSP_UNKNOWN = 0;

struct OperatingPoint {
  int idc = 0;
  int seq_level_idx = 0;
  int seq_tier = 0;
  int decoder_model_present = 0;
  int initial_display_delay = 10;
};

// ---- Sequence header [SPEC §5.5] ----
struct SequenceHeader {
  int valid = 0;
  int seq_profile = 0;
  int still_picture = 0;
  int reduced_still_picture_header = 0;
  int timing_info_present = 0;
  int decoder_model_info_present = 0;
  int initial_display_delay_present = 0;
  int operating_points_cnt = 1;
  OperatingPoint op[32];
  // decoder model info (parsed, retained for conformance)
  int buffer_delay_length = 0;
  uint32_t num_units_in_decoding_tick = 0;
  int buffer_removal_time_length = 0;
  int frame_presentation_time_length = 0;
  // timing info
  uint32_t num_units_in_display_tick = 0, time_scale = 0;
  int equal_picture_interval = 0;
  uint32_t num_ticks_per_picture = 0;

  int frame_width_bits = 0, frame_height_bits = 0;
  int max_frame_width = 0, max_frame_height = 0;
  int frame_id_numbers_present = 0;
  int delta_frame_id_length = 0, additional_frame_id_length = 0;
  int use_128x128_superblock = 0;
  int enable_filter_intra = 0;
  int enable_intra_edge_filter = 0;
  int enable_interintra_compound = 0;
  int enable_masked_compound = 0;
  int enable_warped_motion = 0;
  int enable_dual_filter = 0;
  int enable_order_hint = 0;
  int enable_jnt_comp = 0;
  int enable_ref_frame_mvs = 0;
  int seq_force_screen_content_tools = 0;
  int seq_force_integer_mv = 0;
  int order_hint_bits = 0;  // OrderHintBits
  int enable_superres = 0;
  int enable_cdef = 0;
  int enable_restoration = 0;
  // color config [SPEC §5.5.2]
  int bit_depth = 8;
  int mono_chrome = 0;
  int color_primaries = CP_UNSPECIFIED;
  int transfer_characteristics = TC_UNSPECIFIED;
  int matrix_coefficients = MC_UNSPECIFIED;
  int color_range = 0;
  int subsampling_x = 1, subsampling_y = 1;
  int chroma_sample_position = CSP_UNKNOWN;
  int separate_uv_delta_q = 0;
  int film_grain_params_present = 0;

  int num_planes() const { return mono_chrome ? 1 : 3; }
  int sb_size_log2() const { return use_128x128_superblock ? 7 : 6; }
};

// ---- Loop filter params [SPEC §5.9.11] ----
struct LoopFilterParams {
  int level[4] = {0, 0, 0, 0};  // [y_vert, y_horz, u, v]
  int sharpness = 0;
  int delta_enabled = 0;
  int delta_update = 0;
  int ref_deltas[TOTAL_REFS_PER_FRAME] = {1, 0, 0, 0, -1, 0, -1, -1};
  int mode_deltas[2] = {0, 0};
};

// ---- Quantization params [SPEC §5.9.12] ----
struct QuantizationParams {
  int base_q_idx = 0;
  int delta_q_y_dc = 0;
  int delta_q_u_dc = 0, delta_q_u_ac = 0;
  int delta_q_v_dc = 0, delta_q_v_ac = 0;
  int using_qmatrix = 0;
  int qm_y = 0, qm_u = 0, qm_v = 0;
};

// ---- Segmentation [SPEC §5.9.13] ----
struct SegmentationParams {
  int enabled = 0;
  int update_map = 0;
  int temporal_update = 0;
  int update_data = 0;
  int feature_enabled[MAX_SEGMENTS][SEG_LVL_MAX] = {};
  int feature_data[MAX_SEGMENTS][SEG_LVL_MAX] = {};
  int last_active_seg_id = 0;  // SegIdPreSkip..: computed
  int seg_id_pre_skip = 0;
};

// ---- CDEF params [SPEC §5.9.19] ----
struct CdefParams {
  int damping = 3;     // cdef_damping_minus_3 + 3
  int bits = 0;        // cdef_bits
  int y_pri[8] = {};   // strengths: primary/secondary split applied later
  int y_sec[8] = {};
  int uv_pri[8] = {};
  int uv_sec[8] = {};
};

// ---- Loop restoration params [SPEC §5.9.20] ----
enum RestorationType : int {
  RESTORE_NONE = 0,
  RESTORE_WIENER = 1,
  RESTORE_SGRPROJ = 2,
  RESTORE_SWITCHABLE = 3,
};
struct LrParams {
  int frame_restoration_type[3] = {RESTORE_NONE, RESTORE_NONE, RESTORE_NONE};
  int loop_restoration_size[3] = {256, 256, 256};  // in pixels (plane units)
  int uses_lr = 0;
};

// ---- Tile info [SPEC §5.9.15] ----
struct TileInfo {
  int uniform_tile_spacing = 1;
  int tile_cols_log2 = 0, tile_rows_log2 = 0;
  int tile_cols = 1, tile_rows = 1;
  // boundaries in superblock units, cumulative (size tile_cols+1 / rows+1)
  int mi_col_starts[MAX_TILE_COLS + 1] = {};
  int mi_row_starts[MAX_TILE_ROWS + 1] = {};
  int context_update_tile_id = 0;
  int tile_size_bytes = 4;  // tile_size_bytes_minus_1 + 1
};

// ---- Film grain [SPEC §5.9.30] ----
struct FilmGrainParams {
  int apply_grain = 0;
  int grain_seed = 0;
  int update_grain = 1;
  int film_grain_params_ref_idx = 0;
  int num_y_points = 0;
  int point_y_value[14] = {}, point_y_scaling[14] = {};
  int chroma_scaling_from_luma = 0;
  int num_cb_points = 0, num_cr_points = 0;
  int point_cb_value[10] = {}, point_cb_scaling[10] = {};
  int point_cr_value[10] = {}, point_cr_scaling[10] = {};
  int grain_scaling = 8;  // grain_scaling_minus_8 + 8
  int ar_coeff_lag = 0;
  int ar_coeffs_y[24] = {};
  int ar_coeffs_cb[25] = {}, ar_coeffs_cr[25] = {};
  int ar_coeff_shift = 6;  // ar_coeff_shift_minus_6 + 6
  int grain_scale_shift = 0;
  int cb_mult = 0, cb_luma_mult = 0, cb_offset = 0;
  int cr_mult = 0, cr_luma_mult = 0, cr_offset = 0;
  int overlap_flag = 0;
  int clip_to_restricted_range = 0;
};

// ---- Global motion [SPEC §5.9.24] ----
struct GlobalMotionParams {
  int gm_type[NUM_REF_FRAMES] = {};             // per LAST..ALTREF (index 1..7)
  int32_t gm_params[NUM_REF_FRAMES][6] = {};    // warp model parameters
  int gm_invalid[NUM_REF_FRAMES] = {};
};

// ---- Frame header [SPEC §5.9] ----
struct FrameHeader {
  int show_existing_frame = 0;
  int frame_to_show_map_idx = 0;
  int frame_type = KEY_FRAME;
  int show_frame = 1;
  int showable_frame = 0;
  int error_resilient_mode = 0;
  int disable_cdf_update = 0;
  int allow_screen_content_tools = 0;
  int force_integer_mv = 0;
  int current_frame_id = 0;
  int frame_size_override = 0;
  int order_hint = 0;
  int primary_ref_frame = PRIMARY_REF_NONE;
  int refresh_frame_flags = 0xFF;
  int ref_order_hint[NUM_REF_FRAMES] = {};
  int allow_intrabc = 0;
  int frame_refs_short_signaling = 0;
  int ref_frame_idx[REFS_PER_FRAME] = {};       // for LAST..ALTREF
  int delta_frame_id[REFS_PER_FRAME] = {};
  int allow_high_precision_mv = 0;
  int interpolation_filter = EIGHTTAP;
  int is_motion_mode_switchable = 0;
  int use_ref_frame_mvs = 0;
  int disable_frame_end_update_cdf = 0;
  int allow_warped_motion = 0;
  int reduced_tx_set = 0;
  int tx_mode = ONLY_4X4;
  int reference_select = 0;  // frame_reference_mode: 0=single, 1=select
  int skip_mode_present = 0;
  int skip_mode_frame[2] = {0, 0};

  // frame size [SPEC §5.9.5-5.9.8]
  int frame_width = 0, frame_height = 0;        // after superres (upscaled)
  int upscaled_width = 0;
  int render_width = 0, render_height = 0;
  int use_superres = 0;
  int superres_denom = SUPERRES_NUM;
  // derived
  int mi_cols = 0, mi_rows = 0;                 // 4x4 units

  // sub-structs
  LoopFilterParams lf;
  QuantizationParams quant;
  SegmentationParams seg;
  TileInfo tiles;
  CdefParams cdef;
  LrParams lr;
  FilmGrainParams grain;
  GlobalMotionParams gm;

  // delta q / delta lf [SPEC §5.9.17-5.9.18]
  int delta_q_present = 0, delta_q_res = 0;
  int delta_lf_present = 0, delta_lf_res = 0, delta_lf_multi = 0;

  // derived flags
  int coded_lossless = 0;   // all segments lossless [SPEC §5.9.12]
  int all_lossless = 0;     // coded_lossless && no superres
  int lossless[MAX_SEGMENTS] = {};
  int cur_frame_force_integer_mv = 0;
  // refresh bookkeeping
  int frame_is_intra = 1;
  // per-frame buffer removal (decoder model); parsed and dropped
};

static inline int tile_log2(int blk_size, int target) {
  int k = 0;
  while ((blk_size << k) < target) k++;
  return k;
}

}  // namespace av1
