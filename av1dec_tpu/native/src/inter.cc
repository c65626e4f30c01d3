// Inter-frame mode info, reference-frame and motion-vector syntax.
// [SPEC §5.11.15-5.11.33, §7.10 motion vector prediction]
//
// This is the inter half of the entropy layer: it decodes all inter
// block syntax (segment prediction, ref frames, the MV prediction stack
// with DRL, interpolation filters, motion modes, compound types and
// local-warp estimation) and writes the results into the plan tensors
// consumed by the JAX pixel pipeline.
#include <algorithm>
#include <cstdlib>
#include <cstring>

#include "tables.h"
#include "tile_decode.h"

namespace av1 {

namespace {

constexpr int MV_BORDER = 128;
constexpr int MAX_REF_MV_STACK_SIZE = 8;
constexpr int REF_MV_WEIGHT_NEAREST = 640;
constexpr int16_t MV_INVALID = INT16_MIN;  // tpl "invalid" marker
constexpr int MAX_FRAME_DISTANCE = 31;

// SEG_LVL feature indices [SPEC §6.8.13]
constexpr int SEG_LVL_REF_FRAME = 5;
constexpr int SEG_LVL_SKIP = 6;
constexpr int SEG_LVL_GLOBALMV = 7;

// Motion modes [SPEC §6.10.25]
enum { SIMPLE_MOTION = 0, OBMC_CAUSAL = 1, WARPED_CAUSAL = 2 };

// our plan encoding for compound type (plans.h)
enum {
  PLAN_COMP_AVG = 0,
  PLAN_COMP_DIST = 1,
  PLAN_COMP_WEDGE = 2,
  PLAN_COMP_DIFFWTD = 3,
};

// Wedge_Bits: block sizes supporting wedge masks [SPEC §9.3]
const uint8_t kWedgeBits[BLOCK_SIZES_ALL] = {
    0, 0, 0, 4, 4, 4, 4, 4, 4, 4, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 0, 0};

inline bool has_newmv(int mode) {
  return mode == NEWMV || mode == NEW_NEWMV || mode == NEAR_NEWMV ||
         mode == NEW_NEARMV || mode == NEAREST_NEWMV ||
         mode == NEW_NEARESTMV;
}

inline bool has_nearmv(int mode) {
  return mode == NEARMV || mode == NEAR_NEARMV || mode == NEAR_NEWMV ||
         mode == NEW_NEARMV;
}

inline bool is_backward_ref(int rf) { return rf >= BWDREF_FRAME; }

// a<b -> 0, a==b -> 1, a>b -> 2  [SPEC ref count context]
inline int cnt_ctx(int a, int b) { return a < b ? 0 : a == b ? 1 : 2; }

inline int round2_signed(int64_t x, int n) {
  int64_t v = x >= 0 ? (x + (1LL << (n - 1))) >> n
                     : -((-x + (1LL << (n - 1))) >> n);
  return (int)v;
}

inline int16_t clip_mv16(int v) {
  return (int16_t)std::clamp(v, -(1 << 14) + 1, (1 << 14) - 1);
}

// division LUT for MV projection [SPEC §7.9.3 Div_Mult]
const int16_t kDivMult[32] = {
    0,    16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638,
    1489, 1365,  1260, 1170, 1092, 1024, 963,  910,  862,  819,  780,
    744,  712,   682,  655,  630,  606,  585,  564,  546,  528};

void mv_projection(int16_t* out, const int16_t* ref, int num, int den) {
  den = std::min(den, MAX_FRAME_DISTANCE);
  num = num > 0 ? std::min(num, MAX_FRAME_DISTANCE)
                : std::max(num, -MAX_FRAME_DISTANCE);
  out[0] = clip_mv16(round2_signed((int64_t)ref[0] * num * kDivMult[den], 14));
  out[1] = clip_mv16(round2_signed((int64_t)ref[1] * num * kDivMult[den], 14));
}

}  // namespace

// ---------------------------------------------------------------------------
// Helpers over frame grids
// ---------------------------------------------------------------------------

bool TileDecoder::is_inside(int mvRow, int mvCol) const {
  return mvCol >= mi_col_start_ && mvCol < mi_col_end_ &&
         mvRow >= mi_row_start_ && mvRow < mi_row_end_;
}

bool TileDecoder::is_decoded(int mvRow, int mvCol) const {
  return ref0_grid_[(size_t)mvRow * mi_cols_ + mvCol] != NONE_FRAME;
}

void TileDecoder::lower_mv_precision(int16_t* mv) const {
  // [SPEC §7.10.2.10]
  for (int i = 0; i < 2; i++) {
    int v = mv[i];
    if (hdr_.cur_frame_force_integer_mv) {
      int a = std::abs(v);
      int aligned = ((a + 3) >> 3) << 3;
      mv[i] = (int16_t)(v > 0 ? aligned : -aligned);
    } else if (v & 1) {
      if (!hdr_.allow_high_precision_mv) mv[i] = (int16_t)(v > 0 ? v - 1 : v + 1);
    }
  }
}

void TileDecoder::setup_global_mv(int refList, int16_t* mv) const {
  // [SPEC §7.10.2.1]
  int ref = ref_frame_[refList];
  int typ = ref == INTRA_FRAME ? IDENTITY : hdr_.gm.gm_type[ref];
  if (ref == INTRA_FRAME || typ == IDENTITY) {
    mv[0] = mv[1] = 0;
  } else if (typ == TRANSLATION) {
    mv[0] = clip_mv16(hdr_.gm.gm_params[ref][0] >> (WARPEDMODEL_PREC_BITS - 3));
    mv[1] = clip_mv16(hdr_.gm.gm_params[ref][1] >> (WARPEDMODEL_PREC_BITS - 3));
  } else {
    int x = mi_col_ * 4 + bw4_ * 2 - 1;
    int y = mi_row_ * 4 + bh4_ * 2 - 1;
    const int32_t* p = hdr_.gm.gm_params[ref];
    int64_t xc = (int64_t)(p[2] - (1 << WARPEDMODEL_PREC_BITS)) * x +
                 (int64_t)p[3] * y + p[0];
    int64_t yc = (int64_t)p[4] * x +
                 (int64_t)(p[5] - (1 << WARPEDMODEL_PREC_BITS)) * y + p[1];
    if (hdr_.allow_high_precision_mv) {
      mv[0] = clip_mv16(round2_signed(yc, WARPEDMODEL_PREC_BITS - 3));
      mv[1] = clip_mv16(round2_signed(xc, WARPEDMODEL_PREC_BITS - 3));
    } else {
      mv[0] = clip_mv16(round2_signed(yc, WARPEDMODEL_PREC_BITS - 2) * 2);
      mv[1] = clip_mv16(round2_signed(xc, WARPEDMODEL_PREC_BITS - 2) * 2);
    }
  }
  lower_mv_precision(mv);
}

// ---------------------------------------------------------------------------
// Segment id (inter frames) [SPEC §5.11.12-5.11.14]
// ---------------------------------------------------------------------------

int TileDecoder::get_segment_id_pred() const {
  // get_segment_id [SPEC §7.4?]: min of PrevSegmentIds over block extent
  if (!mctx_ || !mctx_->prev_seg_ids) return 0;
  int xMis = std::min(mi_cols_ - mi_col_, bw4_);
  int yMis = std::min(mi_rows_ - mi_row_, bh4_);
  int seg = 7;
  for (int y = 0; y < yMis; y++)
    for (int x = 0; x < xMis; x++)
      seg = std::min(
          seg, (int)mctx_->prev_seg_ids[(size_t)(mi_row_ + y) * mi_cols_ +
                                        (mi_col_ + x)]);
  return seg;
}

void TileDecoder::inter_segment_id(int preSkip) {
  if (!hdr_.seg.enabled) {
    segment_id_ = 0;
    return;
  }
  int predictedSegmentId = get_segment_id_pred();
  if (!hdr_.seg.update_map) {
    segment_id_ = predictedSegmentId;
    return;
  }
  if (preSkip && !hdr_.seg.seg_id_pre_skip) {
    segment_id_ = 0;
    return;
  }
  if (!preSkip) {
    if (skip_) {
      // seg_id_predicted = 0, contexts updated, plain read
      for (int i = 0; i < bw4_ && mi_col_ + i < mi_cols_; i++)
        above_seg_pred_[mi_col_ + i] = 0;
      for (int i = 0; i < bh4_ && mi_row_ + i < mi_rows_; i++)
        left_seg_pred_[mi_row_ + i] = 0;
      read_segment_id(false);
      return;
    }
  }
  if (hdr_.seg.temporal_update) {
    int ctx = left_seg_pred_[mi_row_] + above_seg_pred_[mi_col_];
    int seg_id_predicted = r_.decode_bool(cdf_->segment_pred[ctx]);
    if (seg_id_predicted)
      segment_id_ = predictedSegmentId;
    else
      read_segment_id(false);
    for (int i = 0; i < bw4_ && mi_col_ + i < mi_cols_; i++)
      above_seg_pred_[mi_col_ + i] = (uint8_t)seg_id_predicted;
    for (int i = 0; i < bh4_ && mi_row_ + i < mi_rows_; i++)
      left_seg_pred_[mi_row_ + i] = (uint8_t)seg_id_predicted;
  } else {
    read_segment_id(false);
  }
}

// ---------------------------------------------------------------------------
// Skip mode / is_inter [SPEC §5.11.10-5.11.11, §5.11.17]
// ---------------------------------------------------------------------------

static inline bool seg_active(const FrameHeader& h, int seg, int feature) {
  return h.seg.enabled && h.seg.feature_enabled[seg][feature];
}

void TileDecoder::read_skip_mode() {
  if (seg_active(hdr_, segment_id_, SEG_LVL_SKIP) ||
      seg_active(hdr_, segment_id_, SEG_LVL_REF_FRAME) ||
      seg_active(hdr_, segment_id_, SEG_LVL_GLOBALMV) ||
      !hdr_.skip_mode_present || kBlockWidth4[bsize_] < 2 ||
      kBlockHeight4[bsize_] < 2) {
    skip_mode_ = 0;
  } else {
    int ctx = 0;
    if (avail_u_) ctx += plans_->at(MI_SKIP_MODE, mi_row_ - 1, mi_col_);
    if (avail_l_) ctx += plans_->at(MI_SKIP_MODE, mi_row_, mi_col_ - 1);
    skip_mode_ = r_.decode_bool(cdf_->skip_mode[ctx]);
  }
}

void TileDecoder::read_is_inter() {
  if (skip_mode_) {
    is_inter_ = 1;
  } else if (seg_active(hdr_, segment_id_, SEG_LVL_REF_FRAME)) {
    is_inter_ =
        hdr_.seg.feature_data[segment_id_][SEG_LVL_REF_FRAME] != INTRA_FRAME;
  } else if (seg_active(hdr_, segment_id_, SEG_LVL_GLOBALMV)) {
    is_inter_ = 1;
  } else {
    bool aboveIntra =
        avail_u_ && ref0_grid_[(size_t)(mi_row_ - 1) * mi_cols_ + mi_col_] <=
                        INTRA_FRAME;
    bool leftIntra =
        avail_l_ && ref0_grid_[(size_t)mi_row_ * mi_cols_ + (mi_col_ - 1)] <=
                        INTRA_FRAME;
    int ctx;
    if (avail_u_ && avail_l_)
      ctx = (leftIntra && aboveIntra) ? 3 : (leftIntra || aboveIntra);
    else if (avail_u_ || avail_l_)
      ctx = 2 * (avail_u_ ? aboveIntra : leftIntra);
    else
      ctx = 0;
    is_inter_ = r_.decode_bool(cdf_->intra_inter[ctx]);
  }
}

// ---------------------------------------------------------------------------
// Reference frames [SPEC §5.11.25 + context functions]
// ---------------------------------------------------------------------------

void TileDecoder::read_ref_frames() {
  if (skip_mode_) {
    ref_frame_[0] = hdr_.skip_mode_frame[0];
    ref_frame_[1] = hdr_.skip_mode_frame[1];
    return;
  }
  if (seg_active(hdr_, segment_id_, SEG_LVL_REF_FRAME)) {
    ref_frame_[0] = hdr_.seg.feature_data[segment_id_][SEG_LVL_REF_FRAME];
    ref_frame_[1] = NONE_FRAME;
    return;
  }
  if (seg_active(hdr_, segment_id_, SEG_LVL_SKIP) ||
      seg_active(hdr_, segment_id_, SEG_LVL_GLOBALMV)) {
    ref_frame_[0] = LAST_FRAME;
    ref_frame_[1] = NONE_FRAME;
    return;
  }

  // neighbor ref info
  int a0 = avail_u_ ? ref0_grid_[(size_t)(mi_row_ - 1) * mi_cols_ + mi_col_]
                    : INTRA_FRAME;
  int a1 = avail_u_ ? ref1_grid_[(size_t)(mi_row_ - 1) * mi_cols_ + mi_col_]
                    : NONE_FRAME;
  int l0 = avail_l_ ? ref0_grid_[(size_t)mi_row_ * mi_cols_ + (mi_col_ - 1)]
                    : INTRA_FRAME;
  int l1 = avail_l_ ? ref1_grid_[(size_t)mi_row_ * mi_cols_ + (mi_col_ - 1)]
                    : NONE_FRAME;
  bool aboveIntra = a0 <= INTRA_FRAME;
  bool leftIntra = l0 <= INTRA_FRAME;
  bool aboveSingle = a1 <= INTRA_FRAME;
  bool leftSingle = l1 <= INTRA_FRAME;

  // count_refs [SPEC]
  int counts[TOTAL_REFS_PER_FRAME] = {};
  auto bump = [&](int rf) {
    if (rf >= LAST_FRAME && rf <= ALTREF_FRAME) counts[rf]++;
  };
  if (avail_u_) {
    bump(a0);
    bump(a1);
  }
  if (avail_l_) {
    bump(l0);
    bump(l1);
  }
  int fwd = counts[LAST_FRAME] + counts[LAST2_FRAME] + counts[LAST3_FRAME] +
            counts[GOLDEN_FRAME];
  int bwd = counts[BWDREF_FRAME] + counts[ALTREF2_FRAME] +
            counts[ALTREF_FRAME];

  int comp_mode = 0;  // compound?
  if (hdr_.reference_select && std::min(bw4_, bh4_) >= 2) {
    // comp_inter ctx [SPEC §5.11.? / libaom av1_get_reference_mode_context]
    int ctx;
    if (avail_u_ && avail_l_) {
      if (aboveSingle && leftSingle)
        ctx = is_backward_ref(a0) ^ is_backward_ref(l0);
      else if (aboveSingle)
        ctx = 2 + (is_backward_ref(a0) || aboveIntra);
      else if (leftSingle)
        ctx = 2 + (is_backward_ref(l0) || leftIntra);
      else
        ctx = 4;
    } else if (avail_u_) {
      ctx = aboveSingle ? is_backward_ref(a0) : 3;
    } else if (avail_l_) {
      ctx = leftSingle ? is_backward_ref(l0) : 3;
    } else {
      ctx = 1;
    }
    comp_mode = r_.decode_bool(cdf_->comp_inter[ctx]);
  }

  if (comp_mode) {
    // comp_ref_type ctx [libaom av1_get_comp_reference_type_context]
    auto uni_refs = [&](int r0, int r1) {
      return r1 > INTRA_FRAME && !(is_backward_ref(r0) ^ is_backward_ref(r1));
    };
    bool aboveCompInter = avail_u_ && !aboveIntra && !aboveSingle;
    bool leftCompInter = avail_l_ && !leftIntra && !leftSingle;
    bool aboveUni = aboveCompInter && uni_refs(a0, a1);
    bool leftUni = leftCompInter && uni_refs(l0, l1);
    int ctx;
    if (avail_u_ && avail_l_) {
      if (aboveIntra && leftIntra) {
        ctx = 2;
      } else if (aboveIntra || leftIntra) {
        // the inter one
        bool interSingle = aboveIntra ? leftSingle : aboveSingle;
        bool interUni = aboveIntra ? leftUni : aboveUni;
        ctx = interSingle ? 2 : 1 + 2 * interUni;
      } else if (aboveSingle && leftSingle) {
        ctx = 1 + 2 * !(is_backward_ref(a0) ^ is_backward_ref(l0));
      } else if (aboveSingle || leftSingle) {
        int rfs = aboveSingle ? a0 : l0;   // the single block's ref
        int crf = aboveSingle ? l0 : a0;   // the comp block's first ref
        bool compUni = aboveSingle ? leftUni : aboveUni;
        ctx = compUni ? 3 + (is_backward_ref(rfs) == is_backward_ref(crf))
                      : 1;
      } else {
        if (!aboveUni && !leftUni)
          ctx = 0;
        else if (!aboveUni || !leftUni)
          ctx = 2;
        else
          ctx = 3 + ((a0 == BWDREF_FRAME) == (l0 == BWDREF_FRAME));
      }
    } else if (avail_u_ || avail_l_) {
      bool edgeIntra = avail_u_ ? aboveIntra : leftIntra;
      bool edgeSingle = avail_u_ ? aboveSingle : leftSingle;
      bool edgeUni = avail_u_ ? aboveUni : leftUni;
      if (edgeIntra || edgeSingle)
        ctx = 2;
      else
        ctx = 3 * edgeUni;
    } else {
      ctx = 2;
    }
    int comp_ref_type = r_.decode_bool(cdf_->comp_ref_type[ctx]);
    if (comp_ref_type == 0) {
      // unidirectional pairs
      int c0 = cnt_ctx(fwd, bwd);
      int uni0 = r_.decode_bool(cdf_->uni_comp_ref[c0][0]);
      if (uni0) {
        ref_frame_[0] = BWDREF_FRAME;
        ref_frame_[1] = ALTREF_FRAME;
      } else {
        int c1 = cnt_ctx(counts[LAST2_FRAME],
                         counts[LAST3_FRAME] + counts[GOLDEN_FRAME]);
        int uni1 = r_.decode_bool(cdf_->uni_comp_ref[c1][1]);
        if (uni1) {
          int c2 = cnt_ctx(counts[LAST3_FRAME], counts[GOLDEN_FRAME]);
          int uni2 = r_.decode_bool(cdf_->uni_comp_ref[c2][2]);
          ref_frame_[0] = LAST_FRAME;
          ref_frame_[1] = uni2 ? GOLDEN_FRAME : LAST3_FRAME;
        } else {
          ref_frame_[0] = LAST_FRAME;
          ref_frame_[1] = LAST2_FRAME;
        }
      }
    } else {
      // bidirectional: forward half
      int c0 = cnt_ctx(counts[LAST_FRAME] + counts[LAST2_FRAME],
                       counts[LAST3_FRAME] + counts[GOLDEN_FRAME]);
      int comp_ref = r_.decode_bool(cdf_->comp_ref[c0][0]);
      if (comp_ref == 0) {
        int c1 = cnt_ctx(counts[LAST_FRAME], counts[LAST2_FRAME]);
        int p1 = r_.decode_bool(cdf_->comp_ref[c1][1]);
        ref_frame_[0] = p1 ? LAST2_FRAME : LAST_FRAME;
      } else {
        int c2 = cnt_ctx(counts[LAST3_FRAME], counts[GOLDEN_FRAME]);
        int p2 = r_.decode_bool(cdf_->comp_ref[c2][2]);
        ref_frame_[0] = p2 ? GOLDEN_FRAME : LAST3_FRAME;
      }
      // backward half
      int c3 = cnt_ctx(counts[BWDREF_FRAME] + counts[ALTREF2_FRAME],
                       counts[ALTREF_FRAME]);
      int bwd0 = r_.decode_bool(cdf_->comp_bwdref[c3][0]);
      if (bwd0 == 0) {
        int c4 = cnt_ctx(counts[BWDREF_FRAME], counts[ALTREF2_FRAME]);
        int p1 = r_.decode_bool(cdf_->comp_bwdref[c4][1]);
        ref_frame_[1] = p1 ? ALTREF2_FRAME : BWDREF_FRAME;
      } else {
        ref_frame_[1] = ALTREF_FRAME;
      }
    }
  } else {
    // single reference tree
    int c1 = cnt_ctx(fwd, bwd);
    int p1 = r_.decode_bool(cdf_->single_ref[c1][0]);
    if (p1) {
      int c2 = cnt_ctx(counts[BWDREF_FRAME] + counts[ALTREF2_FRAME],
                       counts[ALTREF_FRAME]);
      int p2 = r_.decode_bool(cdf_->single_ref[c2][1]);
      if (p2) {
        ref_frame_[0] = ALTREF_FRAME;
      } else {
        int c6 = cnt_ctx(counts[BWDREF_FRAME], counts[ALTREF2_FRAME]);
        int p6 = r_.decode_bool(cdf_->single_ref[c6][5]);
        ref_frame_[0] = p6 ? ALTREF2_FRAME : BWDREF_FRAME;
      }
    } else {
      int c3 = cnt_ctx(counts[LAST_FRAME] + counts[LAST2_FRAME],
                       counts[LAST3_FRAME] + counts[GOLDEN_FRAME]);
      int p3 = r_.decode_bool(cdf_->single_ref[c3][2]);
      if (p3) {
        int c5 = cnt_ctx(counts[LAST3_FRAME], counts[GOLDEN_FRAME]);
        int p5 = r_.decode_bool(cdf_->single_ref[c5][4]);
        ref_frame_[0] = p5 ? GOLDEN_FRAME : LAST3_FRAME;
      } else {
        int c4 = cnt_ctx(counts[LAST_FRAME], counts[LAST2_FRAME]);
        int p4 = r_.decode_bool(cdf_->single_ref[c4][3]);
        ref_frame_[0] = p4 ? LAST2_FRAME : LAST_FRAME;
      }
    }
    ref_frame_[1] = NONE_FRAME;
  }
}

// ---------------------------------------------------------------------------
// MV prediction stack [SPEC §7.10.2]
// ---------------------------------------------------------------------------

void TileDecoder::search_stack(int mvRow, int mvCol, int candList,
                               int weight) {
  // [SPEC §7.10.2.3]
  size_t g = (size_t)mvRow * mi_cols_ + mvCol;
  int candMode = plans_->at(MI_MODE, mvRow, mvCol);
  int candSize = plans_->at(MI_BSIZE, mvRow, mvCol);
  bool large = std::min(kBlockWidth4[candSize], kBlockHeight4[candSize]) >= 2;
  int16_t candMv[2];
  if ((candMode == GLOBALMV || candMode == GLOBAL_GLOBALMV) &&
      ref_frame_[0] > INTRA_FRAME &&
      hdr_.gm.gm_type[ref_frame_[0]] > TRANSLATION && large) {
    candMv[0] = global_mvs_[0][0];
    candMv[1] = global_mvs_[0][1];
  } else {
    candMv[0] = plans_->at(candList ? MI_MV1Y : MI_MV0Y, mvRow, mvCol);
    candMv[1] = plans_->at(candList ? MI_MV1X : MI_MV0X, mvRow, mvCol);
  }
  lower_mv_precision(candMv);
  if (has_newmv(candMode)) new_mv_count_++;
  found_match_ = 1;
  (void)g;
  for (int idx = 0; idx < num_mv_found_; idx++) {
    if (candMv[0] == ref_mv_stack_[idx][0][0] &&
        candMv[1] == ref_mv_stack_[idx][0][1]) {
      weight_stack_[idx] += weight;
      return;
    }
  }
  if (num_mv_found_ < MAX_REF_MV_STACK_SIZE) {
    ref_mv_stack_[num_mv_found_][0][0] = candMv[0];
    ref_mv_stack_[num_mv_found_][0][1] = candMv[1];
    weight_stack_[num_mv_found_] = weight;
    num_mv_found_++;
  }
}

void TileDecoder::compound_search_stack(int mvRow, int mvCol, int weight) {
  // [SPEC §7.10.2.4]
  int candMode = plans_->at(MI_MODE, mvRow, mvCol);
  int candSize = plans_->at(MI_BSIZE, mvRow, mvCol);
  bool large = std::min(kBlockWidth4[candSize], kBlockHeight4[candSize]) >= 2;
  int16_t candMvs[2][2];
  for (int i = 0; i < 2; i++) {
    if (candMode == GLOBAL_GLOBALMV &&
        hdr_.gm.gm_type[ref_frame_[i]] > TRANSLATION && large) {
      candMvs[i][0] = global_mvs_[i][0];
      candMvs[i][1] = global_mvs_[i][1];
    } else {
      candMvs[i][0] = plans_->at(i ? MI_MV1Y : MI_MV0Y, mvRow, mvCol);
      candMvs[i][1] = plans_->at(i ? MI_MV1X : MI_MV0X, mvRow, mvCol);
    }
    lower_mv_precision(candMvs[i]);
  }
  if (has_newmv(candMode)) new_mv_count_++;
  found_match_ = 1;
  for (int idx = 0; idx < num_mv_found_; idx++) {
    if (candMvs[0][0] == ref_mv_stack_[idx][0][0] &&
        candMvs[0][1] == ref_mv_stack_[idx][0][1] &&
        candMvs[1][0] == ref_mv_stack_[idx][1][0] &&
        candMvs[1][1] == ref_mv_stack_[idx][1][1]) {
      weight_stack_[idx] += weight;
      return;
    }
  }
  if (num_mv_found_ < MAX_REF_MV_STACK_SIZE) {
    for (int i = 0; i < 2; i++) {
      ref_mv_stack_[num_mv_found_][i][0] = candMvs[i][0];
      ref_mv_stack_[num_mv_found_][i][1] = candMvs[i][1];
    }
    weight_stack_[num_mv_found_] = weight;
    num_mv_found_++;
  }
}

void TileDecoder::add_ref_mv_candidate(int mvRow, int mvCol, bool isCompound,
                                       int weight) {
  // [SPEC §7.10.2.2]; intrabc blocks count as inter (ref0 == INTRA)
  size_t g = (size_t)mvRow * mi_cols_ + mvCol;
  bool cand_inter = plans_->at(MI_IS_INTER, mvRow, mvCol) ||
                    plans_->at(MI_INTRABC, mvRow, mvCol);
  if (!cand_inter) return;
  if (!isCompound) {
    for (int candList = 0; candList < 2; candList++) {
      int candRef = candList ? ref1_grid_[g] : ref0_grid_[g];
      if (candRef == ref_frame_[0])
        search_stack(mvRow, mvCol, candList, weight);
    }
  } else {
    if (ref0_grid_[g] == ref_frame_[0] && ref1_grid_[g] == ref_frame_[1])
      compound_search_stack(mvRow, mvCol, weight);
  }
}

void TileDecoder::scan_row(int deltaRow, bool isCompound, int maxRowOffset,
                           int* processedRows) {
  // [SPEC §7.10.2.2 scan_row] - candidate weight is len*max(2,inc) with
  // processed-rows bookkeeping that suppresses redundant outer-ring scans
  // (verified against libaom recon for 4-wide blocks on tied weights)
  int deltaCol = 0;
  int end4 = std::min(std::min(bw4_, mi_cols_ - mi_col_), 16);
  bool useStep16 = bw4_ >= 16;
  if (std::abs(deltaRow) > 1) {
    deltaCol = 1;
    if ((mi_col_ & 1) && bw4_ < 2) deltaCol--;
  }
  int i = 0;
  while (i < end4) {
    int mvRow = mi_row_ + deltaRow;
    int mvCol = mi_col_ + deltaCol + i;
    if (!is_inside(mvRow, mvCol)) break;
    int cand = plans_->at(MI_BSIZE, mvRow, mvCol);
    int n4w = kBlockWidth4[cand];
    int len = std::min(bw4_, n4w);
    if (useStep16)
      len = std::max(4, len);
    else if (std::abs(deltaRow) > 1)
      len = std::max(2, len);
    int weight = 2;
    if (bw4_ >= 2 && bw4_ <= n4w) {
      int inc = std::min(-maxRowOffset + deltaRow + 1,
                         (int)kBlockHeight4[cand]);
      weight = std::max(weight, inc);
      *processedRows = inc - deltaRow - 1;
    }
    add_ref_mv_candidate(mvRow, mvCol, isCompound, len * weight);
    i += len;
  }
}

void TileDecoder::scan_col(int deltaCol, bool isCompound, int maxColOffset,
                           int* processedCols) {
  int deltaRow = 0;
  int end4 = std::min(std::min(bh4_, mi_rows_ - mi_row_), 16);
  bool useStep16 = bh4_ >= 16;
  if (std::abs(deltaCol) > 1) {
    deltaRow = 1;
    if ((mi_row_ & 1) && bh4_ < 2) deltaRow--;
  }
  int i = 0;
  while (i < end4) {
    int mvRow = mi_row_ + deltaRow + i;
    int mvCol = mi_col_ + deltaCol;
    if (!is_inside(mvRow, mvCol)) break;
    int cand = plans_->at(MI_BSIZE, mvRow, mvCol);
    int n4h = kBlockHeight4[cand];
    int len = std::min(bh4_, n4h);
    if (useStep16)
      len = std::max(4, len);
    else if (std::abs(deltaCol) > 1)
      len = std::max(2, len);
    int weight = 2;
    if (bh4_ >= 2 && bh4_ <= n4h) {
      int inc = std::min(-maxColOffset + deltaCol + 1,
                         (int)kBlockWidth4[cand]);
      weight = std::max(weight, inc);
      *processedCols = inc - deltaCol - 1;
    }
    add_ref_mv_candidate(mvRow, mvCol, isCompound, len * weight);
    i += len;
  }
}

void TileDecoder::scan_point(int deltaRow, int deltaCol, bool isCompound) {
  int mvRow = mi_row_ + deltaRow;
  int mvCol = mi_col_ + deltaCol;
  if (is_inside(mvRow, mvCol) && is_decoded(mvRow, mvCol))
    add_ref_mv_candidate(mvRow, mvCol, isCompound, 4);
}

void TileDecoder::add_tpl_ref_mv(int deltaRow, int deltaCol) {
  // [SPEC §7.10.2.6 temporal sample]
  int mvRow = (mi_row_ + deltaRow) | 1;
  int mvCol = (mi_col_ + deltaCol) | 1;
  if (!is_inside(mvRow, mvCol)) return;
  int x8 = mvCol >> 1, y8 = mvRow >> 1;
  bool isCompound = ref_frame_[1] > INTRA_FRAME;
  if (deltaRow == 0 && deltaCol == 0) zero_mv_ctx_ = 1;
  const int16_t* tmv = &mctx_->tpl_mv[((size_t)y8 * mctx_->w8 + x8) * 2];
  int toff = mctx_->tpl_off[(size_t)y8 * mctx_->w8 + x8];
  if (tmv[0] == MV_INVALID) return;
  // project the stored motion onto each of this block's ref frames
  int16_t candMv[2][2];
  for (int list = 0; list <= (isCompound ? 1 : 0); list++) {
    int off = rel_dist(hdr_.order_hint, mctx_->order_hints[ref_frame_[list]]);
    mv_projection(candMv[list], tmv, off, toff);
    lower_mv_precision(candMv[list]);
  }
  if (deltaRow == 0 && deltaCol == 0) {
    zero_mv_ctx_ = (std::abs(candMv[0][0] - global_mvs_[0][0]) >= 16 ||
                    std::abs(candMv[0][1] - global_mvs_[0][1]) >= 16)
                       ? 1
                       : 0;
  }
  if (!isCompound) {
    for (int idx = 0; idx < num_mv_found_; idx++) {
      if (candMv[0][0] == ref_mv_stack_[idx][0][0] &&
          candMv[0][1] == ref_mv_stack_[idx][0][1]) {
        weight_stack_[idx] += 2;
        return;
      }
    }
    if (num_mv_found_ < MAX_REF_MV_STACK_SIZE) {
      ref_mv_stack_[num_mv_found_][0][0] = candMv[0][0];
      ref_mv_stack_[num_mv_found_][0][1] = candMv[0][1];
      weight_stack_[num_mv_found_] = 2;
      num_mv_found_++;
    }
  } else {
    for (int idx = 0; idx < num_mv_found_; idx++) {
      if (candMv[0][0] == ref_mv_stack_[idx][0][0] &&
          candMv[0][1] == ref_mv_stack_[idx][0][1] &&
          candMv[1][0] == ref_mv_stack_[idx][1][0] &&
          candMv[1][1] == ref_mv_stack_[idx][1][1]) {
        weight_stack_[idx] += 2;
        return;
      }
    }
    if (num_mv_found_ < MAX_REF_MV_STACK_SIZE) {
      for (int i = 0; i < 2; i++) {
        ref_mv_stack_[num_mv_found_][i][0] = candMv[i][0];
        ref_mv_stack_[num_mv_found_][i][1] = candMv[i][1];
      }
      weight_stack_[num_mv_found_] = 2;
      num_mv_found_++;
    }
  }
}

void TileDecoder::temporal_scan() {
  // [SPEC §7.10.2.5]
  int stepW4 = bw4_ >= 16 ? 4 : 2;
  int stepH4 = bh4_ >= 16 ? 4 : 2;
  for (int deltaRow = 0; deltaRow < std::min(bh4_, 16); deltaRow += stepH4)
    for (int deltaCol = 0; deltaCol < std::min(bw4_, 16); deltaCol += stepW4)
      add_tpl_ref_mv(deltaRow, deltaCol);
  bool allowExtension = bh4_ >= 2 && bw4_ >= 2 && bh4_ < 16 && bw4_ < 16;
  if (allowExtension) {
    const int pos[3][2] = {{bh4_, -2}, {bh4_, bw4_}, {bh4_ - 2, bw4_}};
    for (int i = 0; i < 3; i++) {
      // extension samples must stay inside the same 64x64 region
      // [libaom check_sb_border]
      int row = (mi_row_ & 15) + pos[i][0];
      int col = (mi_col_ & 15) + pos[i][1];
      if (row < 0 || row >= 16 || col < 0 || col >= 16) continue;
      add_tpl_ref_mv(pos[i][0], pos[i][1]);
    }
  }
}

void TileDecoder::add_extra_mv_candidate(int mvRow, int mvCol) {
  // [SPEC §7.10.2.9]
  size_t g = (size_t)mvRow * mi_cols_ + mvCol;
  bool isCompound = ref_frame_[1] > INTRA_FRAME;
  if (isCompound) {
    for (int candList = 0; candList < 2; candList++) {
      int candRef = candList ? ref1_grid_[g] : ref0_grid_[g];
      if (candRef <= INTRA_FRAME) continue;
      for (int list = 0; list < 2; list++) {
        int16_t candMv[2] = {
            plans_->at(candList ? MI_MV1Y : MI_MV0Y, mvRow, mvCol),
            plans_->at(candList ? MI_MV1X : MI_MV0X, mvRow, mvCol)};
        if (candRef == ref_frame_[list] && ref_id_count_[list] < 2) {
          ref_id_mvs_[list][ref_id_count_[list]][0] = candMv[0];
          ref_id_mvs_[list][ref_id_count_[list]][1] = candMv[1];
          ref_id_count_[list]++;
        } else if (ref_diff_count_[list] < 2) {
          if (mctx_->ref_sign_bias[candRef] !=
              mctx_->ref_sign_bias[ref_frame_[list]]) {
            candMv[0] = (int16_t)-candMv[0];
            candMv[1] = (int16_t)-candMv[1];
          }
          ref_diff_mvs_[list][ref_diff_count_[list]][0] = candMv[0];
          ref_diff_mvs_[list][ref_diff_count_[list]][1] = candMv[1];
          ref_diff_count_[list]++;
        }
      }
    }
  } else {
    for (int candList = 0; candList < 2; candList++) {
      int candRef = candList ? ref1_grid_[g] : ref0_grid_[g];
      if (candRef <= INTRA_FRAME) continue;
      int16_t candMv[2] = {
          plans_->at(candList ? MI_MV1Y : MI_MV0Y, mvRow, mvCol),
          plans_->at(candList ? MI_MV1X : MI_MV0X, mvRow, mvCol)};
      if (mctx_->ref_sign_bias[candRef] !=
          mctx_->ref_sign_bias[ref_frame_[0]]) {
        candMv[0] = (int16_t)-candMv[0];
        candMv[1] = (int16_t)-candMv[1];
      }
      int idx = 0;
      while (idx < num_mv_found_ &&
             !(ref_mv_stack_[idx][0][0] == candMv[0] &&
               ref_mv_stack_[idx][0][1] == candMv[1]))
        idx++;
      if (idx == num_mv_found_ && num_mv_found_ < 2) {
        ref_mv_stack_[num_mv_found_][0][0] = candMv[0];
        ref_mv_stack_[num_mv_found_][0][1] = candMv[1];
        weight_stack_[num_mv_found_] = 2;
        num_mv_found_++;
      }
    }
  }
}

void TileDecoder::extra_search() {
  // [SPEC §7.10.2.8]
  bool isCompound = ref_frame_[1] > INTRA_FRAME;
  for (int list = 0; list < 2; list++) {
    ref_id_count_[list] = 0;
    ref_diff_count_[list] = 0;
  }
  int w4 = std::min(std::min(16, bw4_), mi_cols_ - mi_col_);
  int h4 = std::min(std::min(16, bh4_), mi_rows_ - mi_row_);
  int num4x4 = std::min(w4, h4);
  for (int pass = 0; pass < 2; pass++) {
    int idx = 0;
    while (idx < num4x4 && num_mv_found_ < 2) {
      int mvRow, mvCol;
      if (pass == 0) {
        mvRow = mi_row_ - 1;
        mvCol = mi_col_ + idx;
      } else {
        mvRow = mi_row_ + idx;
        mvCol = mi_col_ - 1;
      }
      if (!is_inside(mvRow, mvCol)) break;
      add_extra_mv_candidate(mvRow, mvCol);
      if (pass == 0)
        idx += kBlockWidth4[plans_->at(MI_BSIZE, mvRow, mvCol)];
      else
        idx += kBlockHeight4[plans_->at(MI_BSIZE, mvRow, mvCol)];
    }
  }
  if (isCompound) {
    int16_t combined[2][2][2];
    for (int list = 0; list < 2; list++) {
      int compCount = 0;
      for (int idx = 0; idx < ref_id_count_[list] && compCount < 2; idx++) {
        combined[compCount][list][0] = ref_id_mvs_[list][idx][0];
        combined[compCount][list][1] = ref_id_mvs_[list][idx][1];
        compCount++;
      }
      for (int idx = 0; idx < ref_diff_count_[list] && compCount < 2;
           idx++) {
        combined[compCount][list][0] = ref_diff_mvs_[list][idx][0];
        combined[compCount][list][1] = ref_diff_mvs_[list][idx][1];
        compCount++;
      }
      while (compCount < 2) {
        combined[compCount][list][0] = global_mvs_[list][0];
        combined[compCount][list][1] = global_mvs_[list][1];
        compCount++;
      }
    }
    if (num_mv_found_ == 1) {
      if (combined[0][0][0] == ref_mv_stack_[0][0][0] &&
          combined[0][0][1] == ref_mv_stack_[0][0][1] &&
          combined[0][1][0] == ref_mv_stack_[0][1][0] &&
          combined[0][1][1] == ref_mv_stack_[0][1][1]) {
        std::memcpy(ref_mv_stack_[1], combined[1], sizeof(combined[1]));
      } else {
        std::memcpy(ref_mv_stack_[1], combined[0], sizeof(combined[0]));
      }
      weight_stack_[1] = 2;
      num_mv_found_ = 2;
    } else {
      num_mv_found_ = 2;
      for (int idx = 0; idx < 2; idx++) {
        std::memcpy(ref_mv_stack_[idx], combined[idx],
                    sizeof(combined[idx]));
        weight_stack_[idx] = 2;
      }
    }
  } else {
    for (int idx = num_mv_found_; idx < 2; idx++) {
      ref_mv_stack_[idx][0][0] = global_mvs_[0][0];
      ref_mv_stack_[idx][0][1] = global_mvs_[0][1];
    }
  }
}

void TileDecoder::sorting(int start, int end) {
  // [SPEC §7.10.2.14 stable descending bubble]
  while (end > start) {
    int newEnd = start;
    for (int idx = start + 1; idx < end; idx++) {
      if (weight_stack_[idx - 1] < weight_stack_[idx]) {
        int16_t tmp[2][2];
        std::memcpy(tmp, ref_mv_stack_[idx - 1], sizeof(tmp));
        std::memcpy(ref_mv_stack_[idx - 1], ref_mv_stack_[idx], sizeof(tmp));
        std::memcpy(ref_mv_stack_[idx], tmp, sizeof(tmp));
        std::swap(weight_stack_[idx - 1], weight_stack_[idx]);
        newEnd = idx;
      }
    }
    end = newEnd;
  }
}

void TileDecoder::find_mv_stack(bool isCompound) {
  // [SPEC §7.10.2]
  num_mv_found_ = 0;
  new_mv_count_ = 0;
  std::memset(ref_mv_stack_, 0, sizeof(ref_mv_stack_));
  std::memset(weight_stack_, 0, sizeof(weight_stack_));
  setup_global_mv(0, global_mvs_[0]);
  if (isCompound) setup_global_mv(1, global_mvs_[1]);

  // row/col scan offsets & clamps [SPEC §7.10.2 / libaom setup_ref_mv_list]
  int rowAdj = (bh4_ < 2 && (mi_row_ & 1)) ? 1 : 0;
  int colAdj = (bw4_ < 2 && (mi_col_ & 1)) ? 1 : 0;
  int maxRowOffset = 0;
  if (mi_row_ > mi_row_start_) {
    maxRowOffset = (bh4_ < 2 ? -4 : -6) + rowAdj;
    maxRowOffset = std::max(maxRowOffset, mi_row_start_ - mi_row_);
  }
  int maxColOffset = 0;
  if (mi_col_ > mi_col_start_) {
    maxColOffset = (bw4_ < 2 ? -4 : -6) + colAdj;
    maxColOffset = std::max(maxColOffset, mi_col_start_ - mi_col_);
  }
  int processedRows = 0, processedCols = 0;

  found_match_ = 0;
  if (std::abs(maxRowOffset) >= 1)
    scan_row(-1, isCompound, maxRowOffset, &processedRows);
  int foundAboveMatch = found_match_;
  found_match_ = 0;
  if (std::abs(maxColOffset) >= 1)
    scan_col(-1, isCompound, maxColOffset, &processedCols);
  int foundLeftMatch = found_match_;
  found_match_ = 0;
  if (std::max(bw4_, bh4_) <= 16) {
    scan_point(-1, bw4_, isCompound);
    if (found_match_) foundAboveMatch = 1;
    found_match_ = 0;
  }
  close_matches_ = foundAboveMatch + foundLeftMatch;
  int numNearest = num_mv_found_;
  int numNew = new_mv_count_;
  if (numNearest > 0) {
    for (int idx = 0; idx < numNearest; idx++)
      weight_stack_[idx] += REF_MV_WEIGHT_NEAREST;
  }
  zero_mv_ctx_ = 0;
  if (hdr_.use_ref_frame_mvs && mctx_ && !mctx_->tpl_mv.empty())
    temporal_scan();
  scan_point(-1, -1, isCompound);
  if (found_match_) foundAboveMatch = 1;
  found_match_ = 0;
  for (int idx = 2; idx <= 3; idx++) {
    int rowOffset = -(idx << 1) + 1 + rowAdj;
    int colOffset = -(idx << 1) + 1 + colAdj;
    if (std::abs(rowOffset) <= std::abs(maxRowOffset) &&
        std::abs(rowOffset) > processedRows) {
      scan_row(rowOffset, isCompound, maxRowOffset, &processedRows);
      if (found_match_) foundAboveMatch = 1;
      found_match_ = 0;
    }
    if (std::abs(colOffset) <= std::abs(maxColOffset) &&
        std::abs(colOffset) > processedCols) {
      scan_col(colOffset, isCompound, maxColOffset, &processedCols);
      if (found_match_) foundLeftMatch = 1;
      found_match_ = 0;
    }
  }
  total_matches_ = foundAboveMatch + foundLeftMatch;

  sorting(0, numNearest);
  sorting(numNearest, num_mv_found_);

  if (num_mv_found_ < 2) extra_search();

  // mode contexts [SPEC §7.10.2.13]
  if (close_matches_ == 0) {
    new_mv_ctx_ = std::min(total_matches_, 1);
    ref_mv_ctx_ = total_matches_;
  } else if (close_matches_ == 1) {
    new_mv_ctx_ = 3 - std::min(numNew, 1);
    ref_mv_ctx_ = 2 + total_matches_;
  } else {
    new_mv_ctx_ = 5 - std::min(numNew, 1);
    ref_mv_ctx_ = 5;
  }

  // clamp stack entries to the extended frame area [SPEC §7.10.2.14]
  int mbToTop = -(mi_row_ * 4 * 8);
  int mbToBottom = (mi_rows_ - bh4_ - mi_row_) * 4 * 8;
  int mbToLeft = -(mi_col_ * 4 * 8);
  int mbToRight = (mi_cols_ - bw4_ - mi_col_) * 4 * 8;
  int borderRow = MV_BORDER + bh4_ * 4 * 8;
  int borderCol = MV_BORDER + bw4_ * 4 * 8;
  for (int list = 0; list < 1 + (isCompound ? 1 : 0); list++) {
    for (int idx = 0; idx < num_mv_found_; idx++) {
      ref_mv_stack_[idx][list][0] = (int16_t)std::clamp(
          (int)ref_mv_stack_[idx][list][0], mbToTop - borderRow,
          mbToBottom + borderRow);
      ref_mv_stack_[idx][list][1] = (int16_t)std::clamp(
          (int)ref_mv_stack_[idx][list][1], mbToLeft - borderCol,
          mbToRight + borderCol);
    }
  }

  // DRL contexts [SPEC §7.10.2.14]
  for (int idx = 0; idx < num_mv_found_; idx++) {
    int z = 0;
    if (idx + 1 < num_mv_found_) {
      int w0 = weight_stack_[idx], w1 = weight_stack_[idx + 1];
      if (w0 >= REF_MV_WEIGHT_NEAREST)
        z = w1 < REF_MV_WEIGHT_NEAREST ? 1 : 0;
      else
        z = 2;
    }
    drl_ctx_stack_[idx] = z;
  }
  if (getenv("AV1N_SYN") && *getenv("AV1N_SYN") == '1') {
    fprintf(stderr, "  STACK r=%d c=%d n=%d:", mi_row_, mi_col_,
            num_mv_found_);
    for (int i = 0; i < num_mv_found_; i++)
      fprintf(stderr, " [%d,%d|%d,%d w%d]", ref_mv_stack_[i][0][0],
              ref_mv_stack_[i][0][1], ref_mv_stack_[i][1][0],
              ref_mv_stack_[i][1][1], weight_stack_[i]);
    fprintf(stderr, " newctx=%d refctx=%d zeroctx=%d\n", new_mv_ctx_,
            ref_mv_ctx_, zero_mv_ctx_);
  }
}

// ---------------------------------------------------------------------------
// DRL index / MV decode / assignment [SPEC §5.11.26, §5.11.31-33]
// ---------------------------------------------------------------------------

int TileDecoder::read_drl_idx() {
  ref_mv_idx_ = 0;
  if (y_mode_ == NEWMV || y_mode_ == NEW_NEWMV) {
    for (int idx = 0; idx < 2; idx++) {
      if (num_mv_found_ > idx + 1) {
        int drl_mode = r_.decode_bool(cdf_->drl[drl_ctx_stack_[idx]]);
        if (!drl_mode) {
          ref_mv_idx_ = idx;
          break;
        }
        ref_mv_idx_ = idx + 1;
      }
    }
  } else if (has_nearmv(y_mode_)) {
    ref_mv_idx_ = 1;
    for (int idx = 1; idx < 3; idx++) {
      if (num_mv_found_ > idx + 1) {
        int drl_mode = r_.decode_bool(cdf_->drl[drl_ctx_stack_[idx]]);
        if (!drl_mode) {
          ref_mv_idx_ = idx;
          break;
        }
        ref_mv_idx_ = idx + 1;
      }
    }
  }
  return ref_mv_idx_;
}

int TileDecoder::read_mv_component(int comp, bool use_dv) {
  // [SPEC §5.11.32]
  MvComponentCdf& c =
      use_dv ? cdf_->dv.comp[comp] : cdf_->mv.comp[comp];
  int force_int = hdr_.cur_frame_force_integer_mv;
  int allow_hp = hdr_.allow_high_precision_mv;
  int sign = r_.decode_bool(c.sign);
  int mv_class = r_.decode_symbol(c.classes, 11);
  int mag;
  if (mv_class == 0) {
    int int_bit = r_.decode_bool(c.class0);
    int fr = force_int ? 3 : r_.decode_symbol(c.class0_fp[int_bit], 4);
    int hp = allow_hp ? r_.decode_bool(c.class0_hp) : 1;
    mag = ((int_bit << 3) | (fr << 1) | hp) + 1;
  } else {
    int d = 0;
    for (int i = 0; i < mv_class; i++)
      d |= r_.decode_bool(c.bits[i]) << i;
    mag = 2 << (mv_class + 2);  // CLASS0_SIZE << (class + 2)
    int fr = force_int ? 3 : r_.decode_symbol(c.fp, 4);
    int hp = allow_hp ? r_.decode_bool(c.hp) : 1;
    mag += ((d << 3) | (fr << 1) | hp) + 1;
  }
  return sign ? -mag : mag;
}

int TileDecoder::read_mv(int ref) {
  // [SPEC §5.11.31]; pred already staged in mv_[ref]
  bool use_dv = use_intrabc_;
  MvCdf& mc = use_dv ? cdf_->dv : cdf_->mv;
  int16_t diff[2] = {0, 0};
  int joint = r_.decode_symbol(mc.joints, 4);
  if (joint == 2 || joint == 3) diff[0] = (int16_t)read_mv_component(0, use_dv);
  if (joint == 1 || joint == 3) diff[1] = (int16_t)read_mv_component(1, use_dv);
  mv_[ref][0] = clip_mv16(mv_[ref][0] + diff[0]);
  mv_[ref][1] = clip_mv16(mv_[ref][1] + diff[1]);
  return 0;
}

static int get_sub_mode(int yMode, int i) {
  // [SPEC get_mode]: maps a (compound) Y mode to the per-list mode
  if (i == 0) {
    if (yMode < NEAREST_NEARESTMV) return yMode;
    if (yMode == NEW_NEWMV || yMode == NEW_NEARESTMV ||
        yMode == NEW_NEARMV)
      return NEWMV;
    if (yMode == NEAREST_NEARESTMV || yMode == NEAREST_NEWMV)
      return NEARESTMV;
    if (yMode == NEAR_NEARMV || yMode == NEAR_NEWMV) return NEARMV;
    return GLOBALMV;
  }
  if (yMode == NEW_NEWMV || yMode == NEAREST_NEWMV || yMode == NEAR_NEWMV)
    return NEWMV;
  if (yMode == NEAREST_NEARESTMV || yMode == NEW_NEARESTMV)
    return NEARESTMV;
  if (yMode == NEAR_NEARMV || yMode == NEW_NEARMV) return NEARMV;
  return GLOBALMV;
}

int TileDecoder::assign_mv(bool isCompound) {
  // [SPEC §5.11.26 assign_mv]
  for (int i = 0; i < 1 + (isCompound ? 1 : 0); i++) {
    int compMode = use_intrabc_ ? NEWMV : get_sub_mode(y_mode_, i);
    if (use_intrabc_) {
      // DV prediction [SPEC §5.11.26 intrabc path]
      int16_t pred[2] = {ref_mv_stack_[0][0][0], ref_mv_stack_[0][0][1]};
      if (pred[0] == 0 && pred[1] == 0) {
        pred[0] = ref_mv_stack_[1][0][0];
        pred[1] = ref_mv_stack_[1][0][1];
      }
      if (pred[0] == 0 && pred[1] == 0) {
        int sbSize4 = seq_.use_128x128_superblock ? 32 : 16;
        if (mi_row_ - sbSize4 < mi_row_start_) {
          pred[0] = 0;
          pred[1] = (int16_t)(-(sbSize4 * 4 + 256) * 8);
        } else {
          pred[0] = (int16_t)(-(sbSize4 * 4 * 8));
          pred[1] = 0;
        }
      }
      mv_[0][0] = pred[0];
      mv_[0][1] = pred[1];
      read_mv(0);
      continue;
    }
    if (compMode == GLOBALMV) {
      mv_[i][0] = global_mvs_[i][0];
      mv_[i][1] = global_mvs_[i][1];
      continue;
    }
    int pos = compMode == NEARESTMV ? 0 : ref_mv_idx_;
    if (compMode == NEWMV && num_mv_found_ <= 1) pos = 0;
    mv_[i][0] = ref_mv_stack_[pos][i][0];
    mv_[i][1] = ref_mv_stack_[pos][i][1];
    if (compMode == NEWMV) read_mv(i);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Inter-intra / motion mode / compound type [SPEC §5.11.28-5.11.30]
// ---------------------------------------------------------------------------

void TileDecoder::read_interintra_mode(bool isCompound) {
  interintra_ = 0;
  ii_wedge_packed_ = 0;
  if (!skip_mode_ && seq_.enable_interintra_compound && !isCompound &&
      bsize_ >= BLOCK_8X8 && bsize_ <= BLOCK_32X32) {
    int grp = kSizeGroup[bsize_];
    if (r_.decode_bool(cdf_->interintra[grp])) {
      int mode = r_.decode_symbol(cdf_->interintra_mode[grp], 4);
      interintra_ = mode + 1;
      ref_frame_[1] = INTRA_FRAME;
      angle_delta_y_ = 0;
      angle_delta_uv_ = 0;
      filter_intra_mode_ = -1;
      int wedge_ii = 0, wedge_idx = 0;
      if (kWedgeBits[bsize_] > 0) {
        wedge_ii = r_.decode_bool(cdf_->wedge_interintra[bsize_]);
        if (wedge_ii) wedge_idx = r_.decode_symbol(cdf_->wedge_idx[bsize_], 16);
      }
      ii_wedge_packed_ = (wedge_ii << 4) | wedge_idx;
    }
  }
}

bool TileDecoder::has_overlappable_candidates() const {
  // [SPEC §5.11.29 helper]
  if (avail_u_) {
    for (int w4 = 0; w4 < bw4_; w4 += 2) {
      int col = (mi_col_ + w4) | 1;
      if (col < mi_cols_ &&
          ref0_grid_[(size_t)(mi_row_ - 1) * mi_cols_ + col] > INTRA_FRAME)
        return true;
    }
  }
  if (avail_l_) {
    for (int h4 = 0; h4 < bh4_; h4 += 2) {
      int row = (mi_row_ + h4) | 1;
      if (row < mi_rows_ &&
          ref0_grid_[(size_t)row * mi_cols_ + (mi_col_ - 1)] > INTRA_FRAME)
        return true;
    }
  }
  return false;
}

void TileDecoder::read_motion_mode(bool isCompound) {
  motion_mode_ = SIMPLE_MOTION;
  num_samples_ = 0;
  warp_invalid_ = 1;
  if (skip_mode_) return;
  if (!hdr_.is_motion_mode_switchable) return;
  if (std::min(4 * bw4_, 4 * bh4_) < 8) return;
  if (!hdr_.cur_frame_force_integer_mv &&
      (y_mode_ == GLOBALMV || y_mode_ == GLOBAL_GLOBALMV)) {
    if (hdr_.gm.gm_type[ref_frame_[0]] > TRANSLATION) return;
  }
  if (isCompound || ref_frame_[1] == INTRA_FRAME ||
      !has_overlappable_candidates())
    return;
  find_warp_samples();
  // is_scaled [SPEC §7.11.3.3]: ref's upscaled dims vs current coded dims
  bool scaled = false;
  if (mctx_ && ref_frame_[0] >= LAST_FRAME) {
    scaled = mctx_->ref_width[ref_frame_[0]] != hdr_.frame_width ||
             mctx_->ref_height[ref_frame_[0]] != hdr_.frame_height;
  }
  if (hdr_.cur_frame_force_integer_mv || num_samples_ == 0 ||
      !hdr_.allow_warped_motion || scaled) {
    motion_mode_ = r_.decode_bool(cdf_->obmc[bsize_]) ? OBMC_CAUSAL
                                                      : SIMPLE_MOTION;
  } else {
    motion_mode_ = r_.decode_symbol(cdf_->motion_mode[bsize_], 3);
  }
  if (motion_mode_ == WARPED_CAUSAL) warp_estimation();
}

void TileDecoder::read_compound_type(bool isCompound) {
  // [SPEC §5.11.30]
  compound_type_ = PLAN_COMP_AVG;
  wedge_packed_ = 0;
  int comp_group_idx = 0, compound_idx = 1;
  if (!skip_mode_ && isCompound) {
    int n = kWedgeBits[bsize_];
    if (seq_.enable_masked_compound) {
      // comp_group_idx ctx
      int ctx = 0;
      if (avail_u_) {
        size_t g = (size_t)(mi_row_ - 1) * mi_cols_ + mi_col_;
        if (ref1_grid_[g] > INTRA_FRAME)
          ctx += comp_group_grid_[g];
        else if (ref0_grid_[g] == ALTREF_FRAME)
          ctx += 3;
      }
      if (avail_l_) {
        size_t g = (size_t)mi_row_ * mi_cols_ + (mi_col_ - 1);
        if (ref1_grid_[g] > INTRA_FRAME)
          ctx += comp_group_grid_[g];
        else if (ref0_grid_[g] == ALTREF_FRAME)
          ctx += 3;
      }
      ctx = std::min(5, ctx);
      comp_group_idx = r_.decode_bool(cdf_->comp_group_idx[ctx]);
    }
    if (comp_group_idx == 0) {
      if (seq_.enable_jnt_comp) {
        int fwd = std::abs(rel_dist(mctx_->order_hints[ref_frame_[0]],
                                    hdr_.order_hint));
        int bck = std::abs(rel_dist(mctx_->order_hints[ref_frame_[1]],
                                    hdr_.order_hint));
        int ctx = (fwd == bck) ? 3 : 0;
        if (avail_u_) {
          size_t g = (size_t)(mi_row_ - 1) * mi_cols_ + mi_col_;
          if (ref1_grid_[g] > INTRA_FRAME)
            ctx += compound_idx_grid_[g];
          else if (ref0_grid_[g] == ALTREF_FRAME)
            ctx++;
        }
        if (avail_l_) {
          size_t g = (size_t)mi_row_ * mi_cols_ + (mi_col_ - 1);
          if (ref1_grid_[g] > INTRA_FRAME)
            ctx += compound_idx_grid_[g];
          else if (ref0_grid_[g] == ALTREF_FRAME)
            ctx++;
        }
        compound_idx = r_.decode_bool(cdf_->compound_idx[ctx]);
        compound_type_ = compound_idx ? PLAN_COMP_AVG : PLAN_COMP_DIST;
      } else {
        compound_type_ = PLAN_COMP_AVG;
      }
    } else {
      int ct;
      if (n > 0)
        ct = r_.decode_bool(cdf_->compound_type[bsize_]) ? PLAN_COMP_DIFFWTD
                                                         : PLAN_COMP_WEDGE;
      else
        ct = PLAN_COMP_DIFFWTD;
      compound_type_ = ct;
      if (ct == PLAN_COMP_WEDGE) {
        int wedge_idx = r_.decode_symbol(cdf_->wedge_idx[bsize_], 16);
        int wedge_sign = (int)r_.decode_literal(1);
        wedge_packed_ = wedge_idx | (wedge_sign << 4);
      } else {
        wedge_packed_ = (int)r_.decode_literal(1);  // mask_type
      }
    }
  }
  comp_group_cur_ = comp_group_idx;
  compound_idx_cur_ = compound_idx;
}

void TileDecoder::read_interp_filter() {
  // [SPEC §5.11.24]
  if (hdr_.interpolation_filter != SWITCHABLE) {
    interp_filter_[0] = interp_filter_[1] = hdr_.interpolation_filter;
    return;
  }
  // needs_interp_filter
  bool large = std::min(4 * bw4_, 4 * bh4_) >= 8;
  bool needs;
  if (skip_mode_ || motion_mode_ == WARPED_CAUSAL) {
    needs = false;
  } else if (large && y_mode_ == GLOBALMV) {
    needs = hdr_.gm.gm_type[ref_frame_[0]] == TRANSLATION;
  } else if (large && y_mode_ == GLOBAL_GLOBALMV) {
    needs = hdr_.gm.gm_type[ref_frame_[0]] == TRANSLATION ||
            hdr_.gm.gm_type[ref_frame_[1]] == TRANSLATION;
  } else {
    needs = true;
  }
  for (int dir = 0; dir < (seq_.enable_dual_filter ? 2 : 1); dir++) {
    if (!needs) {
      interp_filter_[dir] = EIGHTTAP;
      continue;
    }
    int ctx = ((dir & 1) * 2 + (ref_frame_[1] > INTRA_FRAME)) * 4;
    int leftType = 3, aboveType = 3;
    if (avail_l_) {
      size_t g = (size_t)mi_row_ * mi_cols_ + (mi_col_ - 1);
      if (ref0_grid_[g] == ref_frame_[0] || ref1_grid_[g] == ref_frame_[0]) {
        int packed = plans_->at(MI_INTERP, mi_row_, mi_col_ - 1);
        leftType = (packed >> (4 * dir)) & 15;
      }
    }
    if (avail_u_) {
      size_t g = (size_t)(mi_row_ - 1) * mi_cols_ + mi_col_;
      if (ref0_grid_[g] == ref_frame_[0] || ref1_grid_[g] == ref_frame_[0]) {
        int packed = plans_->at(MI_INTERP, mi_row_ - 1, mi_col_);
        aboveType = (packed >> (4 * dir)) & 15;
      }
    }
    if (leftType == aboveType)
      ctx += leftType;
    else if (leftType == 3)
      ctx += aboveType;
    else if (aboveType == 3)
      ctx += leftType;
    else
      ctx += 3;
    interp_filter_[dir] = r_.decode_symbol(cdf_->switchable_interp[ctx], 3);
  }
  if (!seq_.enable_dual_filter) interp_filter_[1] = interp_filter_[0];
}

// ---------------------------------------------------------------------------
// Local warp: sample collection + least-squares estimation
// [SPEC §7.10.4 find_warp_samples, §7.11.3.8 warp estimation]
// ---------------------------------------------------------------------------

void TileDecoder::add_warp_sample(int deltaRow, int deltaCol) {
  add_warp_sample_c(deltaRow, deltaCol, deltaRow, deltaCol);
}

void TileDecoder::add_warp_sample_c(int deltaRow, int deltaCol, int centerRow,
                                    int centerCol) {
  // [libaom record_samples]: sample centers derive from the SCAN position
  // with sign conventions (no snapping to the candidate's true origin):
  //   above row:  y = -candH/2 - 1,         x = deltaCol*4 + candW/2 - 1
  //   left col:   y = deltaRow*4 + candH/2 - 1,  x = -candW/2 - 1
  // (deltaRow = -1 encodes "above", deltaCol = -1 encodes "left")
  if (num_samples_scanned_ >= 8) return;
  int mvRow = mi_row_ + deltaRow;
  int mvCol = mi_col_ + deltaCol;
  if (!is_inside(mvRow, mvCol)) return;
  if (!is_decoded(mvRow, mvCol)) return;
  size_t g = (size_t)mvRow * mi_cols_ + mvCol;
  if (ref0_grid_[g] != ref_frame_[0]) return;
  if (ref1_grid_[g] != NONE_FRAME) return;
  int candSz = plans_->at(MI_BSIZE, mvRow, mvCol);
  int candW4 = kBlockWidth4[candSz], candH4 = kBlockHeight4[candSz];
  int midY, midX;  // sample center (pixels, frame-absolute)
  if (deltaRow < 0)
    midY = mi_row_ * 4 - candH4 * 2 - 1;
  else
    midY = (mi_row_ + centerRow) * 4 + candH4 * 2 - 1;
  if (deltaCol < 0)
    midX = mi_col_ * 4 - candW4 * 2 - 1;
  else
    midX = (mi_col_ + centerCol) * 4 + candW4 * 2 - 1;
  int threshold = std::clamp(std::max(bw4_ * 4, bh4_ * 4), 16, 112);
  int candMvRow = plans_->at(MI_MV0Y, mvRow, mvCol);
  int candMvCol = plans_->at(MI_MV0X, mvRow, mvCol);
  int mvDiffRow = std::abs(candMvRow - mv_[0][0]);
  int mvDiffCol = std::abs(candMvCol - mv_[0][1]);
  bool valid = (mvDiffRow + mvDiffCol) <= threshold;
  // invalid samples are kept only when nothing has been scanned yet
  // (they become the fallback single sample) [SPEC §7.10.4.2]
  if (!valid && num_samples_scanned_ > 0) {
    num_samples_scanned_++;
    return;
  }
  int idx = std::min(num_samples_, 7);
  cand_list_[idx][0] = midY * 8;
  cand_list_[idx][1] = midX * 8;
  cand_list_[idx][2] = midY * 8 + candMvRow;
  cand_list_[idx][3] = midX * 8 + candMvCol;
  if (valid) num_samples_++;
  num_samples_scanned_++;
}

void TileDecoder::find_warp_samples() {
  num_samples_ = 0;
  num_samples_scanned_ = 0;
  // top-right defaults available; a wider above block covering the
  // top-right corner disables it [libaom av1_findSamples]
  bool doTopLeft = true, doTopRight = true;
  if (avail_u_) {
    int srcSize = plans_->at(MI_BSIZE, mi_row_ - 1, mi_col_);
    int srcW4 = kBlockWidth4[srcSize];
    if (bw4_ <= srcW4) {
      int colOffset = -(mi_col_ & (srcW4 - 1));
      if (colOffset < 0) doTopLeft = false;
      if (colOffset + srcW4 > bw4_) doTopRight = false;
      add_warp_sample_c(-1, 0, -1, colOffset);
    } else {
      int miStep;
      for (int i = 0; i < std::min(bw4_, mi_cols_ - mi_col_); i += miStep) {
        srcSize = plans_->at(MI_BSIZE, mi_row_ - 1, mi_col_ + i);
        srcW4 = kBlockWidth4[srcSize];
        miStep = std::min(bw4_, srcW4);
        add_warp_sample(-1, i);
      }
    }
  }
  if (avail_l_) {
    int srcSize = plans_->at(MI_BSIZE, mi_row_, mi_col_ - 1);
    int srcH4 = kBlockHeight4[srcSize];
    if (bh4_ <= srcH4) {
      int rowOffset = -(mi_row_ & (srcH4 - 1));
      if (rowOffset < 0) doTopLeft = false;
      add_warp_sample_c(0, -1, rowOffset, -1);
    } else {
      int miStep;
      for (int i = 0; i < std::min(bh4_, mi_rows_ - mi_row_); i += miStep) {
        srcSize = plans_->at(MI_BSIZE, mi_row_ + i, mi_col_ - 1);
        srcH4 = kBlockHeight4[srcSize];
        miStep = std::min(bh4_, srcH4);
        add_warp_sample(i, -1);
      }
    }
  }
  if (doTopLeft) add_warp_sample(-1, -1);
  if (doTopRight && std::max(bw4_, bh4_) <= 16) add_warp_sample(-1, bw4_);
  if (num_samples_ == 0 && num_samples_scanned_ > 0) num_samples_ = 1;
  if (getenv("AV1N_SYN") && *getenv("AV1N_SYN") == '1') {
    fprintf(stderr, "  WSAMP r=%d c=%d n=%d scanned=%d:", mi_row_, mi_col_,
            num_samples_, num_samples_scanned_);
    for (int i = 0; i < std::min(num_samples_, 8); i++)
      fprintf(stderr, " (%d,%d,%d,%d)", cand_list_[i][0], cand_list_[i][1],
              cand_list_[i][2], cand_list_[i][3]);
    fprintf(stderr, "\n");
  }
}

namespace {

// Div_Lut [SPEC §7.11.3.7]: Div_Lut[f] = round(2^22 / (2^8 + f))
inline int div_lut(int f) { return ((1 << 22) + ((256 + f) >> 1)) / (256 + f); }

void resolve_divisor_64(int64_t d, int* divShift, int* divFactor) {
  // [SPEC §7.11.3.7 resolve_divisor]
  int64_t ad = std::abs(d);
  int n = 0;
  while ((ad >> n) > 1) n++;  // FloorLog2
  int64_t e = ad - ((int64_t)1 << n);
  int f;
  if (n > 8)
    f = (int)((e + ((int64_t)1 << (n - 9))) >> (n - 8));  // ROUND2(e, n-8)
  else
    f = (int)(e << (8 - n));
  *divShift = n + 14;  // DIV_LUT_PREC_BITS
  *divFactor = d < 0 ? -div_lut(f) : div_lut(f);
}

}  // namespace

void TileDecoder::warp_estimation() {
  // [SPEC §7.11.3.8] integer least-squares over the warp samples
  warp_invalid_ = 0;
  std::memset(warp_params_, 0, sizeof(warp_params_));
  warp_params_[2] = 1 << WARPEDMODEL_PREC_BITS;
  warp_params_[5] = 1 << WARPEDMODEL_PREC_BITS;

  // least-squares accumulators [SPEC §7.11.3.8 / libaom find_affine_int,
  // verified against the installed binary's disassembly]: samples get a
  // +4 (half-pel) centering, squares/"product2" a +16 rounding, then >>2,
  // with each accumulator clamped to +-2^22.
  auto ls_sq = [](int64_t a) { return ((a + 4) * (a + 4) + 16) >> 2; };
  auto ls_p1 = [](int64_t a, int64_t b) { return ((a + 4) * (b + 4)) >> 2; };
  auto ls_p2 = [](int64_t a, int64_t b) {
    return ((a + 4) * (b + 4) + 16) >> 2;
  };
  auto acc = [](int64_t& t, int64_t v) {
    t = std::clamp<int64_t>(t + v, -(1 << 22), (1 << 22) - 1);
  };

  int64_t A[2][2] = {{0, 0}, {0, 0}};
  int64_t Bx[2] = {0, 0}, By[2] = {0, 0};
  int midY = mi_row_ * 4 + bh4_ * 2 - 1;
  int midX = mi_col_ * 4 + bw4_ * 2 - 1;
  int suY = midY * 8, suX = midX * 8;
  int duY = suY + mv_[0][0], duX = suX + mv_[0][1];
  for (int i = 0; i < num_samples_; i++) {
    int sy = cand_list_[i][0] - suY;
    int sx = cand_list_[i][1] - suX;
    int dy = cand_list_[i][2] - duY;
    int dx = cand_list_[i][3] - duX;
    if (std::abs(sx - dx) < 256 && std::abs(sy - dy) < 256) {
      acc(A[0][0], ls_sq(sx));
      acc(A[0][1], ls_p1(sx, sy));
      acc(A[1][1], ls_sq(sy));
      acc(Bx[0], ls_p2(sx, dx));
      acc(Bx[1], ls_p1(sy, dx));
      acc(By[0], ls_p1(sx, dy));
      acc(By[1], ls_p2(sy, dy));
    }
  }
  int64_t det = A[0][0] * A[1][1] - A[0][1] * A[0][1];
  if (getenv("AV1N_SYN") && *getenv("AV1N_SYN") == '1') {
    fprintf(stderr,
            "  WEST r=%d c=%d A=[%ld %ld %ld] Bx=[%ld %ld] By=[%ld %ld] "
            "det=%ld\n",
            mi_row_, mi_col_, (long)A[0][0], (long)A[0][1], (long)A[1][1],
            (long)Bx[0], (long)Bx[1], (long)By[0], (long)By[1], (long)det);
  }
  if (det == 0) {
    warp_invalid_ = 1;
    return;
  }
  int divShift, divFactor;
  resolve_divisor_64(det, &divShift, &divFactor);
  divShift -= WARPEDMODEL_PREC_BITS;
  if (divShift < 0) {
    divFactor = divFactor * (1 << -divShift);
    divShift = 0;
  }
  constexpr int NDIAG_CLAMP = (1 << 13) - 1;  // +-8191
  constexpr int TRANS_MAX = (1 << 23) - 1;
  constexpr int TRANS_MIN = -(1 << 23);
  auto diag = [&](int64_t v) {
    int64_t r = round2_signed(v * divFactor, divShift);
    return (int32_t)std::clamp<int64_t>(
        r, (1 << WARPEDMODEL_PREC_BITS) - NDIAG_CLAMP,
        (1 << WARPEDMODEL_PREC_BITS) + NDIAG_CLAMP);
  };
  auto ndiag = [&](int64_t v) {
    int64_t r = round2_signed(v * divFactor, divShift);
    return (int32_t)std::clamp<int64_t>(r, -NDIAG_CLAMP, NDIAG_CLAMP);
  };
  warp_params_[2] = diag(A[1][1] * Bx[0] - A[0][1] * Bx[1]);
  warp_params_[3] = ndiag(A[0][0] * Bx[1] - A[0][1] * Bx[0]);
  warp_params_[4] = ndiag(A[1][1] * By[0] - A[0][1] * By[1]);
  warp_params_[5] = diag(A[0][0] * By[1] - A[0][1] * By[0]);

  int64_t vx = (int64_t)mv_[0][1] * (1 << (WARPEDMODEL_PREC_BITS - 3)) -
               ((int64_t)midX * (warp_params_[2] -
                                 (1 << WARPEDMODEL_PREC_BITS)) +
                (int64_t)midY * warp_params_[3]);
  int64_t vy = (int64_t)mv_[0][0] * (1 << (WARPEDMODEL_PREC_BITS - 3)) -
               ((int64_t)midX * warp_params_[4] +
                (int64_t)midY * (warp_params_[5] -
                                 (1 << WARPEDMODEL_PREC_BITS)));
  warp_params_[0] = (int32_t)std::clamp<int64_t>(vx, TRANS_MIN, TRANS_MAX);
  warp_params_[1] = (int32_t)std::clamp<int64_t>(vy, TRANS_MIN, TRANS_MAX);
  if (getenv("AV1N_SYN") && *getenv("AV1N_SYN") == '1') {
    fprintf(stderr, "  WPAR r=%d c=%d p=[%d %d %d %d %d %d]\n", mi_row_,
            mi_col_, warp_params_[0], warp_params_[1], warp_params_[2],
            warp_params_[3], warp_params_[4], warp_params_[5]);
  }
}

// ---------------------------------------------------------------------------
// Top-level inter mode info [SPEC §5.11.15, §5.11.22, §5.11.23]
// ---------------------------------------------------------------------------

int TileDecoder::intra_block_mode_info() {
  // intra block inside an inter frame [SPEC §5.11.22]
  palette_size_[0] = palette_size_[1] = 0;
  ref_frame_[0] = INTRA_FRAME;
  ref_frame_[1] = NONE_FRAME;
  y_mode_ = r_.decode_symbol(cdf_->if_y_mode[kSizeGroup[bsize_]],
                             INTRA_MODES);
  intra_angle_info_y();
  if (has_chroma_) {
    int cfl_allowed;
    if (hdr_.lossless[segment_id_]) {
      int cw4 = std::max(1, kBlockWidth4[bsize_] >> seq_.subsampling_x);
      int ch4 = std::max(1, kBlockHeight4[bsize_] >> seq_.subsampling_y);
      cfl_allowed = (cw4 == 1 && ch4 == 1);
    } else {
      cfl_allowed = kBlockWidth4[bsize_] <= 8 && kBlockHeight4[bsize_] <= 8;
    }
    uv_mode_ = r_.decode_symbol(cdf_->uv_mode[cfl_allowed][y_mode_],
                                cfl_allowed ? UV_INTRA_MODES
                                            : UV_INTRA_MODES - 1);
    if (uv_mode_ == UV_CFL_PRED) read_cfl_alphas();
    intra_angle_info_uv();
  } else {
    uv_mode_ = DC_PRED;
  }
  if (bsize_ >= BLOCK_8X8 && kBlockWidth4[bsize_] <= 16 &&
      kBlockHeight4[bsize_] <= 16 && hdr_.allow_screen_content_tools) {
    palette_mode_info();
  }
  filter_intra_mode_info();
  return 0;
}

int TileDecoder::inter_block_mode_info() {
  // [SPEC §5.11.23]
  palette_size_[0] = palette_size_[1] = 0;
  filter_intra_mode_ = -1;
  read_ref_frames();
  bool isCompound = ref_frame_[1] > INTRA_FRAME;
  find_mv_stack(isCompound);
  if (skip_mode_) {
    y_mode_ = NEAREST_NEARESTMV;
  } else if (seg_active(hdr_, segment_id_, SEG_LVL_SKIP) ||
             seg_active(hdr_, segment_id_, SEG_LVL_GLOBALMV)) {
    y_mode_ = GLOBALMV;
  } else if (isCompound) {
    // Compound_Mode_Ctx_Map [SPEC §9.3]
    static const uint8_t kCompModeCtxMap[3][5] = {
        {0, 1, 1, 1, 1}, {3, 4, 4, 4, 4}, {5, 6, 6, 6, 6}};
    int ctx = kCompModeCtxMap[ref_mv_ctx_ >> 1][std::min(new_mv_ctx_, 4)];
    int sym = r_.decode_symbol(cdf_->inter_compound_mode[ctx], 8);
    y_mode_ = NEAREST_NEARESTMV + sym;
  } else {
    int new_mv = r_.decode_bool(cdf_->newmv[new_mv_ctx_]);
    if (new_mv == 0) {
      y_mode_ = NEWMV;
    } else {
      int zero_mv = r_.decode_bool(cdf_->zeromv[zero_mv_ctx_]);
      if (zero_mv == 0) {
        y_mode_ = GLOBALMV;
      } else {
        int ref_mv = r_.decode_bool(cdf_->refmv[ref_mv_ctx_]);
        y_mode_ = ref_mv == 0 ? NEARESTMV : NEARMV;
      }
    }
  }
  ref_mv_idx_ = 0;
  if (y_mode_ == NEWMV || y_mode_ == NEW_NEWMV || has_nearmv(y_mode_))
    read_drl_idx();
  assign_mv(isCompound);
  read_interintra_mode(isCompound);
  read_motion_mode(isCompound);
  read_compound_type(isCompound);
  read_interp_filter();
  uv_mode_ = DC_PRED;
  angle_delta_y_ = angle_delta_uv_ = 0;
  cfl_alpha_idx_ = 0;
  cfl_signs_ = 0;
  return 0;
}

int TileDecoder::inter_frame_mode_info() {
  use_intrabc_ = 0;
  skip_ = 0;
  skip_mode_ = 0;
  is_inter_ = 0;
  segment_id_ = 0;
  palette_size_[0] = palette_size_[1] = 0;
  filter_intra_mode_ = -1;
  cfl_alpha_idx_ = 0;
  cfl_signs_ = 0;
  angle_delta_y_ = angle_delta_uv_ = 0;
  ref_frame_[0] = INTRA_FRAME;
  ref_frame_[1] = NONE_FRAME;
  mv_[0][0] = mv_[0][1] = mv_[1][0] = mv_[1][1] = 0;
  motion_mode_ = SIMPLE_MOTION;
  compound_type_ = PLAN_COMP_AVG;
  wedge_packed_ = 0;
  interintra_ = 0;
  ii_wedge_packed_ = 0;
  interp_filter_[0] = interp_filter_[1] = EIGHTTAP;
  num_samples_ = 0;
  warp_invalid_ = 1;

  inter_segment_id(1);
  read_skip_mode();
  if (skip_mode_)
    skip_ = 1;
  else
    read_skip();
  if (!hdr_.seg.seg_id_pre_skip) inter_segment_id(0);
  read_cdef();
  read_delta_qindex();
  read_delta_lf();
  read_deltas_ = 0;
  read_is_inter();
  if (is_inter_)
    return inter_block_mode_info();
  return intra_block_mode_info();
}

}  // namespace av1
