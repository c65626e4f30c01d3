// Plan tensors: the host->device interface.
//
// The entropy layer emits, per frame, dense fixed-layout arrays that the
// JAX/Pallas pixel pipeline consumes as batched integer tensors
// (SURVEY.md §7.1: "dense, fixed-shape plans").  Everything block-level
// is replicated onto the 4x4 mode-info grid; transform blocks are a
// record stream in decode order (which is also the intra dependency
// order).
#pragma once

#include <cstdint>
#include <vector>

namespace av1 {

// int16 per-mi fields, field-major: mi[field][mi_rows][mi_cols]
enum MiField : int {
  MI_BSIZE = 0,       // BlockSize at this mi
  MI_MODE,            // Y prediction mode (intra modes or inter modes)
  MI_UV_MODE,         // UV mode (13 = CFL)
  MI_ANGLE_Y,         // angle delta y [-3..3]
  MI_ANGLE_UV,
  MI_SKIP,
  MI_SEG_ID,
  MI_CFL_ALPHA_IDX,   // joint alpha index (u<<4 | v as coded)
  MI_CFL_SIGNS,       // joint sign symbol 0..7
  MI_FILTER_INTRA,    // -1 = off, else FilterIntraMode
  MI_PALETTE_Y,       // palette size (0 = off)
  MI_PALETTE_UV,
  MI_TX_SIZE,         // block-level (luma) tx size
  MI_QINDEX,          // effective qindex (CurrentQIndex + seg delta, clamped)
  MI_DELTA_LF0,       // per-mi deltaLF values (post-accumulation)
  MI_DELTA_LF1,
  MI_DELTA_LF2,
  MI_DELTA_LF3,
  MI_CDEF,            // cdef strength index per 64x64 (-1 none)
  MI_IS_INTER,
  MI_INTRABC,
  MI_REF0,
  MI_REF1,
  MI_MV0X,            // 1/8-pel
  MI_MV0Y,
  MI_MV1X,
  MI_MV1Y,
  MI_INTERP,          // packed: horiz | vert<<4
  MI_MOTION_MODE,     // 0 SIMPLE, 1 OBMC, 2 WARPED
  MI_COMPOUND_TYPE,   // 0 avg, 1 distance-weighted, 2 wedge, 3 diffwtd
  MI_WEDGE,           // compound mask params: wedge idx|sign<<4, or diffwtd
                      // mask_type
  MI_LOSSLESS,
  MI_BX,              // block origin (mi units) — every mi in a block
  MI_BY,              //   points at its block's top-left mi
  MI_INTERINTRA,      // 0 = off, else interintra_mode + 1
  MI_II_WEDGE,        // interintra wedge: use_wedge<<4 | wedge_idx
  MI_SKIP_MODE,
  N_MI_FIELDS,
};

// TX record: fixed int32 fields per transform block, in decode order.
enum TxRecField : int {
  TXR_PLANE = 0,
  TXR_X4,        // plane-relative position in 4-sample units
  TXR_Y4,
  TXR_TX_SIZE,   // TxSize enum; 19 = lossless WHT4x4 marker
  TXR_TX_TYPE,
  TXR_EOB,       // 0 => no coefficients
  TXR_COEF_OFF,  // offset into coeffs[] (w*h int32), -1 if eob==0
  TXR_MI,        // owning mi index: mi_row * mi_cols + mi_col (luma grid)
  TXR_AVAIL,     // bit0 haveLeft, bit1 haveAbove, bit2 haveAboveRight,
                 // bit3 haveBelowLeft  [SPEC §5.11.35 -> §7.11.2 args]
  N_TXR_FIELDS,
};
constexpr int TX_WHT_MARKER = 19;

// Palette record: block origin + colors
struct PaletteRecord {
  int32_t mi_row, mi_col;
  int32_t size;     // Y palette size (0 = none)
  int32_t size_uv;  // UV palette size (0 = none)
  int32_t colors[3][8];  // [y/u/v][idx]
};

struct LrUnit {
  int32_t plane, unit_row, unit_col;
  int32_t type;         // RestorationType
  int32_t wiener[2][3];  // [pass][tap]
  int32_t sgr_set;
  int32_t sgr_xqd[2];
};

// Local-warp parameters for one WARPED_CAUSAL block [SPEC §7.11.3.8]
struct WarpRecord {
  int32_t mi;        // mi_row * mi_cols + mi_col of the block origin
  int32_t invalid;   // 1 if warp params invalid -> fall back to translation
  int32_t params[6];
};

struct FramePlans {
  int mi_rows = 0, mi_cols = 0;
  int mi_row0 = 0, mi_col0 = 0;     // grid origin (tile-local plans)
  std::vector<int16_t> mi;          // [N_MI_FIELDS][mi_rows][mi_cols]
  std::vector<int32_t> tx_records;  // [n_tx][N_TXR_FIELDS]
  std::vector<int32_t> coeffs;      // concatenated residual levels
  std::vector<PaletteRecord> palettes;
  std::vector<uint8_t> color_map;   // palette index maps, concatenated
  std::vector<int32_t> color_map_off;  // per palette record: [y_off, uv_off]
  std::vector<LrUnit> lr_units;
  std::vector<WarpRecord> warps;

  int16_t* grid(int field) { return mi.data() + (size_t)field * mi_rows * mi_cols; }
  int16_t& at(int field, int r, int c) {
    return mi[(size_t)field * mi_rows * mi_cols +
              (size_t)(r - mi_row0) * mi_cols + (c - mi_col0)];
  }
  void init(int rows, int cols, int row0 = 0, int col0 = 0) {
    mi_rows = rows;
    mi_cols = cols;
    mi_row0 = row0;
    mi_col0 = col0;
    mi.assign((size_t)N_MI_FIELDS * rows * cols, 0);
    tx_records.clear();
    coeffs.clear();
    palettes.clear();
    color_map.clear();
    color_map_off.clear();
    lr_units.clear();
    warps.clear();
  }
};

}  // namespace av1
