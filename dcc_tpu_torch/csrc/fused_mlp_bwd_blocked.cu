// K2b and the row-tiled layer-0 input backward in the column-blocked layout:
// fused_mlp_bwd.cu built with DCC_WIDE and DCC_BLOCKED (csrc/trunk_mma.cuh:
// every tile H wide in the block's scratch in device memory, streamed
// through the weight ring or staged in column blocks) as a library of its
// own, which the wrappers launch where no other layout's tile fits
// (ops.tiles.plan).
#define DCC_WIDE 1
#define DCC_BLOCKED 1
#include "fused_mlp_bwd.cu"
