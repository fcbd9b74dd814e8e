// K2b, the trunk backward, at any hidden width: fused_mlp_bwd.cu built with DCC_WIDE
// (csrc/trunk_mma.cuh: layers in column passes past MMA_HMAX, odd widths
// element by element) as a library of its own, which the wrappers launch
// where the width is odd or pad16(H) > MMA_HMAX.
#define DCC_WIDE 1
#include "fused_mlp_bwd.cu"
