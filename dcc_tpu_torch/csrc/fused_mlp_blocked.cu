// K2, the trunk forward, in the column-blocked layout: fused_mlp.cu built with
// DCC_WIDE and DCC_BLOCKED (csrc/trunk_mma.cuh: the later layers' input and
// the activations in the block's scratch in device memory, the input
// streamed through the weight ring) as a library of its own, which the
// wrappers launch where no other layout's tile fits (ops.tiles.plan).
#define DCC_WIDE 1
#define DCC_BLOCKED 1
#include "fused_mlp.cu"
