"""The row tiles of the fused kernels and their shared memory.

``SIZES`` lists, per kernel and mode, the row tiles its wrapper chooses
among, largest first. :func:`smem_bytes` asks the kernel's own library (the
``*_smem_bytes`` entries of ``csrc/fused_mlp.cu``, ``csrc/fused_mlp_bwd.cu``
and ``csrc/fused_ppo.cu``; the f32 K2's size is its wrapper's formula), so
a launch and MAPPO's check at construction read one layout. The kernels
stage whole rows in shared memory; where a row is too wide for the
smallest staged tile, the bf16 kernels stream their first layer over d_in
in column chunks instead (``CHUNKED``, :func:`plan`), whose shared memory
does not grow with d_in. So every kernel takes rows of any width in bf16.
The f32 FMA kernels have no chunked layout; their one-row tiles take rows
up to 28,161 columns (the unfolded K3u / K4u, hidden 256, two layers) and
more for the others.

The hidden width sets the rest of a tile's shared memory (activations,
cotangents, one column pass of the weight ring). Past 256 the bf16 kernels
run each layer in column passes. ``LAST`` offers the bf16 actor kernels a
16-row staged tile, taken only where no larger tile fits in either layout
(hidden widths of 768 and more), so that the launches that fit at
narrower widths keep their tiles. Where the smallest tile fits one block
in none of the staged, chunked, ``LAST`` or depth layouts (past about
1,024 at two layers for the gradient kernels, 2,800 for K2 at 440-wide
rows), the bf16 kernels take their column-blocked layout (``BLOCKED``,
the ``*_blocked`` libraries): every tile as wide as the hidden layer lives
in a per-block scratch in device memory (:func:`scratch_bytes`), and the
shared memory, layer 0's operand (staged or chunked), the weight ring and
the per-row values, does not grow with the hidden width. So in bf16 every
hidden width is taken.

The depth of the trunk sets the rest. The bf16 gradient kernels (K2b, K3 /
K4, K3u / K4u) keep every layer's activations and LN statistics in shared
memory, so at hidden 256 their smallest tiles hold 13 to 15 layers. Past
that they take their depth layout (``DEEP``), staged or
chunked, whose shared memory holds one layer's tile and does not grow with
the depth; the other layers' tiles go to a scratch in device memory
(:func:`scratch_bytes` a block). :func:`plan` takes it only where no
staged, chunked or ``LAST`` tile holds the stack, so every launch that fits
those keeps its layout and its tile.
"""

from __future__ import annotations

from typing import NamedTuple

from . import cuda_build as cb

SMEM_MAX = 232448  # an H100 block's shared memory, bytes

# the row tiles each wrapper chooses among, largest first, by (kernel, bf16)
SIZES = {
    ("fused_mlp", True): (64, 32, 16), ("fused_mlp", False): (32, 8, 1),
    ("fused_mlp_bwd", True): (64, 32, 16), ("fused_mlp_bwd", False): (32, 16, 8, 1),
    ("actor_ppo_grads", True): (64, 32), ("actor_ppo_grads", False): (32, 8, 1),
    ("critic_ppo_grads", True): (32, 16), ("critic_ppo_grads", False): (32, 8, 1),
    ("actor_ppo_grads_unfolded", True): (64, 32),
    ("actor_ppo_grads_unfolded", False): (32, 16, 8, 1),
    ("critic_ppo_grads_unfolded", True): (32, 16),
    ("critic_ppo_grads_unfolded", False): (32, 16, 8, 1),
    # the layer-0 input backward of the chunked K2b and K4u
    ("layer0_input_bwd", True): (64, 32, 16),
}


# row tiles offered only where none of SIZES' fits, by (kernel, bf16)
LAST = {("actor_ppo_grads", True): (16,), ("actor_ppo_grads_unfolded", True): (16,)}

# the kernels with a chunked first layer, taken where no staged tile fits,
# and the row tiles of that layout: bf16 K3, K4, K3u and K4u
# (``csrc/fused_ppo.cu``, ``actor_grads_chunked_mma_kernel``,
# ``critic_grads_chunked_mma_kernel`` and their unfolded twins), bf16 K2
# (``csrc/fused_mlp.cu``, ``trunk_fwd_chunked_mma_kernel``) and bf16 K2b
# (``csrc/fused_mlp_bwd.cu``, ``trunk_bwd_chunked_mma_kernel``)
CHUNKED = {("critic_ppo_grads", True): (32, 16), ("critic_ppo_grads_unfolded", True): (32, 16),
           ("actor_ppo_grads", True): (32, 16), ("actor_ppo_grads_unfolded", True): (32, 16),
           ("fused_mlp", True): (32, 16), ("fused_mlp_bwd", True): (32, 16)}


# the bf16 gradient kernels with a depth layout (staged or, where they have
# one, chunked), taken where no tile of their other layouts holds the
# trunk's layers, and the row tiles of its staged form (its chunked form
# takes CHUNKED's): K2b (``csrc/fused_mlp_bwd.cu``) and K3, K4, K3u, K4u
# (``csrc/fused_ppo.cu``), each with the ``deep`` scratch argument set
DEEP = {key: SIZES[key] for key in (
    ("fused_mlp_bwd", True), ("actor_ppo_grads", True), ("critic_ppo_grads", True),
    ("actor_ppo_grads_unfolded", True), ("critic_ppo_grads_unfolded", True))}


# the bf16 kernels' column-blocked layout (the ``*_blocked`` libraries), taken
# where no tile of their other layouts fits, and the row tiles of its staged
# form (its chunked form takes CHUNKED's): K2, K2b, K3, K4, K3u, K4u and the
# row-tiled layer-0 input backward
BLOCKED = {key: SIZES[key] + LAST.get(key, ()) for key in (
    ("fused_mlp", True), ("fused_mlp_bwd", True), ("actor_ppo_grads", True),
    ("critic_ppo_grads", True), ("actor_ppo_grads_unfolded", True),
    ("critic_ppo_grads_unfolded", True), ("layer0_input_bwd", True))}


class Plan(NamedTuple):
    """A kernel's row tiles as :func:`plan` gives them: ``chunked``, its
    chunked first layer; ``tiles``, largest first; ``deep``, its depth
    layout; ``blocked``, its column-blocked layout."""
    chunked: bool
    tiles: list
    deep: bool = False
    blocked: bool = False


def smem_bytes(kernel: str, bf16: bool, br: int, d_in: int, hidden: int, n_layers: int,
               n_head: int = 1, chunked: bool = False, deep: bool = False,
               blocked: bool = False) -> int:
    """Shared memory of one ``br``-row tile of ``kernel`` (a key of
    ``ops.LAUNCHES``; ``n_head``: the actor head's width; ``chunked``: its
    chunked layout; ``deep``: its depth layout, ``DEEP``; ``blocked``: its
    column-blocked layout, ``BLOCKED``), from its library (built on first
    use)."""
    mma = "_mma" if bf16 else ""
    ch = "_chunked" if chunked else ""
    lib = lambda name: cb.library(f"{name}_blocked" if blocked else name)
    if kernel == "fused_mlp":
        if not bf16:
            return 4 * br * (max(d_in, hidden) + hidden)
        return getattr(lib("fused_mlp"), f"dcc_trunk_fwd_mma{ch}_smem_bytes")(
            br, d_in, hidden)
    if kernel == "layer0_input_bwd":
        return lib("fused_mlp_bwd").dcc_layer0_input_bwd_smem_bytes(br, hidden)
    args = (int(deep),) if bf16 else ()
    if kernel == "fused_mlp_bwd":
        fn = getattr(lib("fused_mlp_bwd"), f"dcc_trunk_bwd{mma}{ch}_smem_bytes")
        return fn(br, d_in, hidden, n_layers, *args)
    tag = "_unfolded" if kernel.endswith("_unfolded") else ""
    fn = getattr(lib("fused_ppo"), f"dcc_ppo{tag}{mma}{ch}_smem_bytes")
    return fn(br, d_in, hidden, n_layers, n_head, *args)


def scratch_bytes(kernel: str, p: Plan, br: int, d_in: int, hidden: int, n_layers: int) -> int:
    """Bytes of one block's scratch in device memory of a bf16 launch of
    ``kernel`` on the plan ``p``, from the library: 0 in the staged and
    chunked layouts; in the depth layout each layer's bf16 activation tile
    (br x (pad16(hidden) + 8)), its rows' LN mean and 1/sqrt(var + eps),
    and the weights' column norms; in the column-blocked layout also the
    operand, cotangent, f32 stages, column sums and head weights (K2: a
    later layer's input and the activations; the layer-0 input backward:
    none)."""
    if p.blocked:
        if kernel == "fused_mlp":
            return cb.library("fused_mlp_blocked").dcc_trunk_fwd_scratch_bytes(br, hidden)
        if kernel == "layer0_input_bwd":
            return 0
        return cb.library("fused_mlp_bwd_blocked").dcc_blocked_scratch_bytes(
            br, d_in, hidden, n_layers, int(p.chunked))
    if p.deep:
        return cb.library("fused_mlp_bwd").dcc_deep_scratch_bytes(br, hidden, n_layers)
    return 0


def plan(kernel: str, bf16: bool, d_in: int, hidden: int, n_layers: int,
         n_head: int = 1, blocked: bool = False) -> Plan:
    """The :class:`Plan` of ``kernel``: the row tiles of ``kernel`` that fit
    one block at this width with whole rows staged, or, where none does and
    the kernel has a chunked first layer, those of its chunked layout
    (chunked True); ``LAST``'s staged tiles where neither layout has a
    larger one; where none of those holds the trunk's layers, the depth
    layout's (``DEEP``; staged, else chunked), with ``deep`` True; where
    none of those fits (in bf16), the column-blocked layout's (``BLOCKED``),
    with ``blocked`` True: chunked where the kernel's rows are, at this
    width, too wide for its staged tiles at hidden 256 (so that a row's
    width alone decides its first layer, as at the widths the other layouts
    take), else staged where a tile fits. ``blocked`` forces that layout on
    the tiles and first layer the kernel takes otherwise (the checks that
    hold the layouts against each other on one tile)."""
    key = (kernel, bf16)
    fits = lambda sizes, ch=False, deep=False, blk=False: [
        b for b in sizes if smem_bytes(kernel, bf16, b, d_in, hidden, n_layers, n_head, ch,
                                       deep, blocked=blk) <= SMEM_MAX]
    wide_rows = lambda: key in CHUNKED and plan(kernel, bf16, d_in, 256, n_layers, n_head).chunked
    p = _plan(key, fits, wide_rows)
    if blocked and not p.blocked:
        return Plan(p.chunked, fits(p.tiles, p.chunked, blk=True), blocked=True)
    return p


def _plan(key, fits, wide_rows) -> Plan:
    """:func:`plan`'s layouts in turn, ``fits`` the tiles of a layout that
    fit one block, ``wide_rows()`` whether the column-blocked layout takes
    the chunked first layer."""

    def column_blocked():
        staged = [] if wide_rows() else fits(BLOCKED[key], blk=True)
        if staged:
            return Plan(False, staged, blocked=True)
        return Plan(key in CHUNKED, fits(CHUNKED.get(key, ()), True, blk=True), blocked=True)

    staged = fits(SIZES[key])
    if staged:
        return Plan(False, staged)
    chunked, last = fits(CHUNKED.get(key, ()), True), fits(LAST.get(key, ()))
    if last and max(chunked, default=0) <= max(last):  # no larger tile fits
        return Plan(False, last)
    if chunked:
        return Plan(True, chunked)
    if key in DEEP:
        deep = fits(DEEP[key], deep=True)
        if deep:
            return Plan(False, deep, deep=True)
        deep = fits(CHUNKED.get(key, ()), True, True)
        if deep:
            return Plan(key in CHUNKED, deep, deep=True)
    if key in BLOCKED:
        return column_blocked()
    return Plan(key in CHUNKED, [])


# The layer-0 tail on the warpgroup tensor cores (``csrc/layer0_tail.cu``):
# dV0 (``dv0_wgmma_kernel``) and the layer-0 input backward without dx
# (``layer0_input_bwd_wgmma_kernel``). A block owns ``TAIL_KB`` columns of x
# (and for dV0 one pass of ``DV0_N`` of g0's columns) and one row split, a
# whole number of steps of ``TAIL_STEP`` rows; its shared memory does not
# grow with d_in. The layer-0 input backward keeps W_0's slice resident and
# takes hidden widths to ``TAIL_HMAX`` (the dx mode and wider layers keep
# the row-tiled kernel of ``csrc/fused_mlp_bwd.cu``). How x reaches shared
# memory sets the stages (``TAIL_XMODES``): dV0 takes rows whose pointer
# and stride are 16-byte aligned by TMA (bf16 straight into the swizzled
# operand, f32 into a raw stage) and other rows as windows of aligned
# 16-byte pieces (``TAIL_WIN`` bytes a row), also by TMA, through a view of
# x whose rows hold a few of its rows; the layer-0 input backward copies
# aligned bf16 rows into the swizzled layout and every other row (f32 ones
# too) as windows, by cp.async.
TAIL_KB = 128
DV0_N = 128
TAIL_HMAX = 256
TAIL_STEP = {"dv0": 64, "layer0_input_bwd": 64}
TAIL_XMODES = ("bf16", "bf16_window", "f32", "f32_window")
TAIL_WIN = {"bf16": 0, "bf16_window": 272, "f32": 528, "f32_window": 528}
TAIL_STAGES = {"dv0": {"bf16": 6, "bf16_window": 4, "f32": 3, "f32_window": 3},
               "layer0_input_bwd": {"bf16": 3, "bf16_window": 3, "f32": 2, "f32_window": 2}}
# the split count is the smallest that fills whole waves of the SMs to this share
TAIL_WAVE_FILL = 0.95
TAIL_MAX_SPLITS = 256


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def tail_smem_bytes(kernel: str, xmode: str, hidden: int) -> int:
    """Shared memory of one block of the layer-0 tail ``kernel`` ("dv0" or
    "layer0_input_bwd") with x copied in ``xmode``, as ``dv0_layout`` /
    ``l0w_layout`` of ``csrc/layer0_tail.cu`` lay it out (with the 1,024
    bytes of alignment slack); the library's ``*_smem_bytes`` entries give
    the same number."""
    s, rs, win = TAIL_STAGES[kernel][xmode], TAIL_STEP[kernel], TAIL_WIN[xmode]
    if kernel == "dv0":  # the f32 rows by TMA: 4 boxes of 32 columns (512 bytes a row)
        raw = rs * (512 if xmode == "f32" else win)
        return s * (2 * rs * 128 + 2 * rs * 128 + raw + rs * 8) + 2 * s * 8 + 1024
    nb = -(-_pad16(hidden) // 64)
    per = nb * rs * 128 + rs * (256 if xmode == "bf16" else win) + rs * 8
    return nb * TAIL_KB * 128 + s * per + 8 * 2 * TAIL_KB * 4 + (2 * s + 1) * 8 + 1024


def tail_plan(kernel: str, rows: int, d_in: int, hidden: int, sms: int) -> tuple:
    """(splits, rows a split, blocks a split) of the layer-0 tail
    ``kernel``: the blocks of one split are the column blocks of x (times
    dV0's passes over g0's columns); the split count is the smallest that
    fills whole waves of ``sms`` blocks (one an SM) to ``TAIL_WAVE_FILL``,
    or else the fullest, each split a whole number of steps."""
    step = TAIL_STEP[kernel]
    units = -(-d_in // TAIL_KB)
    if kernel == "dv0":
        units *= -(-_pad16(hidden) // DV0_N)
    most = max(1, min(TAIL_MAX_SPLITS, -(-rows // step)))
    best, fill = 1, 0.0
    for s in range(1, most + 1):
        blocks = units * s
        f = blocks / (-(-blocks // sms) * sms)
        if f > fill + 1e-12:
            best, fill = s, f
        if f >= TAIL_WAVE_FILL:
            break
    split_rows = -(-(-(-rows // best)) // step) * step
    return best, split_rows, units


def tail_blocks(kernel: str, rows: int, d_in: int, hidden: int, sms: int) -> list:
    """Every block of the layer-0 tail ``kernel`` as the kernel walks it:
    (split, first and last row + 1, first and last column of x + 1, first
    and last column of g0 + 1), empty ranges clipped to length 0."""
    splits, split_rows, _ = tail_plan(kernel, rows, d_in, hidden, sms)
    n_step = DV0_N if kernel == "dv0" else _pad16(hidden)
    out = []
    for sp in range(splits):
        r0 = min(rows, sp * split_rows)
        r1 = min(rows, r0 + split_rows)
        for k0 in range(0, d_in, TAIL_KB):
            for n0 in range(0, _pad16(hidden), n_step):
                out.append((sp, r0, r1, k0, min(d_in, k0 + TAIL_KB), n0, min(hidden, n0 + n_step)))
    return out
