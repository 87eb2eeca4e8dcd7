"""The kernels' launch plans, chosen in Python from shapes alone.

``gather_gemm`` splits the offsets across blocks where the row x Cout
tiles are too few to fill the card; ``conv_dw`` fits its Cout tile to Cout
and splits the output rows across blocks.  Both sum their splits in order
in a second pass, through a workspace kept within its cap.  These tests
check the plans at every distinct sparse conv of a MinkUNet34 training step
on a batch of two room scans (51,028 / 12,533 / 2,817 / 618 / 125 rows at
strides 1-16), of MinkowskiFCNN, and of CompletionNet and the VAE, for an
H100's 132 SMs.  Nothing here needs a card.
"""

import pytest

from minkowskiengine_tpu_torch.kernels import conv_dw as dw
from minkowskiengine_tpu_torch.kernels import gather_gemm as gg

SMS = 132  # an H100 SXM

# (K, Cin, Cout, rows in, rows out): the 24 distinct sparse convs of a step
STEP_CONVS = [
    (125, 3, 32, 51028, 51028),
    (8, 32, 32, 51028, 12533),
    (27, 32, 32, 12533, 12533),
    (8, 32, 32, 12533, 2817),
    (27, 32, 64, 2817, 2817),
    (27, 64, 64, 2817, 2817),
    (8, 64, 64, 2817, 618),
    (27, 64, 128, 618, 618),
    (27, 128, 128, 618, 618),
    (8, 128, 128, 618, 125),
    (27, 128, 256, 125, 125),
    (27, 256, 256, 125, 125),
    (8, 256, 256, 125, 618),
    (27, 384, 256, 618, 618),
    (27, 256, 256, 618, 618),
    (8, 256, 128, 618, 2817),
    (27, 192, 128, 2817, 2817),
    (27, 128, 128, 2817, 2817),
    (8, 128, 96, 2817, 12533),
    (27, 128, 96, 12533, 12533),
    (27, 96, 96, 12533, 12533),
    (8, 96, 96, 12533, 51028),
    (27, 128, 96, 51028, 51028),
    (27, 96, 96, 51028, 51028),
]
CLASSIFICATION_CONVS = [
    (27, 32, 48, 47834, 47834),
    (27, 48, 64, 27633, 9538),
    (27, 64, 96, 3012, 1142),
    (27, 96, 128, 262, 246),
    (27, 336, 256, 47834, 27633),
    (27, 256, 512, 27633, 9538),
    (27, 512, 1024, 9538, 3012),
    (1, 64, 64, 9538, 3012),
    (1, 64, 128, 3012, 1142),
    (1, 128, 256, 1142, 262),
    (1, 256, 512, 262, 246),
]
# CompletionNet's and the VAE's distinct convs on one stand-in batch of 16
# shapes at 128^3 (chip_smoke.py phase 15), and the stride-1 level of a
# CompletionNet training step (4,716,408 rows): Cin = 1 stems, Cout = 16,
# the k = 4 generative conv (K = 64) and the k = 2 ones (K = 8, 8x rows out)
GENERATIVE_CONVS = [
    (27, 1, 16, 342916, 342916), (8, 16, 32, 342916, 88409), (27, 32, 32, 88409, 88409),
    (8, 32, 64, 88409, 22324), (27, 64, 64, 22324, 22324), (8, 64, 128, 22324, 5524),
    (27, 128, 128, 5524, 5524), (8, 128, 256, 5524, 1352), (27, 256, 256, 1352, 1352),
    (8, 256, 512, 1352, 294), (27, 512, 512, 294, 294), (8, 512, 1024, 294, 58),
    (27, 1024, 1024, 58, 58), (64, 1024, 512, 122, 3384), (27, 512, 512, 3384, 3384),
    (8, 512, 256, 624, 4992), (27, 256, 256, 4992, 4992), (8, 256, 128, 2872, 22976),
    (27, 128, 128, 22976, 22976), (8, 128, 64, 11771, 94168), (27, 64, 64, 94168, 94168),
    (8, 64, 32, 47608, 380864), (27, 32, 32, 380864, 380864), (8, 32, 16, 188884, 1511072),
    (27, 16, 16, 1511072, 1511072), (27, 16, 16, 4716408, 4716408),
    (27, 1, 16, 734353, 188884), (27, 16, 16, 188884, 188884), (27, 16, 32, 188884, 47608),
    (27, 64, 128, 11771, 2872), (27, 512, 1024, 122, 16), (27, 1024, 1024, 16, 16),
    (8, 1024, 512, 16, 128), (27, 512, 512, 128, 128),
]
CONVS = STEP_CONVS + CLASSIFICATION_CONVS + GENERATIVE_CONVS
IDS = [f"k{k}-{ci}to{co}-{n_in}to{n_out}" for k, ci, co, n_in, n_out in CONVS]


def _check_offset_split(n_out, k_vol, cin, cout):
    """The float32 ``mma.sync`` body's plan (asked for: the plan gives these
    widths the wgmma body, ``test_f32_wgmma_plans``), or the SIMT stem's."""
    p = gg.plan(n_out, k_vol, cin, cout, SMS, body="simt" if cin <= 4 else "mma")
    tiles = -(-n_out // gg.ROWS_PER_TILE) * -(-cout // gg.COUT_PER_TILE)
    assert 1 <= p.splits <= k_vol
    assert p.offsets_per_split * (p.splits - 1) < k_vol <= p.offsets_per_split * p.splits
    assert p.workspace_bytes(n_out, cout) <= gg.WORKSPACE_CAP
    # the grid fills the SMs, unless every offset already has its own range
    # or the workspace cap binds
    capped = 4 * (p.splits + 1) * n_out * cout > gg.WORKSPACE_CAP
    assert tiles * p.splits >= SMS or p.offsets_per_split == 1 or capped
    if tiles >= gg.BLOCKS_PER_SM * SMS:
        assert p.splits == 1  # enough tiles: no workspace, no second pass
    assert p.body == ("simt" if cin <= 4 else "mma")
    assert p.vec == (4 if cin % 4 == 0 and cout % 4 == 0 else 1)
    return p


@pytest.mark.parametrize("k_vol,cin,cout,n_in,n_out", CONVS, ids=IDS)
def test_gather_gemm_offset_split(k_vol, cin, cout, n_in, n_out):
    """K1 forward on the map, and as the input gradient on the inverse map
    with W[k] transposed (Cin and Cout swap, the rows come out at n_in)."""
    fwd = _check_offset_split(n_out, k_vol, cin, cout)
    dx = _check_offset_split(n_in, k_vol, cout, cin)
    for n, p in ((n_out, fwd), (n_in, dx)):
        if n >= 51028:
            assert p.splits == 1
        if n <= 618 and k_vol > 1:  # the deep levels, where the split is the point
            assert p.splits > 1


@pytest.mark.parametrize("k_vol,cin,cout,n_in,n_out", CONVS, ids=IDS)
def test_conv_dw_row_split_and_tiles(k_vol, cin, cout, n_in, n_out):
    p = dw.plan(k_vol, cin, cout, n_out, SMS)
    scans = -(-n_out // dw.ROWS_PER_SCAN)
    assert 1 <= p.splits <= scans
    assert p.workspace_bytes(k_vol, cin, cout) <= dw.WORKSPACE_CAP
    capped = 4 * (p.splits + 1) * k_vol * cin * cout > dw.WORKSPACE_CAP
    assert p.blocks(k_vol, cin, cout) * p.splits >= SMS or p.splits == scans or capped
    if cin <= 4:
        assert (p.body, p.cin_tile, p.cout_tile) == ("simt", 4, 64)
    else:
        assert p.body == "mma" and p.vec == 4
        assert p.cin_tile in (32, 64) and cin % 16 == 0  # m16 fragments; no ragged Cin on the path
        assert p.cout_tile in dw.COUT_TILES and p.cout_tile % 8 == 0  # mma n = 8
        n_tiles = -(-cout // p.cout_tile)
        assert n_tiles * p.cout_tile - cout < 32  # less than one 32-wide step of padding
    if (k_vol, cin, cout, n_out) == (27, 96, 96, 51028):
        assert p.cout_tile == 96 and p.splits > 1  # one 96-wide tile, not 2 x 64
    if cout == 1024:
        assert p.cout_tile == 128 and p.splits == 1  # eight tiles; one split's partials pass the cap


@pytest.mark.parametrize(
    "cout,tile", [(8, 32), (32, 32), (64, 64), (70, 96), (96, 96), (128, 128), (130, 96), (256, 128)]
)
def test_conv_dw_cout_tile(cout, tile):
    assert dw.cout_tile(cout) == tile


def test_narrow_or_unaligned_operands_take_four_byte_copies():
    assert gg.plan(1000, 27, 5, 64, SMS).vec == 1
    assert gg.plan(1000, 27, 64, 70, SMS).vec == 1
    assert gg.plan(1000, 27, 64, 64, SMS, aligned=False).vec == 1
    assert dw.plan(27, 5, 64, 1000, SMS).vec == 1
    assert dw.plan(27, 64, 70, 1000, SMS).vec == 1
    assert dw.plan(27, 64, 64, 1000, SMS, aligned=False).vec == 1
    assert dw.plan(27, 64, 64, 1000, SMS).vec == 4


def test_workspace_cap_bounds_the_split():
    # 384 -> 256 at K = 27: one split's partials are 10.6 MB, so only one fits
    assert dw.plan(27, 384, 256, 618, SMS).splits == 1
    # a huge output with few tiles: the offset split stops at the cap
    p = gg.plan(20000, 27, 64, 64, 10_000)
    assert p.splits == 3 and p.workspace_bytes(20000, 64) <= gg.WORKSPACE_CAP


def test_generative_plans():
    """The new cases of the generative slice: the k = 4 conv (K = 64, 1024 ->
    512) on 122 rows in, 3,384 out, and its input gradient on 122 rows; Cout
    = 16, a multiple of 4, keeps K2's 16-byte copies inside a 32-wide tile."""
    fwd = gg.plan(3384, 64, 1024, 512, SMS, body="mma")
    assert fwd.splits == 1 and fwd.body == "mma" and fwd.vec == 4
    assert gg.plan(3384, 64, 1024, 512, SMS).body == "wgmma_3xtf32"
    dx = gg.plan(122, 64, 512, 1024, SMS, body="mma")
    assert dx.splits == 8 and dx.offsets_per_split == 8
    assert dx.workspace_bytes(122, 1024) <= gg.WORKSPACE_CAP
    p = dw.plan(27, 16, 16, 4716408, SMS)
    assert (p.body, p.cin_tile, p.cout_tile, p.vec) == ("mma", 32, 32, 4)
    assert dw.plan(27, 1, 16, 342916, SMS).body == "simt"
    assert gg.plan(342916, 27, 16, 1, SMS).vec == 1  # phase 15 checks the stem's dX too: Cout 1


@pytest.mark.parametrize(
    "cin,cout,aligned,vec",
    [
        (32, 48, True, 8), (336, 256, True, 8), (512, 1024, True, 8),  # the FCNN's edges
        (48, 64, False, 2),   # not 16-byte aligned: 4-byte copies
        (6, 70, True, 2),     # even widths, not multiples of 8
        (5, 64, True, 1),     # odd Cin: plain 2-byte loads
        (64, 33, True, 1),    # odd Cout
    ],
)
def test_bf16_copy_widths(cin, cout, aligned, vec):
    """The bf16 instances copy 8 elements (16 bytes) where both widths are
    multiples of 8 and the pointers aligned, 2 (4 bytes) for even widths,
    1 (plain loads) for odd ones; the float32 plans are unchanged."""
    assert gg.plan(1000, 27, cin, cout, SMS, aligned, bf16=True).vec == vec
    assert dw.plan(27, cin, cout, 1000, SMS, aligned, bf16=True).vec == vec
    f32 = 4 if aligned and cin % 4 == 0 and cout % 4 == 0 else 1
    assert gg.plan(1000, 27, cin, cout, SMS, aligned).vec == f32
    assert dw.plan(27, cin, cout, 1000, SMS, aligned).vec == f32


def test_bf16_plans_keep_the_tiles_and_splits():
    """The bf16 ``mma.sync`` body (taken for odd or unaligned widths, or
    asked for) keeps the float32 instance's plan on the same shapes: S, the
    offset ranges and the tiles; only the copy width depends on the dtype
    (the workspace stays float32).  The wgmma bodies' plans are pinned by
    ``test_bf16_wgmma_plans``."""
    for args in [(125, 27, 384, 256), (51000, 27, 96, 96), (618, 8, 128, 256)]:
        a = gg.plan(*args, SMS, body="mma")
        b = gg.plan(*args, SMS, bf16=True, body="mma")
        assert a._replace(vec=0) == b._replace(vec=0)
    a, b = gg.plan(3000, 27, 64, 33, SMS), gg.plan(3000, 27, 64, 33, SMS, bf16=True)
    assert b.body == "mma" and a._replace(vec=0) == b._replace(vec=0)
    for args in [(27, 96, 96, 20000), (27, 384, 256, 618), (27, 16, 16, 4716408)]:
        a = dw.plan(*args, SMS)
        b = dw.plan(*args, SMS, bf16=True, body="mma")
        assert a._replace(vec=0) == b._replace(vec=0)
    a, b = dw.plan(27, 96, 33, 20000, SMS), dw.plan(27, 96, 33, 20000, SMS, bf16=True)
    assert b.body == "mma" and a._replace(vec=0) == b._replace(vec=0)
    assert dw.plan(125, 3, 32, 3000, SMS, bf16=True, body="simt") == dw.plan(125, 3, 32, 3000, SMS)
    assert gg.plan(3000, 125, 3, 32, SMS, bf16=True).body == "simt"


BF16_CONVS = STEP_CONVS + CLASSIFICATION_CONVS
BF16_IDS = [f"k{k}-{ci}to{co}-{n_in}to{n_out}" for k, ci, co, n_in, n_out in BF16_CONVS]


def _check_wgmma_offset_split(n_out, k_vol, cin, cout):
    """K1's bf16 plan on one call: the SIMT stem for Cin <= 4, else the wgmma
    body with a Cout tile of at most 256 that covers Cout <= 256 at once,
    its ring, and an offset split that fills the card within the cap."""
    p = gg.plan(n_out, k_vol, cin, cout, SMS, bf16=True)
    if cin <= 4:
        assert (p.body, p.tile, p.stages) == ("simt", 64, 1)
        return p
    assert p.body == "wgmma" and p.vec == 8
    assert p.tile in gg.WGMMA_TILES and p.tile % 16 == 0
    n_tiles = -(-cout // p.tile)
    assert n_tiles == -(-cout // 256)  # X gathered once per row tile for Cout <= 256
    assert n_tiles * p.tile - cout < 64  # padding less than one 64-wide step
    # two warpgroups share each stage's W[k] chunk where it outweighs the X rows
    assert p.row_tile == (128 if p.tile >= 96 else 64)
    tiles = -(-n_out // p.row_tile) * n_tiles
    assert p.stages == gg.wgmma_stages(p.tile, p.row_tile) and 4 <= p.stages <= 8
    assert 1 <= p.splits <= k_vol
    assert p.offsets_per_split * (p.splits - 1) < k_vol <= p.offsets_per_split * p.splits
    assert p.workspace_bytes(n_out, cout) <= gg.WORKSPACE_CAP
    # the split fills the SMs' blocks once at most: no second wave of a few blocks
    held = gg.wgmma_blocks_per_sm(p.tile, p.row_tile) * SMS
    assert tiles * p.splits <= max(tiles, held)
    capped = 4 * (p.splits + 1) * n_out * cout > gg.WORKSPACE_CAP
    more = -(-k_vol // (p.offsets_per_split - 1)) if p.offsets_per_split > 1 else k_vol + 1
    assert tiles * more > held or p.splits == k_vol or capped  # the next split would overflow
    if tiles >= held:
        assert p.splits == 1
    return p


@pytest.mark.parametrize("k_vol,cin,cout,n_in,n_out", BF16_CONVS, ids=BF16_IDS)
def test_bf16_wgmma_plans(k_vol, cin, cout, n_in, n_out):
    """Every distinct conv of a MinkUNet34 and a MinkowskiFCNN step in bf16:
    the forward and the input gradient (Cin and Cout swapped, rows out at
    n_in) on K1's wgmma body, the weight gradient on K2's (or the stem's
    mma.sync body), their tiles, rings, splits and workspaces."""
    fwd = _check_wgmma_offset_split(n_out, k_vol, cin, cout)
    checked = [(n_out, fwd)]
    if cin > 4:  # the stem's input (the features) takes no gradient
        checked.append((n_in, _check_wgmma_offset_split(n_in, k_vol, cout, cin)))
    for n, p in checked:
        if n >= 51028:
            assert p.splits == 1
        if n <= 618 and k_vol > 1 and p.body == "wgmma":
            assert p.splits > 1  # the deep levels, fewer tiles than with 64-wide ones
    p = dw.plan(k_vol, cin, cout, n_out, SMS, bf16=True)
    scans = -(-n_out // dw.ROWS_PER_SCAN)
    assert 1 <= p.splits <= scans
    assert p.workspace_bytes(k_vol, cin, cout) <= dw.WORKSPACE_CAP
    capped = 4 * (p.splits + 1) * k_vol * cin * cout > dw.WORKSPACE_CAP
    assert p.blocks(k_vol, cin, cout) * p.splits >= SMS or p.splits == scans or capped
    if cin <= 4:
        assert (p.body, p.cin_tile, p.cout_tile, p.vec, p.stages) == ("stem_mma", 8, 64, 8, 4)
    else:
        assert (p.body, p.vec) == ("wgmma", 8)
        assert p.cout_tile == gg.wgmma_tile(cout)
        assert -(-cout // p.cout_tile) == -(-cout // 256)  # G gathered once per Cin tile
        # two warpgroups along Cin share the G rows where Cin > 64 and the
        # Cout tile leaves them the registers
        assert p.cin_tile == (128 if cin > 64 and p.cout_tile <= 128 and p.cout_tile >= 64 else 64)
        assert p.stages == dw.wgmma_stages(p.cout_tile, p.cin_tile) and 4 <= p.stages <= 8


@pytest.mark.parametrize(
    "cout,tile",
    [(8, 16), (16, 16), (20, 32), (32, 32), (48, 48), (64, 64), (72, 96), (96, 96), (128, 128),
     (160, 192), (192, 192), (224, 256), (256, 256), (336, 192), (384, 192), (512, 256),
     (1024, 256)],
)
def test_wgmma_tile(cout, tile):
    assert gg.wgmma_tile(cout) == tile


@pytest.mark.parametrize(
    "n_out,cin,cout,tile,row_tile,stages",
    [
        (51028, 96, 96, 96, 128, 7),     # the stride-1 block convs: W[k] shared by 128 rows
        (12533, 96, 96, 96, 128, 7),     # 98 tiles: one wave, no split
        (618, 256, 256, 256, 128, 4),    # the deep levels: offsets split
        (27633, 336, 256, 256, 128, 4),  # FCNN conv5a
        (14794, 1024, 512, 256, 128, 4),  # FCNN conv5c's input gradient: two 256-wide tiles
        (47834, 32, 48, 48, 64, 7),      # a narrow Cout: W[k] is small beside X
    ],
)
def test_bf16_wgmma_row_tiles_and_rings(n_out, cin, cout, tile, row_tile, stages):
    p = gg.plan(n_out, 27, cin, cout, SMS, bf16=True)
    assert (p.body, p.tile, p.row_tile, p.stages) == ("wgmma", tile, row_tile, stages)


def test_bf16_body_by_shape_not_by_failure():
    """The plan picks the body from the widths and the alignment alone; a
    body asked for must take the shapes, or the plan raises."""
    assert gg.plan(1000, 27, 64, 64, SMS, bf16=True).body == "wgmma"
    assert gg.plan(1000, 27, 64, 64, SMS, aligned=False, bf16=True).body == "mma"
    assert gg.plan(1000, 27, 6, 70, SMS, bf16=True).body == "mma"  # even widths
    assert gg.plan(1000, 27, 64, 33, SMS, bf16=True).body == "mma"  # odd Cout
    assert gg.plan(1000, 27, 64, 64, SMS).body == "wgmma_3xtf32"  # float32
    assert dw.plan(27, 64, 64, 1000, SMS, bf16=True).body == "wgmma"
    assert dw.plan(27, 64, 64, 1000, SMS, aligned=False, bf16=True).body == "mma"
    assert dw.plan(27, 5, 64, 1000, SMS, bf16=True).body == "mma"
    assert dw.plan(27, 3, 33, 1000, SMS, bf16=True)[3:5] == (1, "stem_mma")  # odd Cout: plain loads
    assert dw.plan(27, 1, 16, 1000, SMS).body == "simt"  # float32 stem
    for bad in [
        lambda: gg.plan(1000, 27, 64, 33, SMS, bf16=True, body="wgmma"),
        lambda: gg.plan(1000, 27, 64, 64, SMS, body="wgmma"),
        lambda: gg.plan(1000, 27, 3, 32, SMS, bf16=True, body="mma"),
        lambda: gg.plan(1000, 27, 64, 64, SMS, bf16=True, body="simt"),
        lambda: dw.plan(27, 3, 32, 1000, SMS, body="stem_mma"),
        lambda: dw.plan(27, 64, 64, 1000, SMS, bf16=True, body="stem_mma"),
        lambda: dw.plan(27, 64, 64, 1000, SMS, aligned=False, bf16=True, body="wgmma"),
    ]:
        with pytest.raises(ValueError):
            bad()


def _check_f32_wgmma_plan(n_out, k_vol, cin, cout):
    """K1's float32 plan on one call: the SIMT stem for Cin <= 4, else the
    wgmma body (every width on these nets is a multiple of 8) with a Cout
    tile of at most 128 that covers Cout <= 128 at once, 128-row tiles, its
    ring, and an offset split that fills the SMs at most once, within the
    workspace cap."""
    p = gg.plan(n_out, k_vol, cin, cout, SMS)
    if cin <= 4:
        assert (p.body, p.tile, p.stages) == ("simt", 64, 1)
        return p
    assert p.body == "wgmma_3xtf32" and p.vec == 4
    assert p.tile == gg.wgmma_tile(cout, 128) and p.tile % 16 == 0 and p.tile <= 128
    n_tiles = -(-cout // p.tile)
    assert n_tiles == -(-cout // 128)  # X gathered once per row tile for Cout <= 128
    assert n_tiles * p.tile - cout < 32 * n_tiles  # each tile pads less than a 32-wide step
    assert p.row_tile == 128  # two warpgroups share each stage's W[k] chunk
    assert p.stages == gg.wgmma_stages(p.tile, p.row_tile, f32=True) and 4 <= p.stages <= 8
    tiles = -(-n_out // p.row_tile) * n_tiles
    assert 1 <= p.splits <= k_vol
    assert p.offsets_per_split * (p.splits - 1) < k_vol <= p.offsets_per_split * p.splits
    assert p.workspace_bytes(n_out, cout) <= gg.WORKSPACE_CAP
    held = gg.wgmma_blocks_per_sm(p.tile, p.row_tile, f32=True) * SMS
    assert tiles * p.splits <= max(tiles, held)
    if tiles >= held:
        assert p.splits == 1
    return p


@pytest.mark.parametrize("k_vol,cin,cout,n_in,n_out", CONVS, ids=IDS)
def test_f32_wgmma_plans(k_vol, cin, cout, n_in, n_out):
    """Every distinct conv of a MinkUNet34, a MinkowskiFCNN, a CompletionNet
    and a VAE step in float32: the forward and the input gradient (Cin and
    Cout swapped, rows out at n_in) on K1's float32 wgmma body, the stems
    on SIMT; the deep levels split their offsets."""
    checked = [(n_out, _check_f32_wgmma_plan(n_out, k_vol, cin, cout))]
    if cin > 4:
        checked.append((n_in, _check_f32_wgmma_plan(n_in, k_vol, cout, cin)))
    for n, p in checked:
        if n >= 51028:
            assert p.splits == 1
        if n <= 618 and k_vol > 1 and p.body == "wgmma_3xtf32":
            assert p.splits > 1


@pytest.mark.parametrize(
    "n_out,cin,cout,tile,row_tile,stages",
    [
        (51028, 96, 96, 96, 128, 5),      # the stride-1 block convs: W[k] shared by 128 rows
        (51028, 128, 96, 96, 128, 5),
        (12533, 32, 32, 32, 128, 8),
        (2817, 64, 64, 64, 128, 7),
        (618, 128, 128, 128, 128, 4),
        (618, 384, 256, 128, 128, 4),     # two 128-wide tiles: W[k] outweighs the X rows
        (2817, 128, 192, 96, 128, 5),
        (4716408, 16, 16, 16, 128, 8),    # CompletionNet's 16-wide level: no padding to 64
        (9538, 512, 1024, 128, 128, 4),   # FCNN conv5c: eight 128-wide tiles
    ],
)
def test_f32_wgmma_row_tiles_and_rings(n_out, cin, cout, tile, row_tile, stages):
    p = gg.plan(n_out, 27, cin, cout, SMS)
    assert (p.body, p.tile, p.row_tile, p.stages) == ("wgmma_3xtf32", tile, row_tile, stages)


@pytest.mark.parametrize(
    "cin,cout,aligned,body",
    [
        (64, 64, True, "wgmma_3xtf32"), (8, 8, True, "wgmma_3xtf32"),
        (336, 48, True, "wgmma_3xtf32"),  # a ragged last Cin chunk of 16
        (64, 64, False, "mma"),           # not 16-byte aligned
        (12, 64, True, "mma"),            # Cin a multiple of 4, not of 8
        (64, 36, True, "mma"),            # Cout a multiple of 4, not of 8
        (64, 33, True, "mma"),            # odd Cout: 4-byte copies
        (5, 64, True, "mma"),
        (4, 64, True, "simt"), (3, 32, True, "simt"), (1, 16, True, "simt"),
    ],
)
def test_f32_body_by_shape(cin, cout, aligned, body):
    """The float32 plan takes the wgmma body for Cin and Cout multiples of 8
    with aligned operands, the mma.sync body for other Cin > 4, the SIMT
    stem for Cin <= 4, from the shapes alone; the bf16 plan on the same
    shapes is what it was (``wgmma`` only for its own 16-byte copies)."""
    assert gg.plan(3000, 27, cin, cout, SMS, aligned).body == body
    bf16 = gg.plan(3000, 27, cin, cout, SMS, aligned, bf16=True).body
    assert bf16 == ("simt" if cin <= 4 else "wgmma" if aligned and cin % 8 == 0
                    and cout % 8 == 0 else "mma")


def test_f32_body_asked_for_must_take_the_shapes():
    for bad in [
        lambda: gg.plan(1000, 27, 64, 33, SMS, body="wgmma_3xtf32"),   # odd Cout
        lambda: gg.plan(1000, 27, 12, 64, SMS, body="wgmma_3xtf32"),   # Cin % 8
        lambda: gg.plan(1000, 27, 64, 64, SMS, aligned=False, body="wgmma_3xtf32"),
        lambda: gg.plan(1000, 27, 3, 32, SMS, body="wgmma_3xtf32"),    # the stem
        lambda: gg.plan(1000, 27, 64, 64, SMS, bf16=True, body="wgmma_3xtf32"),
        lambda: gg.plan(1000, 27, 64, 64, SMS, body="wgmma"),          # the bf16 body
        lambda: gg.plan(1000, 27, 64, 64, SMS, body="tf32"),
    ]:
        with pytest.raises(ValueError):
            bad()
    assert gg.plan(1000, 27, 64, 64, SMS, body="mma").body == "mma"


@pytest.mark.parametrize("n_out,k_vol,cin,cout", [(51028, 27, 96, 96), (618, 27, 384, 256),
                                                  (125, 8, 256, 256), (3000, 27, 12, 64),
                                                  (2000, 125, 3, 32)])
def test_bf16_plans_unchanged_by_the_f32_body(n_out, k_vol, cin, cout):
    """The bf16 plans are the ones the bf16 bodies had before the float32
    wgmma body: its tile, row tile, ring and blocks an SM are separate."""
    p = gg.plan(n_out, k_vol, cin, cout, SMS, bf16=True)
    if p.body == "wgmma":
        assert p.row_tile == (128 if p.tile >= 96 else 64)
        fixed = 1024 + (32 * p.row_tile + 2 * 32 + 4) * 4
        limit = (113 if p.row_tile == 64 and p.tile <= 128 else 227) * 1024
        assert p.stages == min(8, (limit - fixed) // (p.row_tile * 128 + p.tile * 128))
    assert "wgmma_3xtf32" not in gg.gather_gemm.bf16_body_launches
    assert "wgmma" not in gg.gather_gemm.float32_body_launches
