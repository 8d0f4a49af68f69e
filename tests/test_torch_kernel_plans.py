"""The regime and tile choice of the port's two backbone kernels
(``kernels/ssd_scan/ops.py:plan``, ``kernels/flash_attention/ops.py:plan``),
made in Python from the shapes so that it is tested without a card: the
training path's shapes, the JAX package's kernel sweeps
(tests/test_kernels.py) and the JAX configs' 256-token SSD chunks each get
the regime they are built for, and every choice stays within a block's
232 448 bytes of shared memory, 1024 threads and the grid's 2^31 - 1
blocks (the wide attention regime's blocks leaving 8 warps on a SM's
233 472 bytes).  That the C side computes the same shared memory is
checked on the card (tests/test_torch_isolation.py)."""
import pytest
import torch

from _torch_cpu import one_torch_thread  # noqa: F401
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops

SMEM, BLOCKS, SM_SMEM = 232448, 2 ** 31 - 1, 233472

#: (B, nc, Q, nh, hp, N) -> regime: the path's cohort (K·N = 960) and eval
#: (240) stacks at S = 32 and 24, the JAX sweep, the JAX configs' chunk
SSD_SHAPES = [
    ((960, 4, 8, 8, 8, 16), "small"),
    ((240, 4, 8, 8, 8, 16), "small"),
    ((960, 3, 8, 8, 8, 16), "small"),
    ((240, 3, 8, 8, 8, 16), "small"),
    ((1, 2, 64, 2, 32, 16), "large"),
    ((2, 4, 32, 4, 16, 8), "large"),          # 8 chunks: spread wider
    ((32, 4, 32, 4, 16, 8), "small"),
    ((1, 1, 128, 8, 64, 32), "large"),
    ((1, 1, 256, 2, 64, 128), "large"),       # mamba2-370m
    ((1, 1, 256, 2, 64, 16), "large"),        # jamba-v0.1-52b
    ((8, 16, 256, 32, 64, 128), "large"),     # mamba2-370m, 4k tokens
    ((4, 2, 256, 32, 64, 128), "large"),      # mamba2-370m train, B=4 S=512
    ((1, 1, 32, 64, 64, 16), "large"),        # heads too many for one block
    ((40, 2, 16, 3, 6, 5), "small"),          # hp, N not multiples of 4
    ((2, 2, 8, 8, 8, 16), "small"),           # few chunks of 8: small
    # large regime at any hp and N, as the JAX kernel takes them: hp, N not
    # multiples of 4; hp 1; hp 48 (a 64-column tile); hp 200 and 256 (two
    # 128-column tiles) with the largest N a block holds at hp 128
    ((3, 2, 16, 3, 6, 5), "large"),
    ((1, 1, 64, 2, 64, 6), "large"),
    ((2, 3, 33, 4, 1, 6), "large"),
    ((1, 1, 256, 2, 48, 16), "large"),
    ((2, 3, 256, 4, 200, 256), "large"),
    ((1, 1, 256, 2, 256, 128), "large"),
]


@pytest.mark.parametrize("shape,regime", SSD_SHAPES)
def test_ssd_plan_regime_and_limits(shape, regime):
    B, nc, Q, nh, hp, N = shape
    p = ssd_ops.plan(*shape)
    assert p.regime == regime
    assert 0 < p.smem <= SMEM and 1 <= p.blocks <= BLOCKS
    assert 0 < p.threads <= 1024 and p.threads % 32 == 0
    if regime == "small":
        assert p.smem == ssd_ops.small_smem(p.group, Q, nh, hp, N)
        assert p.blocks * p.group >= B * nc > (p.blocks - 1) * p.group
    else:
        assert p.group == 1 and p.smem == ssd_ops.large_smem(hp, N)
        HP = ssd_ops.large_hp_tile(hp)
        assert HP in (8, 16, 32, 64, 128) and (HP >= hp or HP == 128)
        assert HP == 8 or HP // 2 < hp
        _, nt = ssd_ops.large_layout(hp)
        assert p.blocks == B * nc * nh * -(-hp // HP) * (-(-Q // 64)
                                                         + -(-N // nt))


def test_ssd_plan_groups_chunks_at_the_cohort_shape():
    """The cohort's 3840 chunks go three to a block (1280 blocks, about 10
    per SM), the eval stack's 960 one to a block; a group stays under 48 KB
    so that several blocks reside per SM."""
    assert ssd_ops.plan(960, 4, 8, 8, 8, 16).group == 3
    assert ssd_ops.plan(240, 4, 8, 8, 8, 16).group == 1
    assert ssd_ops.plan(8, 512, 8, 8, 8, 16).group == 3
    for shape, _ in SSD_SHAPES:
        p = ssd_ops.plan(*shape)
        assert p.group == 1 or p.smem <= ssd_ops.SMALL_GROUP_SMEM


@pytest.mark.parametrize("shape", [(1, 1, 256, 2, 64, 1024),
                                   (1, 1, 64, 2, 256, 512),
                                   (1, 1, 32, 2, 64, 4096)])
def test_ssd_plan_raises_for_a_shape_no_regime_takes(shape):
    """Only a state size whose B/C tiles outgrow a block is refused."""
    with pytest.raises(ValueError, match="SSD chunk kernel takes no chunk"):
        ssd_ops.plan(*shape)



#: (B, S, H, KH, hd, dtype) -> regime: the path's cohort and eval stacks at
#: S = 32 and 24, the JAX sweep in both types, the JAX configs' head dims
ATTN_SHAPES = [
    ((960, 32, 4, 4, 8, torch.float32), "short"),
    ((240, 32, 4, 4, 8, torch.float32), "short"),
    ((960, 24, 4, 4, 8, torch.float32), "short"),
    ((240, 24, 4, 4, 8, torch.float32), "short"),
    ((96, 24, 4, 4, 8, torch.bfloat16), "short"),
    ((3, 48, 8, 2, 16, torch.float32), "short"),
    ((5, 64, 2, 2, 32, torch.float32), "short"),
    ((1, 128, 4, 2, 64, torch.float32), "long"),
    ((1, 128, 4, 2, 64, torch.bfloat16), "long"),
    ((2, 256, 4, 4, 32, torch.float32), "long"),
    ((2, 256, 4, 4, 32, torch.bfloat16), "long"),
    ((1, 256, 8, 2, 64, torch.bfloat16), "long"),
    ((1, 512, 2, 1, 128, torch.bfloat16), "long"),
    ((1, 512, 2, 1, 128, torch.float32), "long"),
    ((1, 64, 4, 4, 64, torch.bfloat16), "long"),          # one key tile
    ((1, 4096, 16, 8, 256, torch.bfloat16), "wide"),      # gemma3-12b
    ((2, 2048, 16, 8, 256, torch.bfloat16), "wide"),      # its serve/train
    ((2, 2048, 16, 8, 256, torch.float32), "generic"),
    ((1, 96, 2, 1, 256, torch.bfloat16), "wide"),         # R = 2
    ((2, 100, 3, 3, 256, torch.bfloat16), "wide"),        # R = 1, ragged
    ((1, 64, 6, 2, 112, torch.bfloat16), "wide"),         # R = 3
    ((1, 200, 8, 1, 112, torch.bfloat16), "wide"),        # R = 8
    ((1, 256, 4, 2, 192, torch.bfloat16), "generic"),     # no wide build
    # the LM train steps' shapes (chip_smoke.py's [train] runs)
    ((8, 256, 16, 8, 128, torch.bfloat16), "long"),       # qwen3-0.6b
    ((8, 256, 8, 8, 64, torch.bfloat16), "long"),         # whisper-base
    ((4, 256, 56, 8, 128, torch.bfloat16), "long"),       # llava-next-34b
    ((4, 256, 40, 8, 128, torch.bfloat16), "long"),       # llama4-scout
    ((4, 64, 40, 8, 128, torch.bfloat16), "long"),        # its prefill
    ((1, 4096, 64, 8, 112, torch.bfloat16), "wide"),      # kimi-k2
    ((1, 4096, 64, 8, 112, torch.float32), "generic"),
    ((2, 200, 4, 4, 8, torch.float32), "generic"),
]


#: (row groups, key splits, key tile) of the bfloat16 long-regime kernels
#: built in csrc/flash_attention.cu (launch_mma_layout)
MMA_LAYOUTS = {(4, 1, 64), (2, 1, 64), (4, 2, 64), (2, 4, 64), (2, 4, 32)}


@pytest.mark.parametrize("shape,regime", ATTN_SHAPES)
def test_attention_plan_regime_and_limits(shape, regime):
    B, S, H, KH, hd, dt = shape
    p = fa_ops.plan(*shape)
    assert p.regime == regime
    assert 0 < p.smem <= SMEM and 1 <= p.blocks <= BLOCKS
    assert 0 < p.threads <= 1024 and p.threads % 32 == 0
    if regime == "short":
        R = H // KH
        hpb = p.heads_per_block
        assert H % hpb == 0 and (hpb % R == 0 or R % hpb == 0)
        hpw = fa_ops.short_hpw(hpb)
        assert hpb % hpw == 0 and hpw in (1, 2, 4, 8)
        assert p.threads == hpb // hpw * -(-S // (32 // hpw)) * 32 <= 512
        assert p.blocks == B * H // hpb
    elif regime == "long":
        assert p.threads == 32 * p.row_groups * p.key_splits
        layout = (p.row_groups, p.key_splits, p.key_tile)
        if dt == torch.bfloat16:     # the layouts the C side instantiates
            assert layout in MMA_LAYOUTS and (layout[1] < 4 or hd <= 64)
        else:
            assert layout == (4, 1, 32)
        assert p.blocks == B * H * -(-S // (16 * p.row_groups))
    elif regime == "wide":
        R, hpb, rg = H // KH, p.heads_per_block, p.row_groups
        warps = fa_ops.WIDE_WARPS[hd]
        assert warps == (8 if hd == 256 else 4) and p.threads == 32 * warps
        assert hpb == max(d for d in (1, 2, 4, 8)
                          if warps % d == 0 and R % d == 0)
        assert hpb * rg == warps and p.c_arg == hpb and p.key_tile == 64
        assert p.blocks == B * KH * (R // hpb) * -(-S // (16 * rg))
        assert p.smem == 2 * (16 * warps + 4 * 64) * (hd + 8)
        assert SM_SMEM // (p.smem + 1024) * warps >= 8   # 8 warps a SM
    else:
        assert p.threads == 128 and p.blocks == B * H * -(-S // 32)


def test_attention_plan_shares_kv_within_a_block_at_the_path_shape():
    """All four heads of a batch row in one block (their K/V staged once);
    with GQA a block covers whole KV groups."""
    assert fa_ops.plan(960, 32, 4, 4, 8, torch.float32).heads_per_block == 4
    assert fa_ops.plan(2, 24, 8, 2, 16, torch.float32).heads_per_block == 8
    assert fa_ops.plan(2, 64, 16, 2, 32, torch.float32).heads_per_block == 8


def test_attention_plan_splits_keys_only_in_small_grids():
    """A small grid (the JAX sweep: 4–16 heads of S=128–512) splits the
    keys so that its longest block walks one or two tiles in a row; a large
    grid (LM serving batches) takes 64-row blocks and no split."""
    bf = torch.bfloat16
    assert fa_ops.mma_layout(1, 128, 4, 64) == (2, 4, 32)
    assert fa_ops.mma_layout(2, 256, 4, 32) == (2, 4, 64)
    assert fa_ops.mma_layout(1, 512, 2, 128, 128) == (4, 2, 64)
    assert fa_ops.mma_layout(1, 256, 8, 64, 64) == (2, 4, 32)
    assert fa_ops.mma_layout(2, 65, 8, 64) == (2, 4, 32)
    assert fa_ops.mma_layout(8, 2048, 32, 128) == (4, 1, 64)
    p = fa_ops.plan(8, 2048, 32, 8, 128, bf)
    assert (p.row_groups, p.key_splits, p.threads) == (4, 1, 128)


def test_attention_plan_takes_unaligned_operands_off_the_long_regime():
    assert fa_ops.plan(1, 128, 4, 2, 64, torch.bfloat16,
                       aligned=False).regime == "generic"
    q = torch.zeros(2, 128, 4, 65)[..., 1:]          # 4-byte offset
    assert not fa_ops.aligned16((q,), 64)
    assert fa_ops.aligned16((torch.zeros(2, 128, 4, 64),), 64)


@pytest.mark.parametrize("shape,window,aligned,regime", [
    ((2, 2048, 16, 8, 256, torch.bfloat16), 1024, True, "wide"),
    ((2, 2048, 16, 8, 256, torch.bfloat16), None, True, "wide"),
    ((1, 4096, 64, 8, 112, torch.bfloat16), None, True, "wide"),
    ((2, 2048, 16, 8, 256, torch.bfloat16), 1024, False, "generic"),
    ((1, 4096, 64, 8, 112, torch.bfloat16), None, False, "generic"),
    ((2, 2048, 16, 8, 256, torch.float32), 1024, True, "generic"),
])
def test_attention_plan_wide_heads_by_type_and_alignment(shape, window,
                                                         aligned, regime):
    """gemma3-12b's local and global layers and kimi-k2's attention take
    the wide regime (gemma3: a block of 8 warps serves the two query heads
    of a KV head, 64 rows each; kimi-k2: 4 warps, four heads of 16 rows);
    float32 and unaligned operands keep the generic tiles."""
    p = fa_ops.plan(*shape, aligned=aligned, window=window)
    assert p.regime == regime and p.smem <= SMEM
    if regime == "wide":
        assert (p.heads_per_block, p.row_groups) == (
            (2, 4) if shape[4] == 256 else (4, 1))


def test_attention_plan_raises_past_the_largest_head_dim():
    with pytest.raises(ValueError, match="head dims up to 256"):
        fa_ops.plan(1, 64, 2, 2, 512, torch.float32)


# ---------------------------------------------------------------------------
# the fusion-loss kernels (kernels/fusion_loss/ops.py:plan)
# ---------------------------------------------------------------------------
from repro_torch.kernels.fusion_loss import ops as fl_ops  # noqa: E402

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
#: (K, T, V, M, seg, dtype) -> regime, and for the group regime the
#: forward's threads a row: the paper's client stacks (CREMA-D,
#: IEMOCAP), the LM-like shape with a broadcast head, the JAX fusion sweep
#: (tests/test_kernels.py, K = 1) in both types, the regimes' edges at
#: V = 1, 12, 16, 17, 31, 32, 33, 37, 64, 65 with few and many rows, rows not a
#: multiple of a block, broadcast heads in each regime, M = 1 and 4,
#: bfloat16 and float16
FUSION_SHAPES = [
    ((10, 96, 6, 2, (0, 0), F32), "rows"),
    ((10, 96, 10, 2, (0, 0), F32), "rows"),
    ((10, 96, 6, 2, (0, 0), BF16), "rows"),
    ((1, 512, 32000, 3, (0, 0, 128), F32), "group/128"),
    ((1, 512, 32000, 3, (0, 0, 128), BF16), "group/128"),
    ((1, 128, 1024, 1, (0,), F32), "group/256"),
    ((1, 256, 2048, 2, (0, 0), F32), "group/128"),
    ((1, 64, 4096, 3, (0, 0, 0), F32), "group/256"),
    ((1, 128, 512, 4, (0, 0, 0, 0), F32), "group/256"),
    ((1, 128, 1024, 1, (0,), BF16), "group/256"),
    ((1, 256, 2048, 2, (0, 0), BF16), "group/128"),
    ((1, 64, 4096, 3, (0, 0, 0), BF16), "group/256"),
    ((1, 128, 512, 4, (0, 0, 0, 0), BF16), "group/256"),
    ((3, 50, 1, 1, (0,), F32), "rows"),
    ((2, 70, 12, 4, (0, 0, 0, 0), F16), "rows"),
    ((2, 70, 16, 4, (0, 0, 0, 0), F16), "rows"),
    ((2, 70, 17, 4, (0, 0, 0, 0), F16), "group/32"),
    ((2, 70, 31, 4, (0, 0, 0, 0), F16), "group/32"),
    ((4, 40, 32, 3, (0, 0, 8), F32), "group/32"),
    ((40, 128, 32, 3, (0, 0, 8), F32), "rows"),
    ((200, 97, 32, 4, (0, 0, 0, 0), F32), "rows"),
    ((64, 64, 64, 2, (0, 0), BF16), "rows"),
    ((64, 64, 65, 2, (0, 0), BF16), "group/32"),
    ((5, 33, 33, 2, (0, 11), BF16), "group/32"),
    ((3, 16, 37, 3, (0, 0, 4), F32), "group/32"),
    ((64, 100, 37, 1, (0,), F16), "rows"),
    ((2, 8, 5000, 2, (0, 2), F16), "group/256"),
    ((4096, 128, 151936, 4, (0, 0, 0, 128), BF16), "group/512"),
    # the LM train steps' losses, K=1 with a compact head: whisper-base's
    # audio head and llava-next-34b's vision head, whole and chunked
    ((1, 2048, 51865, 2, (256, 0), BF16), "group/256"),
    ((1, 1024, 64000, 2, (0, 256), BF16), "group/256"),
    ((1, 512, 64000, 2, (0, 128), BF16), "group/256"),
]


def _regime(p):
    """``rows``, or ``group/<forward threads a row>``."""
    return p.regime if p.regime == "rows" else f"{p.regime}/{p.fwd.width}"


@pytest.mark.parametrize("shape,regime", FUSION_SHAPES)
def test_fusion_plan_regime_and_limits(shape, regime):
    K, T, V, M, seg, dt = shape
    p = fl_ops.plan(*shape)
    assert _regime(p) == regime
    regime = p.regime                               # "rows" or "group"
    assert (p.regime == "rows") == fl_ops.takes_rows(K, T, V)
    esize = dt.itemsize
    for bwd, d in ((False, p.fwd), (True, p.bwd)):
        assert 0 < d.threads <= 1024 and d.threads % 32 == 0
        assert 1 <= d.blocks <= BLOCKS and 0 <= d.smem <= SMEM
        # every row in exactly one block, and a block within one client
        nblk = -(-T // d.rows)
        assert d.blocks == K * nblk and nblk * d.rows >= T
        assert d.smem == fl_ops.smem_bytes(regime, bwd, d.width, V, M, esize)
        assert d == fl_ops.make_launch(regime, bwd, d.width, K, T, V, M,
                                       esize)
        if regime == "rows":
            assert d.width == d.rows == fl_ops.ROWS_R
            assert d.threads == (fl_ops.BWD_ROWS_THREADS if bwd else d.width)
        else:
            assert d.width in (fl_ops.BWD_WIDTHS if bwd
                               else fl_ops.FWD_WIDTHS)
            assert d.threads == d.width * d.rows == max(d.width, 256)
    assert p.nblk * K == p.bwd.blocks
    if regime != "rows":
        assert p.bwd.width == (32 if p.fwd.width == 32 else 512
                               if V >= fl_ops.WIDE_V else 256)


def test_fusion_plan_fills_the_card_at_the_lm_shape():
    """512 rows of 32000 classes: 128 threads a row forward (two rows a
    block), a block of 512 a row backward; every SM busy."""
    p = fl_ops.plan(1, 512, 32000, 3, (0, 0, 128), F32)
    assert (p.fwd.width, p.bwd.width) == (128, 512)
    assert p.fwd.blocks == 256 and p.bwd.blocks == 512 >= 132   # SMs


@pytest.mark.parametrize("regime,width", [("rows", fl_ops.ROWS_R)]
                         + [("group", G) for G in fl_ops.FWD_WIDTHS])
def test_fusion_every_width_fits_a_block(regime, width):
    """Every forward width the C side builds, with the backward width the
    plan pairs with it, at the shapes the card tests force them at
    (tests/test_torch_isolation.py) and, for rows, at the widest row the
    plan gives the regime with four float32 operands, within a block's
    limits."""
    shapes = ([(3, 300, 24, 4, 4), (3, 300, fl_ops.ROWS_MAX_V, 4, 4)]
              if regime == "rows" else [(2, 40, 3000, 3, 2)])
    for K, T, V, M, esize in shapes:
        p = fl_ops.make_plan(regime, width, K, T, V, M, esize)
        for d in (p.fwd, p.bwd):
            assert d.smem <= SMEM and d.threads <= 1024
            assert d.blocks == K * -(-T // d.rows)


def test_fusion_plan_takes_rows_further_when_a_call_has_many():
    """The rows regime's reach: 16 classes at the paper's cohort (960 rows),
    64 from 4096 rows on."""
    assert fl_ops.plan(10, 96, 16, 2, (0, 0), F32).regime == "rows"
    assert _regime(fl_ops.plan(10, 96, 17, 2, (0, 0), F32)) == "group/32"
    assert fl_ops.plan(32, 128, 64, 2, (0, 0), F32).regime == "rows"
    assert _regime(fl_ops.plan(31, 128, 64, 2, (0, 0), F32)) == "group/32"


@pytest.mark.parametrize("width", [64, 128])
def test_fusion_backward_takes_only_the_widths_the_plan_gives(width):
    """The C side builds the group backward at 32, 256 and 512 threads a
    row only; a launch at another width is refused in Python too."""
    assert width in fl_ops.FWD_WIDTHS and width not in fl_ops.BWD_WIDTHS
    fl_ops.make_launch("group", False, width, 2, 40, 3000, 3, 2)
    with pytest.raises(ValueError):
        fl_ops.make_launch("group", True, width, 2, 40, 3000, 3, 2)
    with pytest.raises(ValueError):
        fl_ops.make_plan("group", 128, 2, 40, 3000, 3, 2, width_bwd=width)


@pytest.mark.parametrize("args,exc", [
    ((1, 8, 10, 5, (0,) * 5, F32), ValueError),      # M > 4
    ((1, 8, 10, 0, (), F32), ValueError),
    ((1, 8, 0, 2, (0, 0), F32), ValueError),
    ((1, 8, 10, 2, (0, 3), F32), ValueError),        # seg does not divide T
    ((1, 8, 10, 2, (0, 0), torch.float64), TypeError),
    ((1, 8, 10, 2, (0, 0), torch.int32), TypeError),
])
def test_fusion_plan_raises_for_what_no_regime_takes(args, exc):
    with pytest.raises(exc):
        fl_ops.plan(*args)
