"""The host side of the modconv backward kernels (``ops/cuda_modconv.py``),
on the CPU: the path each launch of ffhq256-duplex takes, the dw split
planner (splits cut at sample boundaries, every pixel of every sample
covered exactly once), the dx tile that sizes the ds partials, and the
dynamic shared memory of the wgmma kernels against the card's limit.  The
kernels themselves run on the card only (``chip_smoke.py`` holds them to
their plain versions and checks that the library's tile and shared
memory agree with these)."""

import itertools

import pytest
import torch

import chip_smoke
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops import cuda_modconv as cm
from gansformer_tpu_torch.ops import modulated_conv as port_mc
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32


def _bwd_launches():
    """(which, kind, N, H, Ci, CoK, taps) of every modconv backward launch
    of one g_step of ffhq256-duplex at batch 8."""
    calls = chip_smoke.train_path_calls(
        port_config.get_preset("ffhq256-duplex"), 8)
    out = []
    for c in calls:
        if c["kernel"] not in ("modconv_dx", "modconv_dw"):
            continue
        which = "dx" if c["kernel"] == "modconv_dx" else "dw"
        taps = (port_mc.adjoint_taps(c["kind"]) if which == "dx"
                else cm.TAPS[c["kind"]])
        cok = c["Co"] * (4 if c["kind"] == "poly" else 1)
        out.append((which, c["kind"], c["B"], c["H"], c["Ci"], cok, taps))
    return out


LAUNCHES = _bwd_launches()


def _units(n, h, w, s, r, p):
    """Each dw split's (sample, first pixel, end pixel) units, in order:
    the walk of the dw kernels (``DwCursor`` in csrc/modconv_bwd.cu, and
    the FMA kernel's chunk walk)."""
    units = n * s
    return [[(u // s, (u % s) * r, min(h * w, (u % s + 1) * r))
             for u in range(units * b // p, units * (b + 1) // p)]
            for b in range(p)]


def test_every_launch_takes_its_path():
    """bf16: the tRGB (CoK = 3, one tap at offset 0) takes the small-K
    kernels, every 3x3 and up-conv the wgmma kernels; fp32 the FMA
    kernels; a width that does not tile a TMA box falls back to FMA."""
    assert len(LAUNCHES) == 40
    for which, kind, n, h, ci, cok, taps in LAUNCHES:
        want = cm.PATH_SMALLK if kind == "same1" else cm.PATH_WGMMA
        assert cm.bwd_path(which, BF16, cok, ci, h, taps) == want
        assert cm.bwd_path(which, F32, cok, ci, h, taps) == cm.PATH_FMA
    taps3 = cm.TAPS["same3"]
    assert cm.bwd_path("dx", BF16, 64, 64, 48, taps3) == cm.PATH_FMA
    assert cm.bwd_path("dw", BF16, 64, 64, 96, taps3) == cm.PATH_FMA
    assert cm.bwd_path("dw", BF16, 64, 64, 192, taps3) == cm.PATH_FMA
    assert cm.dw_stage_pixels(cm.PATH_WGMMA, 64, 64, 65536) == 64
    assert cm.dw_stage_pixels(cm.PATH_WGMMA, 512, 512, 1024) == 128
    assert cm.dw_stage_pixels(cm.PATH_WGMMA, 512, 512, 64) == 64
    assert cm.dw_stage_pixels(cm.PATH_FMA, 512, 512, 1024) == 64
    assert cm.bwd_path("dx", BF16, 60, 64, 32, taps3) == cm.PATH_FMA
    # the small-K kernels take one tap at offset 0 only
    assert cm.bwd_path("dx", BF16, 3, 64, 6, cm.TAPS["same1"]) == \
        cm.PATH_SMALLK
    assert cm.bwd_path("dx", BF16, 3, 64, 6, taps3) == cm.PATH_FMA


@pytest.mark.parametrize("launch", [l for l in LAUNCHES if l[0] == "dw"],
                         ids=lambda l: f"{l[1]}-{l[3]}-{l[4]}x{l[5]}")
def test_dw_split_cuts_at_samples_and_covers_every_pixel(launch):
    """Each split of the planner is one unit inside one sample, or a run
    of whole samples; together the splits take every pixel of every
    sample exactly once, in whole stages where a unit is cut."""
    _, kind, n, h, ci, cok, taps = launch
    for dtype in (BF16, F32):
        path = cm.bwd_path("dw", dtype, cok, ci, h, taps)
        s, r, p = cm.dw_split(n, h, h, ci, cok, len(taps), 132, path)
        assert s * r >= h * h and 1 <= p <= n * s
        if s > 1:
            assert r % cm.dw_stage_pixels(path, ci, cok, h * h) == 0
        seen = torch.zeros(n, h * h, dtype=torch.int64)
        for units in _units(n, h, h, s, r, p):
            assert units
            samples = {u[0] for u in units}
            if len(samples) > 1:          # whole samples only
                assert all(u[1] == 0 and u[2] == h * h for u in units)
            for sample, b, e in units:
                assert 0 <= b < e <= h * h
                seen[sample, b:e] += 1
        assert torch.all(seen == 1)


@pytest.mark.parametrize("n,h,ci,cok,ntaps", [
    (8, 256, 64, 64, 9), (8, 128, 128, 128, 9), (8, 4, 512, 512, 9),
    (8, 32, 512, 1024, 4), (3, 16, 64, 64, 9), (1, 8, 64, 64, 1),
    (5, 64, 256, 256, 9)])
def test_dw_split_fills_the_card_and_keeps_whole_stages(n, h, ci, cok,
                                                        ntaps):
    """The wgmma split keeps at least DW_MIN_PIXELS pixels a split where
    it splits at all, and reaches DW_BLOCKS_PER_SM blocks per SM where the
    pixels allow; one split (P = 1) writes dw without partials."""
    s, r, p = cm.dw_split(n, h, h, ci, cok, ntaps, 132, cm.PATH_WGMMA)
    bm, bn = cm.dw_tile(cm.PATH_WGMMA, ci, cok)
    blocks = -(-ci // bm) * -(-cok // bn) * ntaps * p
    pixels = n * h * h
    if p > 1:
        assert pixels // p >= cm.DW_MIN_PIXELS or s > 1
    assert blocks >= min(cm.DW_BLOCKS_PER_SM * 132,
                         -(-ci // bm) * -(-cok // bn) * ntaps
                         * max(1, pixels // cm.DW_MIN_PIXELS))
    # the smallest split count that does so (P - 1 would not)
    if p > 1 and s == 1:
        smaller = [d for d in range(1, p) if n % d == 0]
        assert all(-(-ci // bm) * -(-cok // bn) * ntaps * d
                   < cm.DW_BLOCKS_PER_SM * 132 for d in smaller)


def test_small_k_dw_units_fill_the_card():
    """One block per unit of whole 64-pixel stages, at least
    SIMT_BLOCKS_PER_SM blocks per SM where the pixels allow."""
    assert cm.dw_split(8, 256, 256, 64, 3, 1, 132, cm.PATH_SMALLK) == \
        (64, 1024, 512)
    assert cm.dw_split(8, 32, 32, 512, 3, 1, 132, cm.PATH_SMALLK) == \
        (16, 64, 128)
    assert cm.dw_split(8, 4, 4, 512, 3, 1, 132, cm.PATH_SMALLK) == (1, 16, 8)


def test_dx_tile_sizes_the_ds_partials():
    """The tile of each path: 128 pixels x 64 or 128 channels on wgmma
    (the ds partial of the smoke's dropped-tile control), 256 pixels on
    the small-K path, 64 x 64 on FMA."""
    assert cm.dx_tile(cm.PATH_WGMMA, 512) == (128, 128)
    assert cm.dx_tile(cm.PATH_WGMMA, 64) == (128, 64)
    assert cm.dx_tile(cm.PATH_SMALLK, 64) == (256, 64)
    assert cm.dx_tile(cm.PATH_FMA, 512) == (64, 64)
    assert cm.TILE_PIXELS == {cm.PATH_FMA: 64, cm.PATH_WGMMA: 128,
                              cm.PATH_SMALLK: 256}
    assert cm.dw_tile(cm.PATH_WGMMA, 512, 2048) == (128, 128)
    assert cm.dw_tile(cm.PATH_WGMMA, 64, 64) == (64, 64)


def test_shared_memory_of_every_launch_fits_the_card():
    """The ring's bytes: slots x (A and B tiles of 64- or 128-row, 128-byte
    swizzled blocks) + 1 KB of alignment slack, each under the 232,448
    bytes a block may opt in to; none off the wgmma path."""
    block = 64 * 128
    assert cm.bwd_smem("dx", cm.PATH_WGMMA, 512, 512, 16) == \
        5 * (2 * block + 2 * block) + 1024
    assert cm.bwd_smem("dx", cm.PATH_WGMMA, 64, 64, 65536) == \
        3 * (2 * block + block) + 1024
    assert cm.bwd_smem("dw", cm.PATH_WGMMA, 512, 512, 1024) == \
        3 * 4 * 2 * block + 1024       # 128-pixel stages
    assert cm.bwd_smem("dw", cm.PATH_WGMMA, 512, 512, 64) == \
        5 * 4 * block + 1024           # 64-pixel stages at res 8
    assert cm.bwd_smem("dw", cm.PATH_WGMMA, 64, 64, 65536) == \
        4 * 2 * block + 1024
    for which, kind, n, h, ci, cok, taps in LAUNCHES:
        for dtype in (BF16, F32):
            path = cm.bwd_path(which, dtype, cok, ci, h, taps)
            nbytes = cm.bwd_smem(which, path, cok, ci, h * h)
            assert (nbytes > 0) == (path == cm.PATH_WGMMA)
            assert nbytes <= _build.SMEM_LIMIT
            _build.check_smem(nbytes, "launch")


def test_check_smem_refuses_a_launch_above_the_limit():
    _build.check_smem(_build.SMEM_LIMIT, "at the limit")
    with pytest.raises(ValueError, match="shared memory"):
        _build.check_smem(_build.SMEM_LIMIT + 1, "one byte over")


@pytest.mark.parametrize("wrapper", ["modconv_dx_cuda", "modconv_dw_cuda"])
def test_wrappers_refuse_cpu_tensors(wrapper):
    """On a CPU tensor the wrappers raise (the routing layer runs the
    plain version there); they never fall back themselves."""
    x = torch.zeros(1, 4, 4, 8)
    args = ((x, torch.zeros(1, 8, 8), torch.ones(1, 8), torch.ones(1, 8), x,
             ((0, 0),)) if wrapper == "modconv_dx_cuda" else
            (x, x, torch.ones(1, 8), torch.ones(1, 8), ((0, 0),)))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(cm, wrapper)(*args)


def test_launch_plans_are_worked_out_once_per_shape():
    """The wrappers' per-shape plan (path, tiles or split, the checked
    shared memory) and tap arrays repeat every step: cached by shape."""
    a = cm._taps_arrays(cm.TAPS["same3"])
    b = cm._taps_arrays(tuple(itertools.chain(cm.TAPS["same3"])))
    assert a[0] is b[0] and list(a[0]) == [-1, -1, -1, 0, 0, 0, 1, 1, 1]
    assert list(a[1]) == [-1, 0, 1] * 3
    taps = tuple(port_mc.adjoint_taps("same3"))
    assert cm._dx_plan(BF16, 64, 64, 256, 256, taps) == (cm.PATH_WGMMA, 32)
    assert cm._dx_plan(F32, 64, 64, 256, 256, taps) == (cm.PATH_FMA, 64)
    assert cm._dw_plan(BF16, 8, 256, 256, 64, 64, cm.TAPS["same3"], 132) \
        == (cm.PATH_WGMMA,) + cm.dw_split(8, 256, 256, 64, 64, 9, 132)
    hits = cm._dx_plan.cache_info().hits
    cm._dx_plan(BF16, 64, 64, 256, 256, taps)
    assert cm._dx_plan.cache_info().hits == hits + 1
