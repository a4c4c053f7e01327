"""The host side of the modconv forward kernels (``ops/cuda_modconv.py``),
on the CPU: the path of every forward launch of every preset, the wgmma
tiles (128 consecutive pixels of the flattened [N * H * W], one TMA box:
whole rows, a run of one row, or whole samples) and the split of the
contraction over taps x 64-channel stages, which together must cover
every (pixel, column) and every stage exactly once, sample boundaries
included; the epilogue's 16-byte units, which must write every output
element once (poly's depth-to-space too); and the shared memory against
the card's limit.  An emulation of the wgmma kernel's decomposition
(boxes zero-filled outside the tensor, each row scaled by its own
sample's style, fp32 partials summed in split order) is held to
``modconv_plain``.  The kernels themselves run on the card only
(``chip_smoke.py`` holds them to their plain versions and checks that
the library's tile and shared memory agree with these)."""

import math
import pathlib
import re

import pytest
import torch

import chip_smoke
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops import cuda_modconv as cm
from gansformer_tpu_torch.ops import modulated_conv as port_mc
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132


def _fwd_launches():
    """(preset, kind, N, H, Ci, CoK) of every distinct modconv forward
    launch of one synthesize of every preset at batch 1, 2, 4 and 8 (a
    training step's forward launches are those at batch 8), named by the
    first preset that makes it; and the presets that make each."""
    out = {}
    for name in sorted(port_config.PRESETS):
        cfg = port_config.get_preset(name)
        for b in chip_smoke.BUCKETS:
            for c in chip_smoke.main_path_calls(cfg, b):
                if c["kernel"] == "modconv":
                    key = (c["kind"], b, c["H"], c["Ci"],
                           c["Co"] * cm.PHASES[c["kind"]])
                    out.setdefault(key, set()).add(name)
    return ([(min(names),) + key for key, names in sorted(out.items())],
            {key: names for key, names in out.items()})


LAUNCHES, PRESETS_OF = _fwd_launches()


def _ids(launch):
    return "{}-{}-b{}-h{}-{}x{}".format(*launch)


def _box(h, w):
    """(bw, bh, bn) of the tile's x box: 128 consecutive pixels as bw x
    bh pixels of bn samples."""
    bw = min(w, cm.FWD_TILE)
    bh, bn = cm.FWD_TILE // bw, 1
    if bh > h:
        bn, bh = bh // h, h
    return bw, bh, bn


def _box_rows(n, h, w, tile):
    """(sample, row, column) of each row of tile ``tile``'s x box at tap
    offset 0, in the box's order (channels innermost, then w, h, n), from
    the corner the kernel's producer computes."""
    base = tile * cm.FWD_TILE
    n0, p0 = divmod(base, h * w)
    h0, w0 = divmod(p0, w)
    bw, bh, bn = _box(h, w)
    return [(n0 + i, h0 + j, w0 + k) for i in range(bn) for j in range(bh)
            for k in range(bw)]


def _all_box_rows(n, h, w, tiles):
    """``_box_rows`` of tiles 0 .. tiles - 1 at once: (sample, row,
    column) tensors of [tiles, 128]."""
    base = torch.arange(tiles, dtype=torch.int32)[:, None] * cm.FWD_TILE
    n0, p0 = base // (h * w), base % (h * w)
    h0, w0 = p0 // w, p0 % w
    bw, bh, _ = _box(h, w)
    r = torch.arange(cm.FWD_TILE, dtype=torch.int32)[None, :]
    return n0 + r // (bh * bw), h0 + r // bw % bh, w0 + r % bw


def test_box_rows_at_once_are_the_box_rows():
    for n, h, w in ((3, 4, 4), (2, 8, 8), (1, 16, 16), (2, 2, 256)):
        tiles = -(-(n * h * w) // cm.FWD_TILE)
        sn, sh, sw = _all_box_rows(n, h, w, tiles)
        for tile in range(tiles):
            assert list(zip(sn[tile].tolist(), sh[tile].tolist(),
                            sw[tile].tolist())) == _box_rows(n, h, w, tile)


def test_launches_of_every_preset_are_enumerated():
    presets = set().union(*PRESETS_OF.values())
    assert presets == set(port_config.PRESETS)
    assert len(LAUNCHES) == len(PRESETS_OF)
    # bedroom256-duplex is ffhq256-duplex's ModelConfig: the same launches
    assert port_config.get_preset("bedroom256-duplex") == \
        port_config.get_preset("ffhq256-duplex")
    kinds = {launch[1] for launch in LAUNCHES}
    assert kinds == {"same3", "same1", "poly"}
    assert {launch[4] for launch in LAUNCHES} >= {16, 32, 64, 512}


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_every_forward_launch_takes_its_path(launch):
    """bf16: the tRGB (CoK = 3) takes the small-K kernel, every 3x3 and
    up-conv the wgmma kernel; fp32 (clevr64-simplex's dtype, and the
    fp32 checks of every preset) the FMA kernel."""
    _, kind, n, h, ci, cok = launch
    phases, taps = cm.PHASES[kind], cm.TAPS[kind]
    want = cm.PATH_SMALLK if kind == "same1" else cm.PATH_WGMMA
    assert cm.fwd_path(BF16, h, h, ci, cok, phases, taps) == want
    assert cm.fwd_path(F32, h, h, ci, cok, phases, taps) == cm.PATH_FMA


def test_shapes_off_the_fast_paths_take_the_fma_kernel():
    same3, same1 = cm.TAPS["same3"], cm.TAPS["same1"]
    # rows that do not tile a 128-pixel box, or samples that neither
    # divide nor fill one
    assert cm.fwd_path(BF16, 4, 48, 64, 64, 1, same3) == cm.PATH_FMA
    assert cm.fwd_path(BF16, 2, 192, 64, 64, 1, same3) == cm.PATH_FMA
    assert cm.fwd_path(BF16, 3, 64, 64, 64, 1, same3) == cm.PATH_FMA
    assert cm.fwd_path(BF16, 4, 4, 60, 64, 1, same3) == cm.PATH_FMA
    assert cm.fwd_path(BF16, 4, 4, 64, 60, 1, same3) == cm.PATH_FMA
    # poly writes 8 channels of a phase at a time
    assert cm.fwd_path(BF16, 4, 4, 64, 4 * 12, 4, cm.TAPS["poly"]) == \
        cm.PATH_FMA
    # the small-K kernel: one tap at offset 0, whole 16-byte chunks
    assert cm.fwd_path(BF16, 4, 4, 64, 3, 1, same1) == cm.PATH_SMALLK
    assert cm.fwd_path(BF16, 4, 4, 64, 3, 1, same3) == cm.PATH_FMA
    assert cm.fwd_path(BF16, 4, 4, 48, 3, 1, same1) == cm.PATH_FMA
    assert cm.fwd_path(BF16, 4, 4, 1024, 3, 1, same1) == cm.PATH_FMA
    assert cm.fwd_path(BF16, 4, 4, 64, 3, 1, same1) == cm.PATH_SMALLK
    assert [cm.fwd_tile_fits(h, w) for h, w in
            ((4, 4), (8, 8), (16, 16), (1024, 1024), (1, 256), (3, 64),
             (4, 48), (2, 8))] == [True, True, True, True, True, False,
                                   False, True]


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_tiles_and_splits_cover_every_pixel_column_and_stage_once(launch):
    """Each tile's TMA box holds exactly the 128 pixels the kernel
    assigns to its rows (whole rows of one sample, a run of one row, or
    whole samples; rows past the last pixel fall outside the tensor), so
    the tiles x column blocks cover every (pixel, column) once; the
    splits cover every (tap, 64-channel) stage once, each keeping at
    least FWD_MIN_SPLIT_STAGES."""
    _, kind, n, h, ci, cok = launch
    phases, taps = cm.PHASES[kind], cm.TAPS[kind]
    path = cm.fwd_path(BF16, h, h, ci, cok, phases, taps)
    if path != cm.PATH_WGMMA:
        bm = cm.fwd_tile(path, cok)[0]
        assert bm == cm.FWD_SMALL_TILE and \
            cm.fwd_split(n, h, h, ci, cok, 1, SMS, path) == 1
        return
    hw, pixels = h * h, n * h * h
    bm, bn = cm.fwd_tile(path, cok)
    tiles = -(-pixels // bm)
    sn, sh, sw = _all_box_rows(n, h, h, tiles)      # [tiles, 128] each
    f = torch.arange(tiles * bm, dtype=torch.int32).reshape(tiles, bm)
    inside = f < pixels
    assert torch.equal(sn[inside], f[inside] // hw)
    assert torch.equal(sh[inside], f[inside] % hw // h)
    assert torch.equal(sw[inside], f[inside] % h)
    # rows past the last pixel fall outside the tensor: read as zeros
    assert bool(((sn >= n) | (sh >= h) | (sw >= h))[~inside].all())
    seen = torch.bincount(f[inside].long(), minlength=pixels)
    assert torch.all(seen == 1)
    cols = torch.zeros(cok, dtype=torch.int64)
    for c0 in range(0, cok, bn):
        cols[c0:c0 + bn] += 1
    assert torch.all(cols == 1)
    p = cm.fwd_split(n, h, h, ci, cok, len(taps), SMS, path)
    kchunks = -(-ci // cm.FWD_STAGE_K)
    stages = [st for b in range(p)
              for st in cm.fwd_split_stages(ci, len(taps), p, b)]
    assert sorted(stages) == [(t, k * cm.FWD_STAGE_K)
                              for t in range(len(taps))
                              for k in range(kchunks)]
    if p > 1:
        assert all(len(cm.fwd_split_stages(ci, len(taps), p, b))
                   >= cm.FWD_MIN_SPLIT_STAGES for b in range(p))


def _emitted(n, h, w, cok, phases, p, bn):
    """How many times the epilogue (P = 1: the wgmma kernel's 16-byte
    units; P > 1: fwd_reduce_kernel's threads) writes each element of y
    [N, up H, up W, Co], walking the kernels' index maps."""
    up = 2 if phases == 4 else 1
    co_n = cok // phases
    y = torch.zeros(n, up * h, up * w, co_n, dtype=torch.int64)
    pixels = n * h * w

    def emit(f, j0, ph):
        sn, pp = divmod(f, h * w)
        hh, ww = divmod(pp, w)
        if phases == 1:
            y[sn, hh, ww, j0:j0 + 8] += 1
        else:
            a, b = divmod(ph, 2)
            y[sn, 2 * hh + a, 2 * ww + b, j0:j0 + 8] += 1

    if p > 1:
        for f in range(pixels):
            for u in range(cok // (8 * phases)):
                for ph in range(phases):
                    emit(f, u * 8, ph)
        return y
    units, groups = bn // 8, bn // 32
    for tile in range(-(-pixels // cm.FWD_TILE)):
        for c0 in range(0, cok, bn):
            for r in range(cm.FWD_TILE):
                f = tile * cm.FWD_TILE + r
                if f >= pixels:
                    continue
                for u in range(units):
                    if phases == 1:
                        if c0 + u * 8 < cok:
                            emit(f, c0 + u * 8, 0)
                    else:
                        ph, g = divmod(u, groups)
                        co = c0 // 4 + g * 8
                        if co < co_n:
                            emit(f, co, ph)
    return y


@pytest.mark.parametrize("kind,n,h,cok,p", [
    ("same3", 2, 16, 128, 1), ("same3", 3, 4, 64, 1), ("poly", 2, 8, 256, 1),
    ("poly", 3, 4, 64, 1), ("poly", 1, 16, 128, 1), ("same3", 3, 4, 192, 2),
    ("poly", 2, 4, 64, 3)])
def test_epilogue_writes_every_output_element_once(kind, n, h, cok, p):
    """16 bytes a thread: 8 columns of one pixel, or (poly) 8 channels of
    one phase, co-major columns co * 4 + a * 2 + b to (2h + a, 2w + b,
    co); the reduce of split launches does the same from the partials."""
    phases = cm.PHASES[kind]
    _, bn = cm.fwd_tile(cm.PATH_WGMMA, cok)
    y = _emitted(n, h, h, cok, phases, p, bn)
    assert torch.all(y == 1)


def _emulate(x, ws, s, post, bias, kind, act, p):
    """y by the wgmma kernel's decomposition: per 128-pixel tile, its x
    box at each stage's tap offset (zero outside the tensor, dimension by
    dimension), each row scaled by its own sample's s in fp32 and rounded
    to x's dtype, times the stage's 64 x CoK weight slab; the splits'
    fp32 partials summed in split order; then d, the bias and act."""
    n, h, w, ci = x.shape
    t_n, _, cok = ws.shape
    phases, taps = cm.PHASES[kind], cm.TAPS[kind]
    hw, pixels = h * w, n * h * w
    bm, k = cm.FWD_TILE, cm.FWD_STAGE_K
    kchunks = -(-ci // k)
    tiles = -(-pixels // bm)
    xz = torch.zeros(n, h, w, kchunks * k)
    xz[..., :ci] = x.float()
    sz = torch.zeros(n, kchunks * k)
    sz[:, :ci] = s.float()
    wz = torch.zeros(t_n, kchunks * k, cok)
    wz[:, :ci] = ws.float()
    total = torch.zeros(tiles * bm, cok)
    for tile in range(tiles):
        rows = torch.tensor(_box_rows(n, h, w, tile))
        flat = torch.arange(tile * bm, (tile + 1) * bm)
        srow = sz[torch.clamp(flat // hw, max=n - 1)]
        parts = torch.zeros(p, bm, cok)
        for b in range(p):
            for t, c0 in cm.fwd_split_stages(ci, t_n, p, b):
                oy, ox = taps[t]
                rn, rh, rw = rows[:, 0], rows[:, 1] + oy, rows[:, 2] + ox
                inside = ((rn < n) & (rh >= 0) & (rh < h) & (rw >= 0)
                          & (rw < w))
                a = torch.zeros(bm, k)
                a[inside] = xz[rn[inside], rh[inside], rw[inside], c0:c0 + k]
                a = (a * srow[:, c0:c0 + k]).to(x.dtype).float()
                parts[b] += a @ wz[t, c0:c0 + k]
        acc = torch.zeros(bm, cok)
        for b in range(p):
            acc += parts[b]
        total[tile * bm:(tile + 1) * bm] = acc
    y = total[:pixels].reshape(n, h, w, cok) * post.float()[:, None, None, :]
    if phases == 4:
        co = cok // 4
        y = (y.reshape(n, h, w, co, 2, 2).permute(0, 1, 4, 2, 5, 3)
             .reshape(n, 2 * h, 2 * w, co))
    if act is not None:
        y = torch.where(y + bias >= 0, y + bias, 0.2 * (y + bias))
    return y


@pytest.mark.parametrize("kind,n,h,w,ci,co,dtype", [
    ("same3", 3, 4, 4, 72, 64, F32),     # whole samples, last tile partial
    ("same3", 1, 16, 16, 64, 64, F32),   # whole rows of one sample
    ("same3", 2, 2, 256, 16, 8, F32),    # runs of one row; Ci < 64
    ("poly", 2, 8, 8, 64, 32, F32),      # two samples a tile
    ("poly", 3, 4, 4, 32, 16, F32),
    ("same1", 2, 8, 8, 64, 16, F32),
    ("same3", 3, 4, 4, 64, 64, BF16),    # x * s rounded to bf16
    ("poly", 2, 4, 4, 64, 16, BF16)])
def test_emulated_decomposition_matches_the_plain_version(rng, kind, n, h, w,
                                                          ci, co, dtype):
    """The kernel's tiles, boxes, per-row styles and split walk compute
    ``modconv_plain``: exactly up to fp32 summation order with fp32
    inputs; with bf16 inputs up to the rounding of x * s to bf16 (the
    rounding point of ``_ref_core``, which the plain version computes in
    fp32), within the smoke's bf16 tolerance."""
    ks = 1 if kind == "same1" else 3
    x = torch.from_numpy(rng.randn(n, h, w, ci).astype("float32")).to(dtype)
    wt = torch.from_numpy((rng.randn(ks, ks, ci, co) / math.sqrt(ci * ks * ks))
                          .astype("float32"))
    s = torch.from_numpy((rng.randn(n, ci) * 0.3 + 1.0).astype("float32"))
    ws = port_mc.stack_weights(kind, wt)
    cok = ws.shape[2]
    post = torch.from_numpy((rng.rand(n, cok) + 0.5).astype("float32"))
    bias = torch.from_numpy(rng.randn(cok // cm.PHASES[kind])
                            .astype("float32"))
    act = "lrelu" if kind != "poly" else None
    ref = port_mc.modconv_plain(x.float(), ws, s, post, bias, kind, act, 0.2,
                                1.0)
    tol = 1e-5 if dtype == F32 else chip_smoke.KERNEL_TOL["bfloat16"]
    scale = float(ref.abs().max())
    for p in sorted({1, cm.fwd_split(n, h, w, ci, cok, ws.shape[0], SMS),
                     min(3, ws.shape[0] * -(-ci // 64))}):
        got = _emulate(x, ws, s, post, bias, kind, act, p)
        assert float((got - ref).abs().max()) <= tol * scale, p


def test_split_fills_the_card_where_the_tiles_do_not():
    """P = 1 where the tiles give half as many blocks as SMs; below that
    enough splits for a block per SM, each of at least
    FWD_MIN_SPLIT_STAGES stages.  At batch 8, 512 channels: res 4 splits
    its 72 stages over 33 blocks per tile, res 16 over 3, res 32 not at
    all."""
    assert cm.fwd_split(8, 4, 4, 512, 512, 9, SMS) == 33
    assert cm.fwd_split(8, 8, 8, 512, 512, 9, SMS) == 9
    assert cm.fwd_split(8, 16, 16, 512, 512, 9, SMS) == 3
    assert cm.fwd_split(8, 32, 32, 512, 512, 9, SMS) == 1
    assert cm.fwd_split(8, 4, 4, 512, 2048, 4, SMS) == 9       # poly to 8
    assert cm.fwd_split(1, 4, 4, 512, 512, 9, SMS) == 33
    assert cm.fwd_split(8, 4, 4, 16, 64, 1, SMS) == 1          # one stage
    assert cm.fwd_split(8, 4, 4, 512, 3, 1, SMS, cm.PATH_SMALLK) == 1
    for launch in LAUNCHES:
        _, kind, n, h, ci, cok = launch
        taps = cm.TAPS[kind]
        path = cm.fwd_path(BF16, h, h, ci, cok, cm.PHASES[kind], taps)
        p = cm.fwd_split(n, h, h, ci, cok, len(taps), SMS, path)
        bm, bn = cm.fwd_tile(path, cok)
        tiles = -(-(n * h * h) // bm) * -(-cok // bn)
        stages = len(taps) * -(-ci // cm.FWD_STAGE_K)
        if path != cm.PATH_WGMMA or 2 * tiles >= SMS:
            assert p == 1, launch
        else:
            assert p * tiles >= SMS or \
                p == stages // cm.FWD_MIN_SPLIT_STAGES, launch


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_forward_shared_memory_fits_the_card(launch):
    """The ring's 9 slots (7 for the 128-wide tile; the x tile of 128
    pixels x 64 channels and the columns / 64 weight blocks of 64 x 64,
    128-byte rows, which the epilogue's fp32 tile reuses) + 1 KB of
    alignment slack, under the 232,448 bytes a block may opt in to; none
    off the wgmma path."""
    _, kind, n, h, ci, cok = launch
    for dtype in (BF16, F32):
        path = cm.fwd_path(dtype, h, h, ci, cok, cm.PHASES[kind],
                           cm.TAPS[kind])
        nbytes = cm.fwd_smem(path, cok)
        assert (nbytes > 0) == (path == cm.PATH_WGMMA)
        _build.check_smem(nbytes, "launch")
    assert cm.fwd_smem(cm.PATH_WGMMA, 512) == \
        7 * (128 * 128 + 2 * 8192) + 1024
    assert cm.fwd_smem(cm.PATH_WGMMA, 64) == 9 * (128 * 128 + 8192) + 1024
    for cok in (64, 512):                # the epilogue's tile fits the ring
        bn = cm.fwd_tile(cm.PATH_WGMMA, cok)[1]
        assert cm.fwd_smem(cm.PATH_WGMMA, cok) >= 128 * (bn + 4) * 4 + 1024
    assert cm.FWD_TILE_PIXELS == {cm.PATH_FMA: 64, cm.PATH_WGMMA: 128,
                                  cm.PATH_SMALLK: 256}


def test_forward_wrapper_refuses_cpu_tensors():
    """On a CPU tensor the wrapper raises (the routing layer runs the
    plain version there); it never falls back itself."""
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cm.modconv_cuda(x, torch.zeros(9, 8, 8), torch.ones(1, 8),
                        torch.ones(1, 8), None, "same3", None, 0.2, 1.0)


def test_forward_plan_is_worked_out_once_per_shape():
    taps = cm.TAPS["same3"]
    assert cm._fwd_plan(BF16, 8, 4, 4, 512, 512, 1, taps, SMS) == \
        (cm.PATH_WGMMA, 33)
    assert cm._fwd_plan(F32, 8, 4, 4, 512, 512, 1, taps, SMS) == \
        (cm.PATH_FMA, 1)
    hits = cm._fwd_plan.cache_info().hits
    cm._fwd_plan(BF16, 8, 4, 4, 512, 512, 1, taps, SMS)
    assert cm._fwd_plan.cache_info().hits == hits + 1


def _source_constants():
    """The forward plan's constants as ``csrc/modconv.cu`` defines them:
    every ``constexpr int kName = value;`` and ``fwd_stages``' slots by
    tile width."""
    src = (pathlib.Path(cm.__file__).resolve().parent.parent / "csrc" /
           "modconv.cu").read_text()
    consts = {name: math.prod(int(f) for f in expr.split("*"))
              for name, expr in re.findall(
                  r"constexpr int (k\w+) = ([\d *]+);", src)}
    wide, narrow = re.search(r"fwd_stages\(\) \{\s*return BN == 128 \? "
                             r"(\d+) : (\d+);", src).groups()
    return consts, {128: int(wide), 64: int(narrow)}


def test_forward_plan_constants_match_the_kernel_source():
    """The wrapper's copy of the forward plan (ops/cuda_modconv.py) and
    the kernel's (csrc/modconv.cu) change together: tile, stage, ring
    slots, small-K limits and the shared memory they give."""
    k, stages = _source_constants()
    assert (k["kFwdBM"], k["kFwdBK"], k["kBM"]) == \
        (cm.FWD_TILE, cm.FWD_STAGE_K, cm.FMA_TILE)
    assert stages == cm.FWD_STAGES
    assert (k["kSmallK"], k["kSmallTile"], k["kSmallPer"]) == \
        (cm.SMALL_K, cm.FWD_SMALL_TILE, cm.FWD_SMALL_PER)
    for bn in (64, 128):
        stage = k["kFwdBM"] * 128 + bn // 64 * k["kBlock"]
        assert cm.fwd_smem(cm.PATH_WGMMA, bn) == \
            stages[bn] * stage + k["kAlign"]


# A ``static`` whose initializer makes a shared-memory opt-in (up to the
# statement's end).
_STATIC_OPT_IN = re.compile(
    r"\bstatic\b[^;{}]*\b(set_smem|cudaFuncSetAttribute)\s*\(", re.S)


def test_no_static_caches_a_shared_memory_opt_in():
    """``cudaFuncSetAttribute(..., MaxDynamicSharedMemorySize, ...)``
    (``set_smem``) acts on the current device only: the attribute belongs
    to a device, not to the kernel.  A launcher that keeps the result in
    a function-local ``static`` opts in on the first device it runs on
    and skips the opt-in on every other card, where a launch with more
    than 48 KB of dynamic shared memory is then refused.  So no source
    under ``csrc/`` may cache one; the planted line below shows that the
    pattern finds such a cache."""
    csrc = pathlib.Path(cm.__file__).resolve().parent.parent / "csrc"
    sources = sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh"))
    assert {p.name for p in sources} >= {"modconv.cu", "modconv_bwd.cu",
                                          "attention.cu", "upfirdn.cu"}
    found = [(p.name, m.group(0)) for p in sources
             for m in _STATIC_OPT_IN.finditer(p.read_text())]
    assert not found, found
    planted = ("  static const int attr =\n"
               "      set_smem(fwd_wgmma_kernel<BN>, smem);\n")
    assert _STATIC_OPT_IN.search(planted)
    assert not _STATIC_OPT_IN.search(
        "  const int attr = set_smem(fwd_wgmma_kernel<BN>, smem);\n")
    launcher = (csrc / "modconv.cu").read_text()
    assert "const int attr = set_smem(fwd_wgmma_kernel<BN>, smem);" in \
        launcher
