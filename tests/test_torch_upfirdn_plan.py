"""The host side of the upfirdn kernels (``ops/cuda_upfirdn.py``), on the
CPU: the route of every upfirdn launch of every preset, forward and
adjoint (no preset launch takes the general route); the tile kernel's
thread mapping, whose tiles must cover every output pixel and channel
exactly once, odd sizes and tails included; its input window (zero-filled
outside the image), which must hold every input the tile's outputs read,
with dimensions of at most 256 and shared memory within the card's
limit; the window rows' pitch, which must put the 16-byte reads of a
quarter warp in distinct banks.  An emulation of the tile and
small-channel kernels' decomposition (the window, the tap tables of
``ufd_taps``, per output phase for up = 2) is held to
``upfirdn2d_plain`` on the path's geometries, adjoints included, with
the symmetric blur and an asymmetric ramp filter.  The kernels themselves
run on the card only (``chip_smoke.py`` holds them to their plain
versions and the built library's plans to these)."""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import chip_smoke
from gansformer_tpu_torch.core import config as port_config
from gansformer_tpu_torch.ops import _build
from gansformer_tpu_torch.ops import cuda_upfirdn as cu
from gansformer_tpu_torch.ops.upfirdn2d import (adjoint_geometry, out_hw,
                                                setup_filter,
                                                upfirdn2d_adjoint_plain,
                                                upfirdn2d_plain)
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

BF16, F32 = torch.bfloat16, torch.float32


def _launch_geometry(call):
    """(H, W, C, up, down, pads, OH, OW) of the kernel launch a plan call
    makes: the forward's own geometry, or its adjoint's (factors swapped,
    ``grad_pad4`` padding, on the forward's output)."""
    h, c, up, down, pads = (call["H"], call["C"], call["up"],
                            call.get("down", 1), call["pads"])
    if call["kernel"] == "upfirdn":
        return (h, h, c, up, down, pads) + out_hw(h, h, 4, 4, up, down, pads)
    oh = out_hw(h, h, 4, 4, up, down, pads)[0]
    _, ua, da, gp = adjoint_geometry(h, h, np.ones((4, 4)), up, down, pads)
    return (oh, oh, c, ua, da, gp) + out_hw(oh, oh, 4, 4, ua, da, gp)


def _launches():
    """(preset, kernel, dtype, H, W, C, up, down, pads, OH, OW) of every
    distinct upfirdn launch, forward and adjoint, of one synthesize and
    one d_step + g_step (with and without d_attention) of every preset,
    in the preset's dtype and in fp32 (the smoke's fp32 checks)."""
    out = {}
    for name in sorted(port_config.PRESETS):
        cfg = port_config.get_preset(name)
        calls = chip_smoke.main_path_calls(cfg, 8)
        for model in (cfg, dataclasses.replace(cfg, d_attention=True)):
            calls = calls + chip_smoke.train_path_calls(model, 8)
        for call in calls:
            if call["kernel"] not in ("upfirdn", "upfirdn_adjoint"):
                continue
            for dtype in {cfg.dtype, "float32"}:
                key = (call["kernel"], dtype) + _launch_geometry(call)
                out.setdefault(key, name)
    return [(name,) + key for key, name in sorted(out.items())]


LAUNCHES = _launches()
# those on the tile route (the channels whole 16-byte vectors)
TILE_LAUNCHES = [launch for launch in LAUNCHES if launch[5] != 3]


def _ids(launch):
    name, kernel, dtype, h, w, c, up, down, pads, oh, ow = launch
    pad = "_".join(map(str, pads))
    return f"{name}-{kernel}-{dtype}-h{h}-c{c}-{up}{down}-p{pad}"


def _dtype(name):
    return getattr(torch, name)


def test_launches_of_every_preset_are_enumerated():
    """Every preset's blur, skip upsample, blur-pool and decimated skip,
    and their adjoints, in bf16 and fp32: 1/1, 2/1 and 1/2, at 3 to 512
    channels, with odd output sizes (the blur-pool's r + 1)."""
    presets = {launch[0] for launch in LAUNCHES}
    assert presets <= set(port_config.PRESETS)
    assert {launch[1] for launch in LAUNCHES} == {"upfirdn",
                                                  "upfirdn_adjoint"}
    assert {(launch[6], launch[7]) for launch in LAUNCHES} == set(cu.FACTORS)
    assert {launch[5] for launch in LAUNCHES} >= {3, 16, 32, 64, 512}
    assert any(launch[9] % 2 for launch in LAUNCHES)
    assert len(LAUNCHES) > 100


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_every_launch_takes_the_tile_or_small_channel_route(launch):
    """A 4x4 filter at 1/1, 2/1 or 1/2: the tile route where the channels
    are whole 16-byte vectors, the small-channel route for the 3-channel
    tRGB skip and its adjoint; no preset launch takes the general
    route."""
    _, _, dtype, _, _, c, up, down, _, _, _ = launch
    want = cu.PATH_SMALLC if c == 3 else cu.PATH_TILE
    assert cu.ufd_path(_dtype(dtype), c, up, down, 4, 4) == want
    assert cu.ufd_plan(_dtype(dtype), c, up, down, 4, 4).path == want


def _thread_outputs(plan):
    """(v, yl, xl) of every output one tile block writes, by its threads
    (the kernel's mapping: v fastest, then tile row, then column group;
    ry rows a thread, tr apart; p columns a row)."""
    tid = np.arange(cu.THREADS)
    v, slot = tid % plan.nv, tid // plan.nv
    r, gi = slot % plan.tr, slot // plan.tr
    out = []
    for k in range(plan.ry):
        for p in range(plan.p):
            out.append(np.stack([v, r + k * plan.tr, gi * plan.p + p], 1))
    return np.concatenate(out)


@pytest.mark.parametrize("launch", TILE_LAUNCHES, ids=_ids)
def test_tiles_cover_every_output_once(launch):
    """The tiles of the grid, each as its threads write it (tails masked),
    cover every output pixel exactly once, and each pixel's channel
    vectors of every channel block cover its channels exactly once."""
    _, _, dtype, _, _, c, up, down, _, oh, ow = launch
    plan = cu.ufd_plan(_dtype(dtype), c, up, down, 4, 4)
    vec = 8 if dtype == "bfloat16" else 4
    assert plan.th == plan.tr * plan.ry and plan.tw == plan.gx * plan.p
    assert plan.nv * plan.tr * plan.gx == cu.THREADS
    if up == 2:
        assert plan.tr % 2 == 0 and plan.tw % 2 == 0
    outs = _thread_outputs(plan)
    per_tile = np.zeros((plan.nv, plan.th, plan.tw), np.int64)
    np.add.at(per_tile, (outs[:, 0], outs[:, 1], outs[:, 2]), 1)
    assert (per_tile == 1).all()
    tiles_y, tiles_x = -(-oh // plan.th), -(-ow // plan.tw)
    cover = np.zeros((oh, ow), np.int64)
    yy, xx = outs[:, 1], outs[:, 2]
    for ty in range(tiles_y):
        for tx in range(tiles_x):
            oy, ox = ty * plan.th + yy, tx * plan.tw + xx
            keep = (oy < oh) & (ox < ow)
            np.add.at(cover, (oy[keep], ox[keep]), 1)
    assert (cover == plan.nv).all()        # once per channel vector
    cblocks = c // (plan.nv * vec)
    assert cblocks * plan.nv * vec == c


def _window(plan, up, down, pads, oy0, ox0):
    """(iy0, ix0) of a tile's window, and the window offsets (rows,
    columns) its outputs read."""
    py0, _, px0, _ = pads
    if up == 2:
        iy0, ix0 = (oy0 - py0) // 2, (ox0 - px0) // 2
        rows = np.arange(plan.th)[:, None] // 2 + np.arange(3)[None]
        cols = np.arange(plan.tw)[:, None] // 2 + np.arange(3)[None]
    else:
        iy0, ix0 = oy0 * down - py0, ox0 * down - px0
        rows = np.arange(plan.th)[:, None] * down + np.arange(4)[None]
        cols = np.arange(plan.tw)[:, None] * down + np.arange(4)[None]
    return iy0, ix0, rows, cols


@pytest.mark.parametrize("launch", LAUNCHES, ids=_ids)
def test_window_holds_the_tiles_inputs_and_fits(launch):
    """Every window offset a tile's outputs read lies inside its window
    (wh x ww pixels, at most 256 each way), whose shared memory fits the
    card's limit; the window rows' pitch holds every pixel; the library's
    own plan is checked against this one on the card."""
    _, _, dtype, h, w, c, up, down, pads, oh, ow = launch
    plan = cu.ufd_plan(_dtype(dtype), c, up, down, 4, 4)
    if plan.path != cu.PATH_TILE:
        assert plan.smem == 0
        return
    _, _, rows, cols = _window(plan, up, down, pads, 0, 0)
    assert rows.min() >= 0 and rows.max() < plan.wh
    assert cols.min() >= 0 and cols.max() < plan.ww
    assert plan.wh <= 256 and plan.ww <= 256
    assert plan.pitch >= plan.ww * plan.nv
    assert plan.smem == plan.wh * plan.pitch * 16
    assert plan.smem <= _build.SMEM_LIMIT
    assert cu.ufd_smem(_dtype(dtype), c, up, down) == plan.smem


@pytest.mark.parametrize("launch", TILE_LAUNCHES, ids=_ids)
def test_quarter_warp_reads_fall_in_distinct_banks(launch):
    """The 16-byte window reads of each quarter warp (8 threads), at the
    first tap of each row a thread computes: distinct addresses fall in
    distinct 16-byte bank groups (equal addresses are a broadcast)."""
    _, _, dtype, _, _, c, up, down, pads, _, _ = launch
    plan = cu.ufd_plan(_dtype(dtype), c, up, down, 4, 4)
    tid = np.arange(cu.THREADS)
    v, slot = tid % plan.nv, tid // plan.nv
    r, gi = slot % plan.tr, slot // plan.tr
    for k in range(plan.ry):
        yl = r + k * plan.tr
        if up == 2:
            wrow, wcol = yl // 2, gi * (plan.p // 2)
        else:
            wrow, wcol = yl * down, gi * plan.p * down
        unit = wrow * plan.pitch + wcol * plan.nv + v
        for q in range(0, cu.THREADS, 8):
            addrs = set(unit[q:q + 8].tolist())
            assert len({a % 8 for a in addrs}) == len(addrs), (k, q)


def _emulate(x, f, up, down, pads, th, tw):
    """The tile kernel's decomposition on the host: per th x tw output
    tile, its input window zero-filled outside the image, each output the
    sum over the window offsets of ``ufd_taps`` (the up = 2 table picks
    each output phase's taps); fp32.  With th = tw = 1 (up = 1) or 2 (up
    = 2) it is the small-channel kernel's decomposition."""
    n, h, w, c = x.shape
    oh, ow = out_hw(h, w, 4, 4, up, down, pads)
    py0, _, px0, _ = pads
    g = cu.ufd_taps(f, up, pads)
    y = np.zeros((n, oh, ow, c), np.float64)
    k = 3 if up == 2 else 4
    wh = th // 2 + 2 if up == 2 else (th - 1) * down + 4
    ww = tw // 2 + 2 if up == 2 else (tw - 1) * down + 4
    for oy0 in range(0, oh, th):
        for ox0 in range(0, ow, tw):
            if up == 2:
                iy0, ix0 = (oy0 - py0) // 2, (ox0 - px0) // 2
            else:
                iy0, ix0 = oy0 * down - py0, ox0 * down - px0
            win = np.zeros((n, wh, ww, c))
            ys, xs = np.arange(iy0, iy0 + wh), np.arange(ix0, ix0 + ww)
            yi, xi = (ys >= 0) & (ys < h), (xs >= 0) & (xs < w)
            win[:, yi.nonzero()[0][:, None], xi.nonzero()[0][None]] = \
                x[:, ys[yi][:, None], xs[xi][None]]
            acc = np.zeros((n, th, tw, c))
            for a in range(k):
                for j in range(k):
                    if up == 2:
                        for ay in range(2):
                            for ax in range(2):
                                tap = g[((ay * 2 + ax) * 3 + a) * 3 + j]
                                acc[:, ay::2, ax::2] += tap * win[
                                    :, a:a + th // 2, j:j + tw // 2]
                    else:
                        acc += g[a * 4 + j] * win[
                            :, a:a + (th - 1) * down + 1:down,
                            j:j + (tw - 1) * down + 1:down]
            hh, wwid = min(th, oh - oy0), min(tw, ow - ox0)
            y[:, oy0:oy0 + hh, ox0:ox0 + wwid] = acc[:, :hh, :wwid]
    return y


# (up, down, pads, H) of the path's geometries at a small size, forward
# and adjoint: G's blur and its adjoint, G's skip upsample and its
# adjoint (down 2), D's blur-pool (odd output) and its adjoint (odd
# input), D's decimated skip and its adjoint (up 2); and odd pads and
# crops for the up = 2 phase table.
GEOMETRIES = {
    "blur": (1, 1, (2, 1, 2, 1), 12),
    "blur adjoint": (1, 1, (1, 2, 1, 2), 12),
    "skip up": (2, 1, (2, 1, 2, 1), 6),
    "skip up adjoint": (1, 2, (1, 1, 1, 1), 12),
    "blur-pool": (1, 1, (2, 2, 2, 2), 11),
    "blur-pool adjoint": (1, 1, (1, 1, 1, 1), 13),
    "skip down": (1, 2, (1, 1, 1, 1), 11),
    "skip down adjoint": (2, 1, (2, 1, 2, 1), 5),
    "up2 odd pads": (2, 1, (1, 2, 3, 0), 5),
    "up2 crop": (2, 1, (-1, 2, 0, -1), 6),
}


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
@pytest.mark.parametrize("taps", ["blur", "ramp"])
@pytest.mark.parametrize("tile", [(2, 4), (4, 8), (16, 16), (1, 1)])
def test_emulated_kernels_match_plain(rng, name, taps, tile):
    """The tile decomposition (tiles smaller than, about and larger than
    the image) and the small-channel one (tile 1 x 1, or 2 x 2 with up =
    2) agree with ``upfirdn2d_plain``: the phase table's rows and
    columns, the windows' origins and the zero fill at every edge."""
    up, down, pads, h = GEOMETRIES[name]
    th, tw = tile
    if up == 2:
        th, tw = max(2, th), max(2, tw)
    f = setup_filter((1, 3, 3, 1) if taps == "blur" else chip_smoke.RAMP,
                     gain=4.0 if up == 2 else 1.0)
    x = rng.randn(2, h, h + 1, 3).astype(np.float32)
    ref = upfirdn2d_plain(torch.from_numpy(x), f, up, down, pads).numpy()
    got = _emulate(x, f, up, down, pads, th, tw)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_emulated_adjoint_matches_the_plain_adjoint(rng):
    """The adjoint launches run the same decomposition on the adjoint's
    geometry (flipped filter, factors swapped, ``grad_pad4``): held to
    ``upfirdn2d_adjoint_plain`` with the ramp filter, for the blur-pool
    and both skips."""
    f = setup_filter(chip_smoke.RAMP)
    for up, down, pads, h in ((1, 1, (2, 2, 2, 2), 9),
                              (2, 1, (2, 1, 2, 1), 5),
                              (1, 2, (1, 1, 1, 1), 10)):
        oh, ow = out_hw(h, h, 4, 4, up, down, pads)
        ct = rng.randn(2, oh, ow, 8).astype(np.float32)
        ref = upfirdn2d_adjoint_plain(torch.from_numpy(ct), f, up, down,
                                      pads, (h, h)).numpy()
        fa, ua, da, gp = adjoint_geometry(h, h, f, up, down, pads)
        plan = cu.ufd_tile(F32, 8, ua, da)
        got = _emulate(ct, fa, ua, da, gp, plan.th, plan.tw)
        assert got.shape[1:3] == (h, h)
        np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_phase_table_uses_each_tap_once():
    """With up = 2 the four output phases of a quad use 2 x 2 taps each,
    together each of the 16 taps exactly once (whatever the pads'
    parity)."""
    f = np.arange(1, 17, dtype=np.float32).reshape(4, 4)
    for pads in ((2, 1, 2, 1), (1, 2, 3, 0), (0, 0, 1, 1)):
        g = cu.ufd_taps(f, 2, pads).reshape(2, 2, 3, 3)
        for ay in range(2):
            for ax in range(2):
                assert np.count_nonzero(g[ay, ax]) == 4
        assert sorted(g[g != 0].tolist()) == list(range(1, 17))


def _source_constants():
    src = (pathlib.Path(_build.CSRC) / "upfirdn.cu").read_text()
    return {name: int(val) for name, val in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_plan_constants_match_the_kernel_source():
    """The wrapper's copy of the kernels' constants (threads a block,
    channels of the small-channel route, taps at most) is the source's."""
    const = _source_constants()
    assert const["kThreads"] == cu.THREADS
    assert const["kSmallC"] == cu.SMALL_C
    assert const["kMaxTaps"] == 64


def test_general_route_keeps_other_filters_and_factors():
    """A 3x3 filter, up 4 or more than SMALL_C channels that are not whole
    vectors take the general route (the smoke holds it on the card once,
    at a 3x3 filter)."""
    assert cu.ufd_path(BF16, 64, 1, 1, 3, 3) == cu.PATH_GENERAL
    assert cu.ufd_path(BF16, 64, 4, 1, 4, 4) == cu.PATH_GENERAL
    assert cu.ufd_path(BF16, 6, 1, 1, 4, 4) == cu.PATH_GENERAL
    assert cu.ufd_path(F32, 6, 2, 1, 4, 4) == cu.PATH_GENERAL
    assert cu.ufd_path(F32, 4, 1, 2, 4, 4) == cu.PATH_TILE
    assert cu.ufd_path(F32, 3, 1, 2, 4, 4) == cu.PATH_SMALLC


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 4, 8)
    f = setup_filter((1, 3, 3, 1))
    with pytest.raises(ValueError):
        cu.upfirdn2d_cuda(x, f, 1, 1, (2, 1, 2, 1), None, None, 0.2, 1.0)
    with pytest.raises(ValueError):
        cu.upfirdn2d_adjoint_cuda(x, f, 1, 1, (1, 2, 1, 2))
