"""The attention backward of the PyTorch port against the JAX package, on
the CPU.

The plain versions that are the card's oracles for the attention
backward kernels (``attention_fwd_stats_plain``, ``attention_bwd_plain``
and its delta-from-o form) are held to the JAX package's own oracles
(``_ref_fwd_stats``, ``_ref_bwd``), to the Pallas kernels in interpret
mode (the forward's ``lse`` and ``jax.vjp`` of
``multihead_attention_pallas`` at ``block_n=16``, so n = 60 leaves a
ragged last block) and to autograd of ``attention_plain``.  Then the
card's route, with every launch stubbed by its plain version (the
``card_route`` fixture): ``fused_multihead_attention`` builds the
Functions' graph, its gradients match JAX, the counters move by one
forward and one backward per call, the no-grad forward writes no ``lse``,
and R1's double backward through the Functions matches ``jax.grad`` of
``jax.grad`` through the Pallas op.

Tolerances: fp32 ``GRAD["float32"]`` (1e-5; both sides fp32, summation
order apart).  bf16 inputs: 2e-2 of max |ref| per output, the smoke's
``KERNEL_TOL``: dq, dk, dv are computed in fp32 from the same bf16 inputs
and rounded to bf16 once (2^-8 relative) on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gansformer_tpu.ops.pallas_attention import (_grid_to_latent_fwd,
                                                 _latent_to_grid_fwd,
                                                 _ref_bwd, _ref_fwd_stats,
                                                 multihead_attention_pallas)
from gansformer_tpu_torch import ops
from gansformer_tpu_torch.ops.attention import (attention_bwd_plain,
                                                attention_bwd_with_o_plain,
                                                attention_delta,
                                                attention_fwd_stats_plain,
                                                attention_plain)
from tests.test_torch_grads import card_route  # noqa: F401  (fixture)
from tests.tolerances import GRAD
from tests.torch_threads import one_thread  # noqa: F401  (autouse)

TOL = GRAD["float32"]
BF16_TOL = 2e-2
N = 60                     # grid positions: not a multiple of block_n = 16
L = 5                      # latents
HEADS = (1, 2)
DIRECTIONS = ("grid_to_latent", "latent_to_grid")


def _inputs(rng, direction, heads, b=2, d=8, dv=12):
    """q, k, v, do (numpy fp32) of one multi-head call; the grid is the
    query side for grid_to_latent and the key side for latent_to_grid."""
    lq, lk = (N, L) if direction == "grid_to_latent" else (L, N)
    q = rng.randn(b, lq, d * heads).astype(np.float32)
    k = rng.randn(b, lk, d * heads).astype(np.float32)
    v = rng.randn(b, lk, dv * heads).astype(np.float32)
    do = rng.randn(b, lq, dv * heads).astype(np.float32)
    return q, k, v, do


def _t(a, grad=False, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype) \
        .requires_grad_(grad)


def _close(got, ref, err_msg="", tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(ref, np.float64), err_msg=err_msg,
                               **tol)


def _close_bf16(got, ref, err_msg=""):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    ref = np.asarray(jnp.asarray(ref, jnp.float32), np.float64)
    err = float(np.abs(got - ref).max())
    assert err <= BF16_TOL * float(np.abs(ref).max()), (err_msg, err)


def _fold(t, heads):
    n, length, width = t.shape
    return (t.reshape(n, length, heads, width // heads).transpose(1, 2)
            .reshape(n * heads, length, width // heads))


def _unfold(t, n, heads):
    _, length, width = t.shape
    return (t.reshape(n, heads, length, width).transpose(1, 2)
            .reshape(n, length, heads * width))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_stats_plain_matches_ref_fwd_stats(rng, dtype):
    """o bit for bit ``attention_plain``'s, and (o, lse) against
    ``_ref_fwd_stats`` on the same (rounded) inputs."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    q, k, v, _ = _inputs(rng, "grid_to_latent", 1)
    tq, tk, tv = (_t(a, dtype=tdt) for a in (q, k, v))
    o, lse = attention_fwd_stats_plain(tq, tk, tv)
    assert torch.equal(o, attention_plain(tq, tk, tv))
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (2, N)
    jo, jlse = _ref_fwd_stats(*(jnp.asarray(a, jnp.float32).astype(jdt)
                                for a in (q, k, v)))
    _close(lse, jlse, "lse")
    if dtype == "float32":
        _close(o, jo, "o")
    else:
        _close_bf16(o, jo, "o")


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_fwd_stats_lse_matches_pallas_interpret(rng, direction):
    """lse of the Pallas forward kernels in interpret mode (block_n 16,
    n = 60 padded to 64) against the plain version's."""
    q, k, v, _ = _inputs(rng, direction, 1)
    fwd = (_grid_to_latent_fwd if direction == "grid_to_latent"
           else _latent_to_grid_fwd)
    jo, jlse = fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   block_n=16, interpret=True)
    o, lse = attention_fwd_stats_plain(_t(q), _t(k), _t(v))
    _close(o, jo, "o")
    _close(lse, jlse, "lse")


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_bwd_plain_matches_ref_bwd(rng, direction):
    q, k, v, do = _inputs(rng, direction, 1)
    _, lse = _ref_fwd_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    refs = _ref_bwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), lse,
                    jnp.asarray(do))
    got = attention_bwd_plain(_t(q), _t(k), _t(v), _t(lse), _t(do))
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        _close(g, r, name)


def _port_plain_grads(q, k, v, do, direction, heads, dtype):
    """The port's plain forward and backward of one multi-head call, on
    head-folded inputs, unfolded: (o, dq, dk, dv)."""
    n = q.shape[0]
    tq, tk, tv, tdo = (_fold(_t(a, dtype=dtype), heads)
                       for a in (q, k, v, do))
    o, lse = attention_fwd_stats_plain(tq, tk, tv)
    if direction == "grid_to_latent":
        grads = attention_bwd_plain(tq, tk, tv, lse, tdo)
    else:
        grads = attention_bwd_with_o_plain(tq, tk, tv, o, lse, tdo)
    return [_unfold(t, n, heads) for t in (o,) + tuple(grads)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_bwd_plain_matches_pallas_vjp(rng, direction, heads, dtype):
    """dq, dk, dv of the plain versions (grid->latent: delta inside the
    row; latent->grid: delta = rowsum(do * o)) against ``jax.vjp`` of
    ``multihead_attention_pallas`` in interpret mode, whose backward is
    the Pallas backward kernel the port's kernels replace."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    q, k, v, do = _inputs(rng, direction, heads)
    got = _port_plain_grads(q, k, v, do, direction, heads, tdt)
    ref, vjp = jax.vjp(
        lambda a, b, c: multihead_attention_pallas(
            a, b, c, heads, block_n=16, interpret=True),
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    refs = (ref,) + vjp(jnp.asarray(do).astype(jdt))
    for name, g, r in zip(("o", "dq", "dk", "dv"), got, refs):
        assert g.dtype == tdt, name
        if dtype == "float32":
            _close(g, r, name)
        else:
            _close_bf16(g, r, name)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_bwd_plain_is_autograd_of_plain_forward(rng, direction):
    q, k, v, do = _inputs(rng, direction, 1)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    grads = torch.autograd.grad(attention_plain(tq, tk, tv), [tq, tk, tv],
                                _t(do))
    _, lse = attention_fwd_stats_plain(_t(q), _t(k), _t(v))
    got = attention_bwd_plain(_t(q), _t(k), _t(v), lse, _t(do))
    for name, g, r in zip(("dq", "dk", "dv"), got, grads):
        _close(g, r, name)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_delta_from_o_equals_rowsum_dp_p(rng, direction):
    """The FlashAttention identity rowsum(dP * P) = rowsum(do * o) that
    the latent->grid backward kernel relies on: the delta-from-o form
    gives the row-delta form's gradients."""
    q, k, v, do = (_t(a) for a in _inputs(rng, direction, 1))
    o, lse = attention_fwd_stats_plain(q, k, v)
    p = torch.exp(torch.einsum("bnd,bld->bnl", q, k) / np.sqrt(q.shape[-1])
                  - lse[..., None])
    dp = torch.einsum("bnd,bld->bnl", do, v)
    _close(attention_delta(o, do), (dp * p).sum(-1), "delta")
    for name, g, r in zip(("dq", "dk", "dv"),
                          attention_bwd_with_o_plain(q, k, v, o, lse, do),
                          attention_bwd_plain(q, k, v, lse, do)):
        _close(g, r, name)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cards_route_builds_the_functions_and_matches_jax(
        rng, card_route, direction, heads):
    """On the card's route (launches stubbed by the plain versions)
    ``fused_multihead_attention`` goes through the direction's Function:
    its grad_fn is the Function's backward, one forward launch writes
    lse, the backward launches once, and the gradients match
    ``jax.vjp`` of the Pallas op."""
    q, k, v, do = _inputs(rng, direction, heads)
    ins = [_t(a, True) for a in (q, k, v)]
    o = ops.fused_multihead_attention(*ins, num_heads=heads)
    node = ("GridToLatentFunctionBackward" if direction == "grid_to_latent"
            else "LatentToGridFunctionBackward")
    fn, names = o.grad_fn, set()
    while fn is not None and type(fn).__name__ != node:
        names.add(type(fn).__name__)
        fn = fn.next_functions[0][0] if fn.next_functions else None
    assert fn is not None, names
    grads = torch.autograd.grad(o, ins, _t(do))
    counts, lse = ops.launch_counts(), ops.lse_launch_counts()
    other = ("latent_to_grid" if direction == "grid_to_latent"
             else "grid_to_latent")
    assert counts[direction] == counts[direction + "_bwd"] == 1
    assert counts[other] == counts[other + "_bwd"] == 0
    assert lse == {direction: 1, other: 0}
    ref, vjp = jax.vjp(
        lambda a, b, c: multihead_attention_pallas(
            a, b, c, heads, block_n=16, interpret=True),
        *(jnp.asarray(a) for a in (q, k, v)))
    _close(o.detach(), ref, "o")
    for name, g, r in zip(("dq", "dk", "dv"), grads,
                          vjp(jnp.asarray(do))):
        _close(g, r, name)


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cards_route_no_grad_launches_without_lse(rng, card_route,
                                                  direction):
    q, k, v, _ = _inputs(rng, direction, 1)
    ins = [_t(a, True) for a in (q, k, v)]
    with torch.no_grad():
        o = ops.fused_multihead_attention(*ins)
    assert o.grad_fn is None
    assert ops.launch_counts()[direction] == 1
    assert ops.lse_launch_counts()[direction] == 0
    _close(o, attention_plain(*(_t(a) for a in (q, k, v))), "o")


def _r1(attend, q, k, v, w):
    """R1's shape on one attention: the input q's gradient of a loss
    nonlinear in the output (so the cotangent depends on the
    parameters), squared and summed; the parameters ``w`` scale q, k and
    v."""
    o = attend(q * w[0], k * w[1], v * w[2])
    (gq,) = torch.autograd.grad((o * torch.cos(o)).sum(), [q],
                                create_graph=True)
    return gq.square().sum()


@pytest.mark.parametrize("direction", DIRECTIONS)
def test_cards_route_r1_double_backward_matches_pallas(rng, card_route,
                                                       direction):
    """The attention Functions differentiate twice on the card's route
    (opaque launch stubs): R1's shape (``tests/test_pallas_grad.py``
    ``test_r1_shaped_double_backward``, with k and v scaled and a
    nonlinear loss) against ``jax.grad`` of ``jax.grad`` through
    ``multihead_attention_pallas`` in interpret mode, wrt the three
    scales and the input.  One forward launch with lse, two backward
    launches (the image gradient's and the forward graph's in the final
    backward) and one torch-op second-order pass."""
    q, k, v, _ = _inputs(rng, direction, 1)
    w = np.array([1.1, 0.9, 1.2], np.float32)

    def r1_jax(wj, qj):
        def loss(qq):
            o = multihead_attention_pallas(qq * wj[0], jnp.asarray(k) * wj[1],
                                           jnp.asarray(v) * wj[2], 1,
                                           block_n=16, interpret=True)
            return jnp.sum(o * jnp.cos(o))
        return jnp.sum(jax.grad(loss)(qj) ** 2)

    refs = jax.grad(r1_jax, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(q))
    tq, tw = _t(q, True), _t(w, True)
    r1 = _r1(ops.fused_multihead_attention, tq, _t(k), _t(v), tw)
    got = torch.autograd.grad(r1, [tw, tq])
    for name, g, r in zip(("w", "q"), got, refs):
        _close(g, r, name)
    other = ("latent_to_grid" if direction == "grid_to_latent"
             else "grid_to_latent")
    counts = ops.launch_counts()
    assert (counts[direction], counts[direction + "_bwd"]) == (1, 2)
    assert counts[other] == counts[other + "_bwd"] == 0
    assert ops.second_order_counts() == {
        "modconv_second_order": 0, "upfirdn_second_order": 0,
        f"{direction}_second_order": 1, f"{other}_second_order": 0}
