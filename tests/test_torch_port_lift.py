"""The fused stereo lift (`flosp_stereo_lift`, kernel K1 fused with the FLoSP
gather and the sum over scales) and K2 batched over relations, on the CPU:
plain versions and CPU wrappers vs the JAX package's `sfa_lift` (its K1
through the jnp formula and through the Pallas kernel in interpret mode),
CPMegaVoxels vs the flax module, the split-bf16 sigmoid, and the two
registered operators' gradients: the lift's closed-form backward
(`flosp_stereo_lift_backward_reference`, the kernel's oracle) vs `jax.vjp`
of JAX `sfa_lift` and vs autograd of the plain lift, and K2's formula.

Inputs come from numpy with a seed at tiny sizes (256 voxels, C = 8 or 16,
four scales); tolerances are stated where they are used.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import occdepth_tpu.ops.pallas_kernels as jax_kernels
from occdepth_tpu.models.crp3d import CPMegaVoxels as JaxCPMegaVoxels
from occdepth_tpu.models.sfa import sfa_lift as jax_sfa_lift
from occdepth_tpu.training.convert_torch import _map_crp, _Mapper, _nest
from occdepth_tpu_torch.models import sfa as port_sfa
from occdepth_tpu_torch.models.crp3d import CPMegaVoxels
from occdepth_tpu_torch.ops import flosp_gather
from occdepth_tpu_torch.ops.crp_matmul import (
    crp_relation_matmul,
    crp_relation_matmul_reference,
    split_bf16,
)
from occdepth_tpu_torch.ops.flosp_gather import (
    channels_last_map,
    flosp_stereo_lift,
    flosp_stereo_lift_backward,
    flosp_stereo_lift_backward_reference,
    flosp_stereo_lift_reference,
)
from occdepth_tpu_torch.testing import lift_inputs, randomize_weights

SCALES = (1, 2, 4, 8)
SCENE = (8, 8, 4)  # N = 256 voxels
HW = (21, 37)  # project-scale image: odd sizes, so ceil(H / s) maps
LIFT_ATOL = 1e-5  # fp32 sums of C terms and of 4 scales in another order


def _inputs(P, C=16, B=2, seed=0):
    return lift_inputs(np.random.RandomState(seed + P), B, int(np.prod(SCENE)),
                       P, C, HW, SCALES)


@functools.lru_cache(maxsize=None)
def _jax_lift(P, dtype, path):
    """JAX `sfa_lift` on the inputs of `_inputs(P)` (maps rounded to bf16
    first for dtype "bf16"), K1 through jnp or the Pallas kernel run in
    interpret mode; (B, N, C) numpy."""
    maps, pix, fov = _inputs(P)
    jmaps = {f"1_{s}": jnp.asarray(m) for s, m in maps.items()}
    if dtype == "bf16":
        jmaps = {k: v.astype(jnp.bfloat16) for k, v in jmaps.items()}
    use_pallas = path == "pallas"
    if use_pallas:
        # the kernel tiles N by block_n (2048 by default): 64 divides 256
        mp = pytest.MonkeyPatch()
        mp.setattr(jax_kernels, "stereo_cosine_fuse", functools.partial(
            jax_kernels.stereo_cosine_fuse, block_n=64, interpret=True))
    lift = jax.jit(jax_sfa_lift, static_argnums=(3, 4, 5, 6))
    try:
        out = lift(jmaps, jnp.asarray(pix), jnp.asarray(fov), SCALES, SCENE,
                   "kitti", use_pallas)
    finally:
        if use_pallas:
            mp.undo()
    out = np.asarray(out, dtype=np.float32)
    return out.reshape(out.shape[0], -1, out.shape[-1])


def _torch_maps(maps, dtype, layout):
    """numpy NHWC maps -> torch (B, 2, C, h, w) in `layout`."""
    out = []
    for s in SCALES:
        t = torch.from_numpy(maps[s]).to(dtype).permute(0, 1, 4, 2, 3)
        out.append(t.contiguous() if layout == "nchw" else t)
    return out


@pytest.mark.parametrize("path", ["jnp", "pallas"])
@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("P", [1, 4])
def test_flosp_stereo_lift_matches_jax_sfa_lift(P, dtype, layout, path):
    """The plain version, the wrapper on CPU tensors and the port's
    `sfa_lift` vs JAX `sfa_lift`: bf16 maps are gathered in bf16 and
    widened exactly on both sides, so every case holds to LIFT_ATOL.  The
    inputs put points on each map's last row and column, out of FOV
    (negative coordinates too) and voxels seen by one view only."""
    maps, pix, fov = _inputs(P)
    tdtype = torch.float32 if dtype == "fp32" else torch.bfloat16
    tmaps = _torch_maps(maps, tdtype, layout)
    assert all((m.stride(2) == 1) == (layout == "channels_last")
               for m in tmaps)
    tpix, tfov = torch.from_numpy(pix), torch.from_numpy(fov)
    ref = _jax_lift(P, dtype, path)
    plain = flosp_stereo_lift_reference(tmaps, tpix, tfov, SCALES)
    wrapped = flosp_stereo_lift(tmaps, tpix, tfov, SCALES)
    lifted = port_sfa.sfa_lift({f"1_{s}": m for s, m in zip(SCALES, tmaps)},
                               tpix, tfov, SCALES, SCENE, "kitti")
    assert plain.shape == ref.shape and plain.dtype == torch.float32
    assert lifted.shape == (2, *SCENE, 16)
    for out in (plain, wrapped, lifted.reshape(ref.shape)):
        np.testing.assert_allclose(out.numpy(), ref, atol=LIFT_ATOL, rtol=0)


def test_lift_inputs_cover_the_edges():
    """The shared inputs hold every case the fused kernel must get right."""
    maps, pix, fov = _inputs(4)
    H, W = HW
    assert (fov & (pix[..., 0] == W - 1)).any()
    assert (fov & (pix[..., 1] == H - 1)).any()
    assert (~fov & (pix[..., 0] < 0)).any()
    seen = fov.any(-1)
    assert (seen[:, 0] & ~seen[:, 1]).any() and (seen[:, 1] & ~seen[:, 0]).any()
    assert (seen[:, 0] & seen[:, 1]).any() and (~seen[:, 0] & ~seen[:, 1]).any()
    # a map's last row and column are reached at every scale
    for s in SCALES:
        h, w = maps[s].shape[2:4]
        assert ((pix[..., 0] // s == w - 1) & fov).any()
        assert ((pix[..., 1] // s == h - 1) & fov).any()


def test_sfa_lift_routes_two_views_through_the_fused_lift(monkeypatch):
    """Two views take `flosp_stereo_lift` once per call; one view takes the
    per-scale gather; on CPU tensors nothing launches."""
    calls = []
    monkeypatch.setattr(port_sfa, "flosp_stereo_lift",
                        lambda *a, **k: calls.append(1) or
                        flosp_stereo_lift(*a, **k))
    maps, pix, fov = _inputs(1)
    tmaps = {f"1_{s}": m for s, m in zip(SCALES, _torch_maps(
        maps, torch.float32, "nchw"))}
    tpix, tfov = torch.from_numpy(pix), torch.from_numpy(fov)
    before = flosp_stereo_lift.launches
    port_sfa.sfa_lift(tmaps, tpix, tfov, SCALES, SCENE, "kitti")
    assert calls == [1] and flosp_stereo_lift.launches == before
    one = port_sfa.sfa_lift({k: v[:, :1] for k, v in tmaps.items()},
                            tpix[:, :1], tfov[:, :1], SCALES, SCENE, "kitti")
    assert calls == [1] and one.shape == (2, *SCENE, 16)
    with pytest.raises(ValueError):
        flosp_stereo_lift(list(tmaps.values())[:3], tpix, tfov, SCALES)


def test_channels_last_map_copies_only_nchw():
    x = torch.randn(2, 2, 8, 5, 7)
    cl = channels_last_map(x)
    assert cl.stride(2) == 1 and torch.equal(cl, x)
    assert channels_last_map(cl).data_ptr() == cl.data_ptr()


def test_lift_backward_is_autograd_of_the_plain_version():
    """The registered operator's gradient (the backward operator, whose CPU
    implementation is the closed form `flosp_stereo_lift_backward_reference`)
    vs autograd straight through the plain version, on CPU tensors, where
    the operator's forward is the plain version: the same fp32 derivative,
    summed per row in the same order, so exact up to 1e-6."""
    maps, pix, fov = _inputs(4, C=8)
    tpix, tfov = torch.from_numpy(pix), torch.from_numpy(fov)
    cot = torch.from_numpy(np.random.RandomState(9).randn(
        2, int(np.prod(SCENE)), 8).astype(np.float32))
    grads = []
    for fn in (lambda m: flosp_stereo_lift(m, tpix, tfov, SCALES),
               lambda m: flosp_stereo_lift_reference(m, tpix, tfov, SCALES)):
        leaves = [m.clone().requires_grad_(i != 1) for i, m in
                  enumerate(_torch_maps(maps, torch.float32, "nchw"))]
        fn(leaves).backward(cot)
        grads.append([m.grad for m in leaves])
    assert grads[0][1] is None and grads[1][1] is None
    for a, b in zip(*grads):
        if b is not None:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


CLAMP_VOXELS = slice(40, 44)  # view 0's points all on one pixel's row ...
CLAMP_XY = (5, 7)  # ... at scale 1, whose norm is under eps (or 0)
OFF_MAP_VOXELS = slice(50, 53)  # view 1's point 0 in FOV but off every map


def _bwd_inputs(P, clamp_scale, off_map):
    """`_inputs(P)` (out-of-FOV points, negative coordinates, one-view
    voxels, points on each map's last row and column) plus the backward's
    edge cases: voxels whose view-0 mean lies on the eps clamp (the scale-1
    row at CLAMP_XY scaled by `clamp_scale`: 1e-10 leaves |f| < eps, 0 an
    exact zero row) and, with `off_map`, in-FOV points whose flat index
    falls past every scale's map (JAX reads NaN there and drops their
    updates; the port does both too).  Plus the output's cotangent."""
    maps, pix, fov = _inputs(P)
    maps = {s: m.copy() for s, m in maps.items()}
    pix, fov = pix.copy(), fov.copy()
    x0, y0 = CLAMP_XY
    pix[:, 0, CLAMP_VOXELS] = (x0, y0)
    fov[:, 0, CLAMP_VOXELS] = True
    maps[1][:, 0, y0, x0] *= clamp_scale
    if off_map:
        H, W = HW
        pix[:, 1, OFF_MAP_VOXELS, 0] = (W + 76, H - 1)
        fov[:, 1, OFF_MAP_VOXELS, 0] = True
        for s in SCALES:  # past the map, not its sentinel row nor wrapped
            h, w = maps[s].shape[2:4]
            assert (H - 1) // s * w + (W + 76) // s > h * w
    cot = np.random.RandomState(20 + P).randn(
        2, int(np.prod(SCENE)), 16).astype(np.float32)
    return maps, pix, fov, cot


@jax.jit
def _jax_lift_grads(maps, pix, fov, cot):
    """`jax.vjp` of JAX `sfa_lift` (K1 through jnp): each map's gradient
    for the output cotangent cot (B, N, C); one trace per P."""
    _, vjp = jax.vjp(lambda m: jax_sfa_lift(
        m, pix, fov, SCALES, SCENE, "kitti", False), maps)
    return vjp(cot.reshape(cot.shape[0], *SCENE, cot.shape[-1]))[0]


@functools.lru_cache(maxsize=None)
def _jax_lift_vjp(P, dtype):
    """`_jax_lift_grads` on `_bwd_inputs(P, 1e-10, True)`, NHWC numpy; for
    dtype "bf16" the maps are rounded to bf16 first and differentiated in
    fp32."""
    maps, pix, fov, cot = _bwd_inputs(P, 1e-10, True)
    jmaps = {f"1_{s}": jnp.asarray(m) for s, m in maps.items()}
    if dtype == "bf16":
        jmaps = {k: v.astype(jnp.bfloat16).astype(jnp.float32)
                 for k, v in jmaps.items()}
    out = _jax_lift_grads(jmaps, jnp.asarray(pix), jnp.asarray(fov),
                          jnp.asarray(cot))
    return {s: np.asarray(out[f"1_{s}"]) for s in SCALES}


def _assert_rows_close(ours, ref, rtol, row_rtol):
    """NaN in the same places; elsewhere |ours - ref| <= rtol |ref| +
    row_rtol max(1, max|ref| of the map row): rows on the eps clamp carry
    gradients ~1e8 (k = eps in the denominator), the others O(1)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    row = np.maximum(1.0, np.nanmax(np.abs(ref), axis=-1, keepdims=True))
    ok = np.isnan(ref) | (np.abs(ours - ref) <= rtol * np.abs(ref)
                          + row_rtol * row)
    assert ok.all(), (np.argwhere(~ok)[:5], ours[~ok][:5], ref[~ok][:5])


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("P", [1, 4])
def test_lift_backward_matches_jax_vjp(P, dtype, layout):
    """The plain backward `flosp_stereo_lift_backward_reference` (the CPU
    implementation of the backward operator and the kernel's oracle) vs
    `jax.vjp` of JAX `sfa_lift` with K1 through jnp, edge cases included
    (`_bwd_inputs`).  fp32: the same closed form, summed per row in another
    order, within 1e-5 of the row's scale.  bf16: JAX's VJP of bf16 maps
    rounds each point's term to bf16 and scatter-adds in bf16, while the
    port sums in fp32 and rounds once; so the port is held to JAX's VJP of
    the same bf16 values taken in fp32, within one bf16 rounding (2^-8 of
    each value) on top of the fp32 bound.  The gradient has each map's
    shape and dtype, channels-last whatever the map's layout."""
    maps, pix, fov, cot = _bwd_inputs(P, 1e-10, True)
    tdtype = torch.float32 if dtype == "fp32" else torch.bfloat16
    tmaps = _torch_maps(maps, tdtype, layout)
    grads = flosp_stereo_lift_backward_reference(
        tmaps, torch.from_numpy(pix), torch.from_numpy(fov), SCALES, 1e-8,
        torch.from_numpy(cot))
    ref = _jax_lift_vjp(P, dtype)
    for s, g, m in zip(SCALES, grads, tmaps):
        assert g.shape == m.shape and g.dtype == m.dtype
        assert g.permute(0, 1, 3, 4, 2).is_contiguous()
        _assert_rows_close(g.float().permute(0, 1, 3, 4, 2).numpy(), ref[s],
                           0.0 if dtype == "fp32" else 2.0 ** -8, 1e-5)
    # the edge cases are there: NaN rows, and clamp rows ~1e8
    assert np.isnan(ref[1]).any() and np.nanmax(np.abs(ref[1])) > 1e6


@pytest.mark.parametrize("P", [1, 4])
def test_lift_backward_reference_is_autograd_of_the_plain_lift(P):
    """The closed form vs autograd of `flosp_stereo_lift_reference`, the
    second oracle, with an exact zero row under the clamp voxels (autograd
    of the norm takes 0 there, as the closed form's [|f| > eps] does):
    the same fp32 derivative summed in the same order, within 1e-6 of the
    row's scale.  (No off-map points: the plain forward's index_select
    does not read NaN there.)"""
    maps, pix, fov, cot = _bwd_inputs(P, 0.0, False)
    tpix, tfov = torch.from_numpy(pix), torch.from_numpy(fov)
    leaves = [m.clone().requires_grad_()
              for m in _torch_maps(maps, torch.float32, "nchw")]
    flosp_stereo_lift_reference(leaves, tpix, tfov, SCALES).backward(
        torch.from_numpy(cot))
    grads = flosp_stereo_lift_backward_reference(
        [m.detach() for m in leaves], tpix, tfov, SCALES, 1e-8,
        torch.from_numpy(cot))
    for g, leaf in zip(grads, leaves):
        _assert_rows_close(g.permute(0, 1, 3, 4, 2).numpy(),
                           leaf.grad.permute(0, 1, 3, 4, 2).numpy(), 0.0,
                           1e-6)
    assert leaves[0].grad.abs().max() > 1e6  # the clamp rows


def test_lift_cpu_gradient_goes_through_the_backward_operator(monkeypatch):
    """On CPU tensors the lift's registered gradient is the backward
    operator `occdepth::flosp_stereo_lift_backward` (its CPU implementation
    the plain backward, once per backward pass), nothing launches, and the
    operator called alone gives the same gradients.  (`opcheck` of the
    operator runs on the card, `tests/test_torch_port_kernels.py`; the
    forward's, in `tests/test_torch_port_outputs.py`, traces this gradient
    through its fake implementation.)"""
    calls = []
    plain = flosp_gather.flosp_stereo_lift_backward_reference
    monkeypatch.setattr(flosp_gather, "flosp_stereo_lift_backward_reference",
                        lambda *a: calls.append(1) or plain(*a))
    maps, pix, fov, cot = _bwd_inputs(1, 1.0, False)
    tpix, tfov = torch.from_numpy(pix), torch.from_numpy(fov)
    leaves = [m.requires_grad_() for m in _torch_maps(
        maps, torch.float32, "channels_last")]
    launches = flosp_stereo_lift_backward.launches
    flosp_stereo_lift(leaves, tpix, tfov, SCALES).backward(
        torch.from_numpy(cot))
    assert calls == [1] and flosp_stereo_lift_backward.launches == launches
    direct = flosp_stereo_lift_backward(
        [m.detach() for m in leaves], tpix, tfov, SCALES,
        torch.from_numpy(cot))
    for g, leaf in zip(direct, leaves):
        assert torch.equal(g, leaf.grad) and g.stride() == leaf.grad.stride()


def test_split_bf16_reproduces_fp32():
    """hi + lo = s within 2^-16 relative (each rounding halves the bf16
    ulp: 2^-18 in fact), and the two-term product the wgmma kernel forms
    stays within K2's tolerance (2e-5 max|ref|) of the fp32 product."""
    rng = np.random.RandomState(11)
    s = torch.sigmoid(torch.from_numpy(
        (4 * rng.randn(4096)).astype(np.float32)))
    hi, lo = split_bf16(s)
    assert hi.dtype == lo.dtype == torch.bfloat16
    err = ((hi.double() + lo.double()) - s.double()).abs()
    assert (err <= 2.0 ** -16 * s.double().abs()).all()
    p = torch.from_numpy(rng.randn(64, 512).astype(np.float32))
    mega = torch.from_numpy(rng.randn(512, 96).astype(np.float32)
                            ).bfloat16().float()
    hi, lo = split_bf16(torch.sigmoid(p))
    two = hi.double() @ mega.double() + lo.double() @ mega.double()
    ref = torch.sigmoid(p).double() @ mega.double()
    assert (two - ref).abs().max() <= 2e-5 * ref.abs().max()


@functools.lru_cache(maxsize=None)
def _crp_case():
    """(B, R, N, M) logits, (B, M, C) mega and the JAX Pallas kernel's
    product per (batch item, relation), interpret mode."""
    from occdepth_tpu.ops.pallas_kernels import crp_relation_matmul as jax_crp

    rng = np.random.RandomState(14)
    B, R, N, M, C = 2, 2, 256, 128, 16
    p = rng.randn(B, R, N, M).astype(np.float32)
    mega = rng.randn(B, M, C).astype(np.float32)
    ref = np.stack([np.stack([np.asarray(jax_crp(
        jnp.asarray(p[b, r]), jnp.asarray(mega[b]), block_n=128,
        interpret=True)) for r in range(R)]) for b in range(B)])
    return p, mega, ref


@pytest.mark.parametrize("dim", [2, 3, 4])
def test_crp_relation_matmul_forms_match_jax_per_relation(dim):
    """The 2-, 3- and 4-D forms of K2's plain version (and the CPU wrapper)
    vs the JAX Pallas kernel in interpret mode per (batch item, relation),
    mega shared by the relations: fp32 sums of 128 terms, 1e-4 absolute."""
    p, mega, ref = _crp_case()
    tp, tm = torch.from_numpy(p), torch.from_numpy(mega)
    args, want = {4: ((tp, tm), ref), 3: ((tp[:, 1], tm), ref[:, 1]),
                  2: ((tp[1, 0], tm[1]), ref[1, 0])}[dim]
    for fn in (crp_relation_matmul_reference, crp_relation_matmul):
        out = fn(*args)
        assert out.shape == want.shape
        np.testing.assert_allclose(out.numpy(), want, atol=1e-4)


def test_crp_backward_batched_over_relations():
    """The registered operator's gradient formula, batched over relations
    (dmega summed over them), vs autograd of the plain version, on CPU
    tensors, where the operator's forward is the plain version: fp32
    products of 256 and 1024 terms in another order, 1e-5 x max|ref|."""
    rng = np.random.RandomState(12)
    p0 = torch.from_numpy(rng.randn(2, 3, 1024, 256).astype(np.float32))
    m0 = torch.from_numpy(rng.randn(2, 256, 16).astype(np.float32))
    cot = torch.from_numpy(rng.randn(2, 3, 1024, 16).astype(np.float32))
    grads = []
    for fn in (crp_relation_matmul, crp_relation_matmul_reference):
        p, m = p0.clone().requires_grad_(), m0.clone().requires_grad_()
        fn(p, m).backward(cot)
        grads.append((p.grad, m.grad))
    for a, b in zip(*grads):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


def _flax_variables(mod, map_fn, *args):
    """Carry a port module's weights into flax through the converter."""
    sd = {f"m.{k}": v.numpy() for k, v in mod.state_dict().items()}
    m = _Mapper(sd)
    map_fn(m, "m", "m", *args)
    assert not m.missing, m.missing[:5]
    return {"params": _nest(m.params)["m"], "batch_stats": _nest(m.stats)["m"]}


def test_cp_mega_voxels_relations_batched_matches_jax():
    """CPMegaVoxels with the relations in one K2 call (one stack of logits,
    one product) vs the flax module, weights carried by the converter; an
    odd-sized grid and two relations (the module test runs four): fp32,
    1e-4 absolute as the module test."""
    feature, size, B, n_relations = 8, (6, 4, 8), 1, 2
    mod = randomize_weights(CPMegaVoxels(feature, size, n_relations=n_relations,
                                         bn_momentum=0.1), seed=5).eval()
    variables = _flax_variables(mod, _map_crp, n_relations)
    x = np.random.RandomState(13).randn(B, feature, *size).astype(np.float32)
    with torch.no_grad():
        ours = mod(torch.from_numpy(x))
    jax_mod = JaxCPMegaVoxels(feature, size, n_relations=n_relations,
                              bn_momentum=0.1)
    ref = jax.jit(jax_mod.apply, static_argnums=2)(
        variables, jnp.asarray(x.transpose(0, 2, 3, 4, 1)), False)
    assert ours["P_logits"].shape == (B, n_relations, 3 * 2 * 4, 6 * 4 * 8)
    np.testing.assert_allclose(ours["x"].numpy().transpose(0, 2, 3, 4, 1),
                               np.asarray(ref["x"]), atol=1e-4)
    np.testing.assert_allclose(ours["P_logits"].numpy(),
                               np.asarray(ref["P_logits"]), atol=1e-4)
