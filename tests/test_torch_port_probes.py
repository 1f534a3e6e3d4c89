"""The port's kernel probes: K6 (row gather) and K5 (resident-operand
matmul) plain versions, the one-hot gather and the dilated conv3d chain
held to the JAX probe scripts on the CPU, the wrappers' CPU routing and
errors, and the probe scripts' constants and CPU refusal.

The JAX Pallas kernels run in interpret mode: the tests patch
`jax.experimental.pallas.pallas_call` with `interpret=True`; the JAX
package itself is unchanged.  The kernels' CUDA cases are in
`tests/test_torch_port_kernels.py` (`cuda` marker).
"""
import ast
import functools
import inspect
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from occdepth_tpu_torch.ops.matmul_probe import (
    matmul_probe,
    matmul_probe_reference,
)
from occdepth_tpu_torch.ops.row_gather import row_gather, row_gather_reference
from occdepth_tpu_torch.scripts import (
    bench_conv2d,
    bench_dwconv,
    bench_gather,
    bench_head_pallas,
)

T_IDX = 8192  # indices per gather: two of the TPU kernel's 4096-index tiles
JDTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The tier-1 gate runs six test processes on a few cores; this file's
    tiny-shape torch work takes one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _to_np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.array(jnp.asarray(a, jnp.float32))


def _gather_inputs(rows, cols, dtype, low=0, seed=0):
    """Table and T_IDX indices, in [0, rows) or, with `low`, [-low, low)."""
    rs = np.random.RandomState(seed)
    table = rs.randn(rows, cols).astype(np.float32)
    idx = rs.randint(-low, low, T_IDX) if low else rs.randint(0, rows, T_IDX)
    return (torch.from_numpy(table).to(dtype),
            torch.from_numpy(idx.astype(np.int32)),
            jnp.asarray(table, JDTYPES[dtype]), jnp.asarray(idx, jnp.int32))


@pytest.mark.parametrize("shape,dtype", [((300, 32), torch.float32),
                                         ((300, 32), torch.bfloat16),
                                         ((97, 104), torch.bfloat16)])
def test_row_gather_plain_matches_jax_probe(interpret, dtype, shape):
    """K6's plain version equals the JAX Pallas gather (interpret mode) and
    `xla_take` exactly: a gather moves values, it computes nothing.  The
    (97, 104) table is the OAD row shape in the probe's default bf16."""
    from occdepth_tpu.scripts import bench_gather as jax_bench

    table, idx, jtable, jidx = _gather_inputs(*shape, dtype)
    out = row_gather(table, idx)
    assert out.dtype == dtype and out.shape == (T_IDX, shape[1])
    np.testing.assert_array_equal(
        _to_np(out), _to_np(jax_bench.pallas_gather(jtable, jidx)))
    np.testing.assert_array_equal(
        _to_np(out), _to_np(jax_bench.xla_take(jtable, jidx)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_out_of_range_follows_jnp_take(dtype):
    """Indices in [-R, 0) count from the end and indices outside [-R, R)
    give NaN rows, as `jnp.take` (the JAX script's `xla_take`) does."""
    from occdepth_tpu.scripts import bench_gather as jax_bench

    R = 50
    table, idx, jtable, jidx = _gather_inputs(R, 33, dtype, low=3 * R)
    out = row_gather(table, idx)
    assert out.isnan().any() and not out.isnan().all()
    np.testing.assert_array_equal(
        _to_np(out), _to_np(jax_bench.xla_take(jtable, jidx)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_tiled_matches_jax(dtype):
    from occdepth_tpu.scripts import bench_gather as jax_bench

    table, idx, jtable, jidx = _gather_inputs(300, 32, dtype, seed=1)
    idx, jidx = idx.repeat(2), jnp.tile(jidx, 2)  # two 8192-index tiles
    out = bench_gather.xla_onehot_tiled(table, idx)
    assert out.dtype == dtype
    np.testing.assert_array_equal(
        _to_np(out), _to_np(jax_bench.xla_onehot_tiled(jtable, jidx)))


def test_make_variants_match_jax():
    from occdepth_tpu.scripts import bench_gather as jax_bench

    ours = bench_gather.make_variants(40, 8, torch.bfloat16, device="cpu")
    ref = jax_bench.make_variants(40, 8, jnp.bfloat16)
    assert len(ours) == len(ref) == 4
    for (t, i), (jt, ji) in zip(ours, ref):
        np.testing.assert_array_equal(_to_np(t), _to_np(jt))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        assert i.dtype == torch.int32 and i.shape == (bench_gather.N,)


@pytest.mark.parametrize("shape", [(32, 144, 48, 2), (16, 512, 64, 2)])
def test_matmul_probe_plain_matches_jax_probe(interpret, shape):
    """K5's plain version on the JAX probe's own p and w against the Pallas
    kernel in interpret mode, at dzpack's k and n and a lanefold-like long
    k: one bf16 rounding of fp32 sums taken in another order apart,
    2^-7 * max|ref|."""
    from occdepth_tpu.scripts import bench_head_pallas as jax_head

    m, k, n, steps = shape
    fn, jp, jw = jax_head.pallas_matmul_probe(m, k, n, steps)
    ref = _to_np(fn(jp, jw))
    p = torch.from_numpy(_to_np(jp)).bfloat16()
    w = torch.from_numpy(_to_np(jw)).bfloat16()
    out = matmul_probe(p, w, steps)
    assert out.dtype == torch.bfloat16 and out.shape == (steps, m, n)
    assert np.abs(_to_np(out) - ref).max() <= 2 ** -7 * np.abs(ref).max()


@pytest.mark.parametrize("d", [1, 2, 3])
def test_conv3d_chain_matches_jax_decomposed(d):
    """bench_head_pallas's stock side, `F.conv3d` with dilation d chained,
    against the JAX script's `conv3d_decomposed` chain (fp32, NDHWC there,
    NCDHW here): sums in another order, 1e-4 * max|ref|."""
    from occdepth_tpu.ops.conv3d_fast import conv3d_decomposed

    rs = np.random.RandomState(d)
    Cc, chain = 4, 2
    x = rs.randn(1, 7, 6, 5, Cc).astype(np.float32)
    kern = (rs.randn(3, 3, 3, Cc, Cc) / np.sqrt(27 * Cc)).astype(np.float32)
    ref = jnp.asarray(x)
    for _ in range(chain):
        ref = conv3d_decomposed(ref, jnp.asarray(kern), strides=(1, 1, 1),
                                padding=((d, d),) * 3, dilation=(d, d, d))
    ref = np.asarray(ref).transpose(0, 4, 1, 2, 3)
    out = bench_head_pallas.chained_conv3d(
        torch.from_numpy(x.transpose(0, 4, 1, 2, 3).copy()),
        torch.from_numpy(kern.transpose(4, 3, 0, 1, 2).copy()), d,
        chain=chain)
    assert out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_wrappers_take_plain_path_on_cpu():
    """On CPU tensors both wrappers run their plain versions and launch
    nothing."""
    rs = np.random.RandomState(2)
    table = torch.from_numpy(rs.randn(20, 8).astype(np.float32))
    idx = torch.from_numpy(rs.randint(-30, 30, 64).astype(np.int32))
    p = torch.from_numpy(rs.randn(1, 32, 16).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rs.randn(16, 48).astype(np.float32)).bfloat16()
    before = (row_gather.launches, matmul_probe.launches)
    gathered = row_gather(table, idx)
    prod = matmul_probe(p, w, 3)
    assert (row_gather.launches, matmul_probe.launches) == before
    np.testing.assert_array_equal(gathered.numpy(),
                                  row_gather_reference(table, idx).numpy())
    assert torch.equal(prod, matmul_probe_reference(p, w, 3))
    assert prod.is_contiguous() and torch.equal(prod[0], prod[2])


def test_wrappers_raise_on_unsupported_input():
    table = torch.zeros(10, 8)
    idx = torch.zeros(4, dtype=torch.int32)
    for bad, err in (((table, idx.long()), TypeError),
                     ((table.double(), idx), TypeError),
                     ((table[0], idx), ValueError),
                     ((table[:0], idx), ValueError)):
        with pytest.raises(err):
            row_gather(*bad)
    p = torch.zeros(1, 32, 16, dtype=torch.bfloat16)
    w = torch.zeros(16, 16, dtype=torch.bfloat16)
    for bad, err in (((p.float(), w, 2), TypeError),
                     ((p[:, :24], w, 2), ValueError),  # m % 16
                     ((p, w[:, :8], 2), ValueError),  # n % 16
                     ((p[0], w, 2), ValueError),
                     ((p, w[:8], 2), ValueError),  # k mismatch
                     ((p, w, 0), ValueError)):
        with pytest.raises(err):
            matmul_probe(*bad)


@pytest.mark.parametrize("script", [bench_gather, bench_head_pallas,
                                    bench_conv2d, bench_dwconv])
def test_probe_scripts_raise_without_cuda(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(["--repeats", "1"])


def _jax_probe_list(jax_head):
    """The `probes` list literal in the JAX script's `main`, evaluated with
    the script's constants."""
    tree = ast.parse(inspect.getsource(jax_head.main))
    node = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", None) == "probes")
    return eval(compile(ast.Expression(node.value), "probes", "eval"),
                vars(jax_head))


def test_probe_constants_match_jax_scripts():
    from occdepth_tpu.scripts import bench_conv2d as jax_conv
    from occdepth_tpu.scripts import bench_gather as jax_gather
    from occdepth_tpu.scripts import bench_head_pallas as jax_head

    assert bench_gather.N == jax_gather.N
    assert bench_gather.SHAPES == jax_gather.SHAPES
    for name in ("X", "Y", "Z", "C", "M_TOTAL", "USEFUL_FLOPS", "CHAIN"):
        assert getattr(bench_head_pallas, name) == getattr(jax_head, name)
    assert bench_head_pallas.PROBES == _jax_probe_list(jax_head)
    assert bench_conv2d.SHAPES == jax_conv.SHAPES
    # the JAX script's candidate names, in its order
    assert [c[0] for c in bench_conv2d.CANDIDATES] == [
        "xla", "shift", "pallas", "pal_x3"]
    assert [c[0] for c in bench_gather.candidates(30000)] == [
        "xla_take", "xla_onehot_tiled", "pallas_gather"]
    assert [c[0] for c in bench_gather.candidates(30001)] == [
        "xla_take", "pallas_gather"]


def test_pallas_matmul_probe_keeps_the_jax_signature():
    fn, p, w = bench_head_pallas.pallas_matmul_probe(32, 48, 16, 3,
                                                     device="cpu")
    assert p.shape == (1, 32, 48) and w.shape == (48, 16)
    assert p.dtype == w.dtype == torch.bfloat16
    assert fn(p, w).shape == (3, 32, 16)
    again = bench_head_pallas.pallas_matmul_probe(32, 48, 16, 3,
                                                  device="cpu")
    assert torch.equal(p, again[1]) and torch.equal(w, again[2])


def test_in_turns_cycles_variants():
    variants = [(torch.full((2, 3), float(i)),) for i in range(4)]
    seen = []
    call = bench_gather.in_turns(lambda t: seen.append(float(t[0, 0])),
                                 variants)
    for _ in range(6):
        call()
    assert seen == [0, 1, 2, 3, 0, 1]


def _encoder_dw_rows():
    """(name, H, W, C, k, stride) of every depthwise conv of the b3 encoder
    at 370x1220, read from the module tree (TF-SAME: each strided conv
    takes the size to its ceiling), consecutive equal rows merged with a
    count."""
    from occdepth_tpu_torch.models.efficientnet import EfficientNet

    enc = EfficientNet("tf_efficientnet_b3_ns")
    H, W = (-(-n // enc.conv_stem.stride[0]) for n in (370, 1220))
    rows, counts = [], []
    for si, stage in enumerate(enc.blocks):
        for bi, block in enumerate(stage):
            conv = block.conv_dw
            k, s = conv.kernel_size[0], conv.stride[0]
            row = (H, W, conv.in_channels, k, s)
            if rows and rows[-1][1:] == row:
                counts[-1] += 1
            else:
                rows.append((f"s{si}b{bi} k{k} s{s}", *row))
                counts.append(1)
            H, W = -(-H // s), -(-W // s)
    return rows, counts


def test_dwconv_shapes_match_encoder_and_jax():
    """bench_dwconv's list is the encoder's depthwise convs, and the JAX
    script's list but for its last row (1392 channels counted twice where
    the encoder's second stage-6 block has 2304)."""
    from occdepth_tpu.scripts import bench_dwconv as jax_dw

    rows, counts = _encoder_dw_rows()
    assert rows == bench_dwconv.B3_DW_SHAPES
    assert counts == bench_dwconv.B3_DW_COUNTS
    assert bench_dwconv.B3_DW_SHAPES[:-2] == jax_dw.B3_DW_SHAPES[:-1]
    assert bench_dwconv.B3_DW_COUNTS[:-2] == jax_dw.B3_DW_COUNTS[:-1]
    assert jax_dw.B3_DW_SHAPES[-1] == bench_dwconv.B3_DW_SHAPES[-2]
    assert jax_dw.B3_DW_COUNTS[-1] == 2
    assert bench_dwconv.B3_DW_SHAPES[-1] == ("s6b1 k3 s1", 12, 39, 2304, 3, 1)
    shapes = bench_dwconv.k4_shapes()
    assert len(shapes) == 10 and sum(n for *_, n in shapes) == 22


def test_bench_dwconv_rehearses_on_cpu(monkeypatch, capsys):
    """The script's control flow at two tiny rows with the device timing
    stubbed: every candidate printed, the totals weighted by the counts,
    the launch line, the JSON and `--check` (K4's CPU path is its plain
    version, so the error is 0)."""
    from occdepth_tpu_torch.scripts import bench_timing

    monkeypatch.setattr(bench_timing, "cuda_device",
                        lambda script: torch.device("cpu"))
    monkeypatch.setattr(bench_timing, "gpu_line", lambda: "stub, 700.00 W")
    monkeypatch.setattr(bench_timing, "device_ms",
                        lambda fn, calls=20, reps=5: (fn(), 0.5)[1])
    monkeypatch.setattr(bench_dwconv, "B3_DW_SHAPES", [
        ("a k3 s1", 5, 7, 3, 3, 1), ("b k5 s2", 6, 9, 2, 5, 2)])
    monkeypatch.setattr(bench_dwconv, "B3_DW_COUNTS", [2, 1])
    bench_dwconv.main(["--dtype", "float32", "--repeats", "1", "--json"])
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert lines[-2] == "stub, 700.00 W"
    assert res["totals_ms"] == {"fwd": 1.5, "dx": 1.5, "dw": 1.5,
                                "dw_pallas": 1.5}
    assert res["k4_totals_ms"]["dw_pallas"] == 1.0
    assert res["k4_totals_ms"]["plain"] == 1.0
    a = res["per_shape"]["a k3 s1"]
    b_ms, kind = bench_dwconv.k4_bound(3, 5, 7, 3, 4)
    assert a["count"] == 2 and a["bound_ms"] == b_ms and kind == "bytes"
    assert a["bound_share"] == b_ms / 0.5
    assert math.isnan(res["per_shape"]["b k5 s2"]["dw_pallas_ms"])
    assert any(l.startswith("launches dw_filter_grad=") for l in lines)
    bench_dwconv.main(["--check", "--dtype", "bfloat16"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["ok"] and res["worst_rel_err"] == 0.0
