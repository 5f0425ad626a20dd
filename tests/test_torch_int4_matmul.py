"""The int4 weight-streaming matmul (K3) of samd_tpu_torch against the JAX
Pallas kernel.

On the CPU the port's wrapper takes its plain version; it is held against
JAX's ``int4_matmul`` run in interpret mode, as ``tests/test_quant.py``
runs it, for 2-D and stacked weights, every layer, f32 and bf16 outputs.
The CUDA kernel itself is held against the plain version in
``test_torch_kernel_cuda.py``, on a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samd_tpu.ops.int4_matmul import int4_matmul as jax_int4_matmul
from samd_tpu.ops.quant import quantize_weight4 as jax_quantize_weight4
from samd_tpu_torch.ops.int4_matmul import (int4_matmul, int4_matmul_ref,
                                            k_splits, kernel_tolerance,
                                            mma_order_sum)
from samd_tpu_torch.ops.quant import unpack4
from test_torch_model import one_torch_thread  # noqa: F401 (autouse)

U = 2.0 ** -24


def case(L, IN, OUT, R, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((L, IN, OUT)).astype(np.float32) * 0.1
    qt = jax_quantize_weight4(jnp.asarray(w))
    x = rng.standard_normal((R, IN)).astype(np.float32)
    return x, np.array(qt.packed), np.array(qt.scale)


def v2sum_tolerance(x, packed, scale, ref):
    """Bound on |port − JAX "v2-sum"| per element.

    The reference recovers the high half as (Σ x·p − Σ x·lo)/16 − 8·Σ x, so
    its rounding error is a few ulps of those sums' magnitudes, up to
    Σ|x|·p/16 ≈ 16·Σ|x| — far above the output's own.  Both packages sum
    in blocks whose partial sums are exact to 2^-24 each; 2^-19 (32 ulps)
    of the combined magnitude (|x| @ (p/16 + lo/16 + |q−8| + 8))·scale
    bounds the difference at these lengths.  A bf16 output adds one
    rounding on each side, 2^-7 of the value."""
    p = packed.astype(np.float64)
    lo = (packed & 15).astype(np.float64)
    q = np.abs(np.concatenate([lo - 8, (packed >> 4) - 8.0], axis=-1))
    mag = np.abs(x).astype(np.float64) @ (
        np.concatenate([p, p], axis=-1) / 16 + np.concatenate([lo, lo], -1)
        / 16 + q + 8) * scale
    e = 32 * U * mag
    if ref.dtype == np.float32:
        return e
    return e + 2.0 ** -7 * (1.01 * np.abs(ref.astype(np.float32)) + e)


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,IN,OUT,R", [(1, 512, 256, 8), (3, 512, 256, 16),
                                         (2, 256, 512, 5)])
def test_matches_jax_interpret(L, IN, OUT, R, out_dtype):
    x, packed, scale = case(L, IN, OUT, R, seed=L + R)
    jdt = jnp.float32 if out_dtype == torch.float32 else jnp.bfloat16
    before = int4_matmul.launches
    for layer in range(L):
        if L == 1:    # the 2-D form of a weight, as the head passes it
            want = jax_int4_matmul(jnp.asarray(x), jnp.asarray(packed[0]),
                                   jnp.asarray(scale[0]), out_dtype=jdt,
                                   interpret=True)
            got = int4_matmul(torch.from_numpy(x),
                              torch.from_numpy(packed[0]),
                              torch.from_numpy(scale[0]),
                              out_dtype=out_dtype)
        else:
            want = jax_int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                   jnp.asarray(scale), jnp.int32(layer),
                                   out_dtype=jdt, interpret=True)
            got = int4_matmul(torch.from_numpy(x), torch.from_numpy(packed),
                              torch.from_numpy(scale), layer,
                              out_dtype=out_dtype)
        assert got.shape == (R, OUT) and got.dtype == out_dtype
        want = np.asarray(want).astype(np.float32)
        tol = v2sum_tolerance(x, packed[layer], scale[layer],
                              np.asarray(want) if out_dtype == torch.float32
                              else want.astype(jnp.bfloat16))
        excess = np.abs(to_np(got) - want) - tol
        assert excess.max() <= 0, (layer, excess.max())
    assert int4_matmul.launches == before        # CPU: the plain version


def test_tolerance_catches_one_wrong_nibble():
    """The JAX comparison's bound is tight enough to see a single weight
    off by one step, in the column it lands in."""
    x, packed, scale = case(1, 512, 256, 4, seed=3)
    want = np.asarray(jax_int4_matmul(jnp.asarray(x), jnp.asarray(packed[0]),
                                      jnp.asarray(scale[0]), interpret=True))
    bad = packed[0].copy()
    k = int(np.abs(x[:, :]).sum(0).argmax())      # a row x weighs heavily
    bad[k, 7] = (bad[k, 7] & 0xF0) | ((bad[k, 7] & 15) ^ 1)
    got = to_np(int4_matmul(torch.from_numpy(x), torch.from_numpy(bad),
                            torch.from_numpy(scale[0])))
    tol = v2sum_tolerance(x, packed[0], scale[0], want)
    assert (np.abs(got - want) > tol)[:, 7].all()


def test_plain_version_is_dequant_then_matmul():
    """int4_matmul_ref is x @ ((nibble − 8)·scale) up to where the scale is
    applied, on a leading batch shape too."""
    x, packed, scale = case(2, 256, 128, 6, seed=5)
    xt = torch.from_numpy(x).reshape(2, 3, 256)
    got = int4_matmul_ref(xt, torch.from_numpy(packed),
                          torch.from_numpy(scale), 1)
    w = unpack4(torch.from_numpy(packed[1])).float() \
        * torch.from_numpy(scale[1])
    assert got.shape == (2, 3, 128)
    np.testing.assert_allclose(got.numpy(), (xt @ w).numpy(), rtol=1e-5,
                               atol=1e-5)


def test_kernel_tolerance_admits_another_order_and_bf16_rounding():
    """The bound the kernel is held to on the card: it admits the plain
    result summed in another order (f32) and then rounded to bf16, and it
    rejects a single weight off by one step."""
    x, packed, scale = case(1, 512, 256, 4, seed=6)
    xt, pt, st = (torch.from_numpy(a) for a in (x, packed[0], scale[0]))
    ref = int4_matmul_ref(xt, pt, st)
    q = unpack4(pt).double()
    exact = ((xt.double() @ q) * st.double()).float()  # another order
    tol = kernel_tolerance(xt, pt, st, None, ref)
    assert ((exact - ref).abs() <= tol).all()
    ref16 = int4_matmul_ref(xt, pt, st, out_dtype=torch.bfloat16)
    tol16 = kernel_tolerance(xt, pt, st, None, ref16)
    assert ((exact.to(torch.bfloat16).float() - ref16.float()).abs()
            <= tol16).all()
    one_step = xt.abs().max(dim=1).values[:, None] * st[None, :]
    assert (one_step > tol).all()


def test_order_model_truncates_below_the_largest_product():
    """``mma_order_sum`` drops what the mma's alignment shifts out: with
    products 1, −2^-25, −2^-25 the exact sum 1 − 2^-24 is an f32, but both
    small products fall below the largest's 24 bits and truncate to zero;
    with two extra bits kept they survive."""
    x = torch.zeros((1, 16))
    x[0, :3] = torch.tensor([1.0, -2.0 ** -25, -2.0 ** -25])
    q = torch.ones((16, 1))
    assert (x.double() @ q.double()).float().item() == 1 - 2.0 ** -24
    assert mma_order_sum(x, q, 1).item() == 1.0
    assert mma_order_sum(x, q, 1, extra_bits=2).item() == 1 - 2.0 ** -24


def test_k_splits_by_shape_alone():
    """The tensor-core kernel's k split at llama_7b's shapes: q/k/v/o and
    w_down over two CTAs (128 of them at R ≤ 16, within one per SM of
    132), w_gate and the head over one; no warp slice under eight k16
    steps; a narrow weight's split stops at that floor."""
    shapes = ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000))
    got = [k_splits(i, o // 2) for i, o in shapes]
    assert got == [2, 1, 2, 1]
    for (i, o), z in zip(shapes, got):
        assert (z == 1 or -(-o // 64) * z <= 132) and i // 16 // (8 * z) >= 8
    assert k_splits(4096, 16) == 4096 // 16 // (8 * 8)


@pytest.mark.parametrize("fault", ["none", "skip_first", "round_partials"])
def test_kernel_tolerance_at_7b_length(fault):
    """At w_down's contraction length (11008) the bound admits the f64
    result and the kernel's order as w_down cuts it (16-k sums with the
    mma's truncation modelled, two CTAs of eight slices), and rejects a
    sum that drops one k per slice or rounds each slice's partial to
    bf16."""
    rng = np.random.default_rng(11)
    n, out, R = 11008, 128, 8
    packed = torch.from_numpy(
        rng.integers(0, 256, (n, out // 2), dtype=np.uint8))
    scale = torch.from_numpy(
        rng.uniform(1e-3, 5e-3, out).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((R, n)).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    ref = int4_matmul_ref(x, packed, scale)
    tol = kernel_tolerance(x, packed, scale, None, ref)
    q = unpack4(packed).float()
    splits = k_splits(n, 4096 // 2)
    if fault == "none":
        exact = ((x.double() @ q.double()) * scale.double()).float()
        assert ((exact - ref).abs() <= tol).all()
        assert ((mma_order_sum(x, q, splits) * scale - ref).abs()
                <= tol).all()
    else:
        bad = mma_order_sum(x, q, splits, **{fault: True}) * scale
        assert ((bad - ref).abs() > tol).any()


def _bad_inputs():
    x, packed, scale = (torch.from_numpy(a) for a in case(2, 256, 128, 4))
    yield "contraction", (x[:, :128].contiguous(), packed, scale, 0), {}, \
        ValueError, "contraction length"
    yield "scale_shape", (x, packed, scale[:, :64], 0), {}, ValueError, \
        "scale"
    yield "no_layer", (x, packed, scale), {}, ValueError, "layer index"
    yield "layer_on_2d", (x, packed[0], scale[0], 1), {}, ValueError, \
        "stacked"
    yield "layer_range", (x, packed, scale, 2), {}, ValueError, "range"
    yield "x_dtype", (x.to(torch.float16), packed, scale, 0), {}, \
        ValueError, "f32 or bf16"
    yield "out_dtype", (x, packed, scale, 0), {"out_dtype": torch.int32}, \
        ValueError, "f32 or bf16"
    yield "packed_dtype", (x, packed.to(torch.int8), scale, 0), {}, \
        ValueError, "uint8"
    yield "strided_x", (x.t().contiguous().t(), packed, scale, 0), {}, \
        ValueError, "contiguous"
    yield "device", (x, packed.to("meta"), scale.to("meta"), 0), {}, \
        ValueError, "meta"


@pytest.mark.parametrize("name", [c[0] for c in _bad_inputs()])
def test_wrapper_rejects(name):
    _, args, kw, exc, match = next(c for c in _bad_inputs() if c[0] == name)
    with pytest.raises(exc, match=match):
        int4_matmul(*args, **kw)
