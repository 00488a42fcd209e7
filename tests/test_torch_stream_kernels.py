"""The port's streaming kernels on the CPU (their plain PyTorch versions,
reached through `repro_torch.kernels.ops`) against the reference's Pallas
kernels in interpret mode and its `kernels/ref.py`, over the sweeps of
tests/test_kernels.py. The CUDA kernels run only on the card
(chip_smoke.py phase 6); here their wrappers are held to their argument
checks.

Tolerances: va and stream_ops exact (integer adds, and float adds of the
same operands in the same order; the jitted Pallas path of f32
stream_ops within 1 ulp, see its test); reduction rtol 1e-5 (f32 sums in
another order); gemv 1e-5 at f32 and 2e-2 at bf16 (test_kernels.py's
band: the two f32 sums may round to neighbouring bf16 values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import bridge
from repro_torch.kernels import gemv as kgemv
from repro_torch.kernels import microbench as kmb
from repro_torch.kernels import ops
from repro_torch.kernels import reduction as kred
from repro_torch.kernels import va as kva

JDT = {"int32": jnp.int32, "float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(a):
    """numpy f32/int array -> (jax array in its dtype, torch CPU tensor
    with the same bits)."""
    j = jnp.asarray(a)
    return j, bridge.tensor_from_numpy(np.asarray(j), "cpu")


def _normal(rng, shape, dtype, scale=1.0):
    return _pair(jnp.asarray(rng.normal(size=shape).astype(np.float32)
                             * scale, JDT[dtype]))


def _ints(rng, shape, lo, hi, dtype="int32"):
    return _pair(jnp.asarray(rng.integers(lo, hi, size=shape)
                             .astype(np.int32), JDT[dtype]))


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


@pytest.mark.parametrize("n", [128, 4096, 100_001, 262_144])
@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
def test_va(n, dtype):
    rng = np.random.default_rng(0)
    if dtype == "bfloat16":
        (aj, at), (bj, bt) = (_normal(rng, n, dtype) for _ in range(2))
    else:
        (aj, at), (bj, bt) = (_ints(rng, n, -99, 99, dtype)
                              for _ in range(2))
    got = ops.va(at, bt)
    assert got.dtype == at.dtype and tuple(got.shape) == (n,)
    np.testing.assert_array_equal(_np(got), _jnp(jref.va(aj, bj)))
    np.testing.assert_array_equal(_np(got),
                                  _jnp(jops.va(aj, bj, interpret=True)))


def test_va_int32_wraps():
    big = np.array([2**31 - 1, -2**31, 2**31 - 5], np.int32)
    (aj, at), (bj, bt) = _pair(big), _pair(np.array([1, -1, 9], np.int32))
    np.testing.assert_array_equal(ops.va(at, bt).numpy(),
                                  np.asarray(jref.va(aj, bj)))


@pytest.mark.parametrize("m,kk", [(256, 512), (300, 700), (1024, 1024),
                                  (8, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemv(m, kk, dtype):
    rng = np.random.default_rng(2)
    Aj, At = _normal(rng, (m, kk), dtype, 1 / 8)
    xj, xt = _normal(rng, (kk,), dtype, 1 / 8)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    got = ops.gemv(At, xt)
    assert got.dtype == At.dtype and tuple(got.shape) == (m,)
    for want in (jref.gemv(Aj, xj), jops.gemv(Aj, xj, interpret=True)):
        np.testing.assert_allclose(_np(got), _jnp(want), rtol=tol, atol=tol)


def test_gemv_mixed_dtypes_accumulate_in_f32():
    rng = np.random.default_rng(3)
    Aj, At = _normal(rng, (64, 96), "bfloat16")
    xj, xt = _normal(rng, (96,), "float32")
    got = ops.gemv(At, xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _jnp(jref.gemv(Aj, xj)),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("n", [65_536, 70_000, 128])
def test_reduction(n):
    rng = np.random.default_rng(4)
    xj, xt = _normal(rng, n, "float32")
    got = ops.reduction(xt)
    assert got.dtype == torch.float32 and got.dim() == 0
    for want in (jref.reduction(xj), jops.reduction(xj, interpret=True)):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["int32", "bfloat16"])
def test_reduction_other_dtypes(dtype):
    rng = np.random.default_rng(5)
    xj, xt = (_ints(rng, 5000, -50, 50) if dtype == "int32"
              else _normal(rng, 5000, dtype))
    got = ops.reduction(xt)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(jref.reduction(xj)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ops_per_elem", [0, 1, 4, 16])
def test_stream_ops_int32(ops_per_elem):
    rng = np.random.default_rng(13)
    xj, xt = _ints(rng, 10_000, 0, 100)
    got = ops.stream_ops(xt, ops_per_elem)
    assert got.dtype == torch.int32 and tuple(got.shape) == (10_000,)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.microbench_stream(xj, ops_per_elem)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jops.stream_ops(xj, ops_per_elem,
                                                interpret=True)))


@pytest.mark.parametrize("ops_per_elem", [1, 4, 16])
def test_stream_ops_float32(ops_per_elem):
    """f32 is exact against the oracle, which rounds after every add as
    the CUDA kernel does. Under jit XLA folds the constant adds of the
    interpret-mode Pallas kernel into fewer roundings, so that path is
    held to 1 ulp instead (measured: 0 at k = 1, 1 ulp at k = 4, 16)."""
    rng = np.random.default_rng(14)
    xj, xt = _normal(rng, 10_000, "float32", 100.0)
    got = ops.stream_ops(xt, ops_per_elem)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jref.microbench_stream(xj, ops_per_elem)))
    np.testing.assert_array_max_ulp(
        got.numpy(), np.asarray(jops.stream_ops(xj, ops_per_elem,
                                                interpret=True)), maxulp=1)


def test_stream_ops_int32_wraps():
    xj, xt = _pair(np.array([2**31 - 3, -5, 0], np.int32))
    np.testing.assert_array_equal(
        ops.stream_ops(xt, 8).numpy(),
        np.asarray(jref.microbench_stream(xj, 8)))


def test_stream_wrappers_reject_bad_arguments():
    i32, f32 = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    bad = [
        lambda: ops.va(i32, f32),                          # dtypes differ
        lambda: ops.va(f32, torch.zeros(9)),               # shapes differ
        lambda: ops.va(f32.half(), f32.half()),            # dtype
        lambda: ops.va(f32[None], f32[None]),              # not 1-D
        lambda: ops.gemv(torch.zeros(4, 8), torch.zeros(7)),   # K
        lambda: ops.gemv(torch.zeros(4, 8).int(), i32),    # dtype
        lambda: ops.gemv(torch.zeros(8), f32),             # A not 2-D
        lambda: ops.gemv(torch.zeros(4, 8), torch.zeros(8, 1)),
        lambda: ops.reduction(f32.double()),               # dtype
        lambda: ops.reduction(torch.zeros(4, 2)),          # not 1-D
        lambda: ops.stream_ops(f32.bfloat16(), 4),         # dtype
        lambda: ops.stream_ops(i32, -1),                   # ops_per_elem
        lambda: ops.stream_ops(i32, 2.0),
        lambda: ops.stream_ops(i32, True),
        lambda: ops.stream_ops(i32[None], 1),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(ValueError):
            call()
            pytest.fail(f"case {i} did not raise")


def test_stream_cuda_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: handed CPU tensors they raise
    before building anything."""
    f32 = torch.zeros(8)
    for call in (lambda: kva.va(f32, f32),
                 lambda: kgemv.gemv(torch.zeros(2, 8), f32),
                 lambda: kred.reduction(f32),
                 lambda: kmb.stream_ops(f32, 3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    for mod in (kva, kgemv, kred, kmb):
        assert mod.KERNEL.launches == 0
    assert set(ops.kernels()) == {"decode_attention", "flash_attention",
                                  "va", "reduction", "stream_ops", "gemv"}
