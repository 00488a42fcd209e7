"""Launch plans of the ring kernels (csrc/bulk_ring.cuh): va's and gemv's
cut of their work over the persistent blocks, their stage sizes and their
routes, and the build's hash over the headers.

These tests check the launch plan that the Python wrappers compute and
pass to the kernels (`bulk_ring`, `va.plan`, `gemv.plan`); the CUDA
kernels run only on the card, where chip_smoke.py phase 6 holds them to
their plain versions on both routes."""

import pytest
import torch

from repro_torch.kernels import _build, bulk_ring
from repro_torch.kernels import gemv as kgemv
from repro_torch.kernels import va as kva

SMS = (1, 7, 132)
PRIM_N = 1 << 27
# chip_smoke.GEMV_CASES: granite-3-8b unembed and MLP up (bf16), PrIM GEMV
GEMV_CASES = ((49280, 4096, 2), (12800, 4096, 2), (8192, 2048, 4))
ALIGNED = (0x7f0000000000, 0x7f0000100000, 0x7f0000200000)


def _check_cut(units, blocks, per_block, extra, plan=True):
    """Every unit in exactly one block's range, in order; shares differ by
    at most one unit; in a plan no block is empty unless there is no
    unit."""
    assert 1 <= blocks and 0 <= extra < max(blocks, 1)
    nxt, shares = 0, []
    for b in range(blocks):
        first, count = bulk_ring.block_range(b, per_block, extra)
        assert first == nxt
        nxt += count
        shares.append(count)
    assert nxt == units
    assert max(shares) - min(shares) <= 1
    assert not plan or units == 0 or min(shares) >= 1


@pytest.mark.parametrize("blocks", SMS)
@pytest.mark.parametrize("units", [0, 1, 6, 7, 8, 131, 132, 133, 1000,
                                   8192, 32768, PRIM_N])
def test_block_cut_covers_every_unit_once(units, blocks):
    per_block, extra = bulk_ring.block_cut(units, blocks)
    _check_cut(units, blocks, per_block, extra, plan=False)


def test_block_cut_rejects_bad_arguments():
    for units, blocks in ((-1, 4), (4, 0)):
        with pytest.raises(ValueError):
            bulk_ring.block_cut(units, blocks)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n", [1, 3, 100, 4095, 4096, 4097, 8192, 8195,
                               (1 << 20) + 3, 1 << 20, 5_000_003, PRIM_N,
                               PRIM_N + 7])
def test_va_ring_plan(n, itemsize, sms):
    p = kva.plan(n, itemsize, ALIGNED, sms)
    assert p.route == "ring"
    stage = kva.STAGE_BYTES // itemsize
    assert p.units == n // stage and p.tail == n - p.units * stage
    assert 0 <= p.tail < stage
    assert p.blocks == max(1, min(kva.GRID_PER_SM * sms, p.units))
    _check_cut(p.units, p.blocks, p.per_block, p.extra)
    assert kva.STAGE_BYTES % bulk_ring.ALIGN == 0
    assert (kva.STAGE_BYTES // kva.CONSUMER_WARPS) % (16 * 32) == 0
    assert p.smem <= bulk_ring.SMEM_MAX
    assert p.threads == (kva.CONSUMER_WARPS + 1) * 32


def test_va_ring_fits_with_its_store_buffers():
    p = kva.plan(PRIM_N, 4, ALIGNED, 132)
    assert p.smem == (bulk_ring.BARRIER_BYTES + kva.STAGES * 2
                      * kva.STAGE_BYTES + 2 * kva.STAGE_BYTES)
    # two ring blocks fit on an SM beside each other
    assert 2 * p.smem <= bulk_ring.SMEM_MAX


@pytest.mark.parametrize("which", [0, 1, 2])
@pytest.mark.parametrize("offset", [2, 4, 8])
def test_va_unaligned_pointer_takes_stride(which, offset):
    ptrs = list(ALIGNED)
    ptrs[which] += offset
    p = kva.plan(PRIM_N, 2, tuple(ptrs), 132)
    assert p.route == "stride"
    # the stride kernel's grid, scalar loop: one element a thread
    assert p.blocks == kva.STRIDE_MAX_BLOCKS
    assert kva.plan(100, 4, tuple(ptrs), 132).blocks == 1
    with pytest.raises(ValueError, match="aligned"):
        kva.plan(PRIM_N, 2, tuple(ptrs), 132, "ring")


def test_va_stride_grid_matches_the_kernel():
    """The stride route's grid: 16-byte vectors a thread, at most 132 * 16
    blocks of 256 threads (the launcher the kernel had)."""
    assert kva.plan(PRIM_N, 4, ALIGNED, 132, "stride").blocks == 132 * 16
    assert kva.plan(4096, 4, ALIGNED, 132, "stride").blocks == 4
    assert kva.plan(0, 4, ALIGNED, 132, "stride").blocks == 1


def test_va_plan_rejects_an_unknown_route():
    with pytest.raises(ValueError, match="no route"):
        kva.plan(100, 4, ALIGNED, 132, "bogus")


def _check_gemv_ring(m, k, itemsize, sms):
    p = kgemv.plan(m, k, itemsize, ALIGNED[0], sms)
    assert p.route == "ring"
    assert p.blocks == min(kgemv.BLOCKS_PER_SM * sms, m)
    _check_cut(m, p.blocks, p.per_block, p.extra)
    # a stage: RING_WARPS rows of kc columns, 16-byte multiples, in the cap
    assert p.kc * itemsize % bulk_ring.ALIGN == 0 and 1 <= p.kc <= k
    assert p.stage_bytes == kgemv.RING_WARPS * p.kc * itemsize
    assert p.stage_bytes % bulk_ring.ALIGN == 0
    assert p.stage_bytes <= kgemv.STAGE_CAP
    # K's chunks: whole rows where they fit, the last chunk 16-byte too
    chunks = -(-k // p.kc)
    assert (chunks == 1) == (kgemv.RING_WARPS * k * itemsize
                             <= kgemv.STAGE_CAP)
    assert (k - (chunks - 1) * p.kc) * itemsize % bulk_ring.ALIGN == 0
    assert p.smem == (bulk_ring.BARRIER_BYTES + kgemv.STAGES * p.stage_bytes
                      + 4 * k) <= bulk_ring.SMEM_MAX
    return p


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m,k,itemsize", GEMV_CASES)
def test_gemv_ring_plan_at_the_paths_shapes(m, k, itemsize, sms):
    p = _check_gemv_ring(m, k, itemsize, sms)
    # 8 KB rows in two 4 KB chunks: full 16 KB stages of 4 copies
    assert 2 * p.kc == k and p.stage_bytes == kgemv.STAGE_CAP
    assert p.blocks == min(sms, m) and p.smem <= bulk_ring.SMEM_MAX // 2


@pytest.mark.parametrize("n", [PRIM_N, (1 << 20) + 3])
def test_va_ring_grid_has_many_ranges_per_sm(n):
    """Short ranges, many per SM, so that the block scheduler balances the
    SMs; at PrIM's size each block streams 3 or 4 stages."""
    p = kva.plan(n, 4, ALIGNED, 132)
    assert p.blocks == min(kva.GRID_PER_SM * 132, p.units)
    if n == PRIM_N:
        assert (p.per_block, p.blocks) == (3, 16896)


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("m", [1, 3, 4, 5, 131, 132, 133, 1000, 8192])
@pytest.mark.parametrize("k,itemsize", [(4, 4), (8, 2), (2048, 4),
                                        (4096, 2), (9000, 4), (12800, 2),
                                        (kgemv.MAX_RING_K, 4)])
def test_gemv_ring_plan(m, k, itemsize, sms):
    _check_gemv_ring(m, k, itemsize, sms)


@pytest.mark.parametrize("m,k,itemsize,ptr", [
    (300, 700, 2, ALIGNED[0]),        # K * size % 16 != 0
    (8, 3, 4, ALIGNED[0]),
    (8192, 2048, 4, ALIGNED[0] + 4),  # unaligned A
    (8192, 4096, 2, ALIGNED[0] + 8),
    (1, 0, 4, ALIGNED[0]),            # K = 0
    (64, kgemv.MAX_RING_K + 4, 4, ALIGNED[0]),   # x does not fit
])
def test_gemv_second_route(m, k, itemsize, ptr):
    p = kgemv.plan(m, k, itemsize, ptr, 132)
    assert p.route == "rows"
    assert p.blocks == -(-m // kgemv.ROWS_PER_BLOCK)
    with pytest.raises(ValueError, match="ring route needs"):
        kgemv.plan(m, k, itemsize, ptr, 132, "ring")


def test_gemv_plan_rejects_an_unknown_route():
    with pytest.raises(ValueError, match="no route"):
        kgemv.plan(8, 8, 4, ALIGNED[0], 132, "bogus")


def test_gemv_max_ring_k_is_the_edge():
    assert kgemv.ring_smem(kgemv.MAX_RING_K, 4) <= bulk_ring.SMEM_MAX
    assert kgemv.ring_smem(kgemv.MAX_RING_K + 4, 4) > bulk_ring.SMEM_MAX


def test_ring_wrappers_refuse_cpu_tensors_with_a_route():
    """The new `route` argument does not get round the device check."""
    a = torch.zeros(4096, dtype=torch.int32)
    A, x = torch.zeros(8, 8), torch.zeros(8)
    for call in (lambda: kva.va(a, a, "ring"),
                 lambda: kgemv.gemv(A, x, "rows")):
        before = (kva.KERNEL.launches, kgemv.KERNEL.launches,
                  dict(kva.KERNEL.route_launches),
                  dict(kgemv.KERNEL.route_launches))
        with pytest.raises(ValueError, match="CUDA"):
            call()
        assert before == (kva.KERNEL.launches, kgemv.KERNEL.launches,
                          kva.KERNEL.route_launches,
                          kgemv.KERNEL.route_launches)


def test_route_count_reads_the_label_parts():
    """gemv labels its launches accumulator/route; `route_count` sums them
    by either part, and `reset` clears them with the launch count."""
    kern = _build.CudaKernel("gemv", "gemv", [])
    kern.launches = 4
    kern.route_launches.update({"f32/ring": 2, "int32/ring": 1,
                                "int32/rows": 1})
    assert kern.route_count("ring") == 3
    assert kern.route_count("int32") == 2
    assert kern.route_count("rows") == 1
    assert kern.route_count("in") == 0
    kern.reset()
    assert kern.launches == 0 and not kern.route_launches


def test_aligned():
    assert bulk_ring.aligned(0, 16, 4096)
    assert not bulk_ring.aligned(0, 8)
    assert bulk_ring.aligned()


@pytest.mark.parametrize("edit", ["header", "source"])
def test_build_dir_hashes_headers(tmp_path, monkeypatch, edit):
    (tmp_path / "k.cu").write_text('#include "ring.cuh"\n')
    (tmp_path / "ring.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [s.name for s in _build.sources()] == ["k.cu"]
    before = _build.build_dir()
    assert _build.build_dir() == before
    if edit == "header":
        (tmp_path / "ring.cuh").write_text("// v2\n")
    else:
        (tmp_path / "k.cu").write_text('#include "ring.cuh"\n// v2\n')
    assert _build.build_dir() != before


def test_build_dir_covers_the_ring_header():
    assert (_build.CSRC / "bulk_ring.cuh").is_file()
    assert (_build.CSRC / "bulk_ring.cuh") not in _build.sources()
