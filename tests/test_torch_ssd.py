"""The SSD chunk kernel's ``mma`` route, on the CPU: its plan, its route,
its arithmetic, and the reference outputs its card tests are held to.

* ``ssd_plan`` covers every live (query tile, key step) pair of a chunk
  exactly once, never one above the diagonal, and gives every block of a
  cell equal work;
* ``ssd_route`` picks ``mma`` for every SSD launch of the models' forwards
  and ``simt`` only for what the tensor-core kernel does not take;
* a CPU emulation of the route's arithmetic (TF32 cut by bit mask, each
  product as lo·hi + hi·lo + hi·hi in k steps of 8, the diagonal pair's
  plain fp32 dot product, the decay and mask on the scores, the P·X
  product with its k permutation) stays within the reference's 1e-4 per
  output row at mamba2-370m's widths and decay, where one TF32 pass does
  not;
* ``tests/data/ssd_pallas.npz`` still holds what the reference's Pallas
  kernel computes in interpret mode (``tests/ssd_pallas_ref.py``).

The kernel itself runs only on the card (``tests/test_torch_kernels_gpu.py``).
"""

import numpy as np
import pytest
import torch

import ssd_pallas_ref
from repro_torch.kernels.ssd_scan import (mma_smem_bytes, ssd_chunk_diag,
                                          ssd_chunk_diag_ref, ssd_plan,
                                          ssd_route)

SSD_TOL = 1e-4            # tests/test_kernels.py:169, f32, per output row
_MAX_SMEM = 232_448       # what one block may use on an H100
_SM_SMEM = 233_472        # one SM's shared memory
BQ, BK = 64, 32           # csrc/ssd_mma.cuh's query tile and key step


def _live_pairs(q):
    """Every (query tile, key step) holding a pair j <= i < q."""
    return {(t, k) for t in range(-(-q // BQ)) for k in range(-(-q // BK))
            if k * BK <= min(t * BQ + BQ - 1, q - 1)}


@pytest.mark.parametrize("q", [8, 16, 100, 256])
def test_ssd_plan_covers_the_triangle_once_with_equal_work(q):
    plan = ssd_plan(q)
    seen = [(t, k) for blk in plan.blocks for t in blk
            for k in range(plan.key_steps(t, q))]
    assert len(seen) == len(set(seen))
    assert set(seen) == _live_pairs(q)
    assert all(k * BK <= t * BQ + BQ - 1 for t, k in seen)   # below the diagonal
    assert len(set(plan.work(q))) == 1
    assert sorted(t for blk in plan.blocks for t in blk) == list(
        range(plan.tiles))


def test_ssd_plan_pairs_tiles_from_both_ends():
    """The kernel maps block p to tiles (p, tiles − 1 − p); an odd tile
    count leaves the middle tile a block of its own, with half the work."""
    plan = ssd_plan(512)
    assert plan.tiles == 8
    assert plan.blocks == ((0, 7), (1, 6), (2, 5), (3, 4))
    assert plan.work(512) == (18,) * 4
    odd = ssd_plan(150)
    assert odd.blocks == ((0, 2), (1,))
    assert set(t for blk in odd.blocks for t in blk) == {0, 1, 2}
    assert max(odd.work(150)) == 7
    with pytest.raises(ValueError):
        ssd_plan(0)


@pytest.mark.parametrize("dtype,p,n,ptrs,route", [
    (torch.float32, 64, 128, (0, 0, 0, 0, 0), "mma"),    # mamba2-370m
    (torch.bfloat16, 64, 128, (0, 0, 0, 0, 0), "mma"),
    (torch.float32, 16, 8, (0, 0, 0, 0, 0), "mma"),      # test_kernels.py
    (torch.float32, 8, 8, (0, 0, 0, 0, 0), "mma"),
    (torch.float32, 80, 40, (0, 0, 0, 0, 0), "mma"),     # ragged widths
    (torch.bfloat16, 80, 40, (0, 0, 0, 0, 0), "mma"),
    (torch.float32, 64, 128, (0, 4, 0, 0, 0), "mma"),    # dt_a read by element
    (torch.float32, 200, 128, (0, 0, 0, 0, 0), "simt"),  # P > 128
    (torch.float32, 64, 6, (0, 0, 0, 0, 0), "simt"),     # 24-byte rows
    (torch.bfloat16, 64, 4, (0, 0, 0, 0, 0), "simt"),    # 8-byte rows
    (torch.bfloat16, 12, 128, (0, 0, 0, 0, 0), "simt"),
    (torch.float32, 64, 128, (8, 0, 0, 0, 0), "simt"),   # misaligned x
    (torch.float32, 64, 128, (0, 0, 0, 0, 8), "simt"),   # misaligned out
    (torch.float32, 64, 512, (0, 0, 0, 0, 0), "simt"),   # C too big to stay
    (torch.float16, 64, 128, (0, 0, 0, 0, 0), "simt"),
])
def test_ssd_route(dtype, p, n, ptrs, route):
    assert ssd_route(dtype, p, n, ptrs) == route


def test_ssd_mma_block_fits_twice_an_sm_at_the_model_widths():
    """mamba2-370m's widths (P 64, N 128) leave room for two blocks an SM
    (1 KB of each block is the system's); every width the route takes
    fits one block."""
    assert mma_smem_bytes(128, 64, 4) == 114_752
    assert 2 * (mma_smem_bytes(128, 64, 4) + 1024) <= _SM_SMEM
    for p in range(4, 129, 4):
        for n in range(4, 257, 4):
            if ssd_route(torch.float32, p, n, (0,) * 5) == "mma":
                assert mma_smem_bytes(n, p, 4) <= _MAX_SMEM


def _tf32(x):
    """What the mma reads of an fp32 register: its top 19 bits (TF32), the
    low 13 mantissa bits cleared (truncation by bit mask)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _split(x):
    """The kernel's split: hi = x cut to TF32, lo = x − hi (exact in
    fp32); the mma then reads lo cut to TF32 as well."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mma_3x(acc, a, b, passes=3):
    """acc += a @ b in k steps of 8, each as lo·hi + hi·lo + hi·hi (small
    terms first) into the fp32 accumulator; ``passes=1`` is one TF32
    pass (hi·hi)."""
    for k in range(0, a.shape[-1], 8):
        ah, al = _split(a[..., k:k + 8])
        bh, bl = _split(b[..., k:k + 8, :])
        if passes == 3:
            acc = acc + al @ bh
            acc = acc + ah @ bl
        acc = acc + ah @ bh
    return acc


def _mma_route_emulation(x, dta, b, c, passes=3):
    """The mma route's arithmetic on one chunk per leading index, in fp32:
    S = C·Bᵀ (3xTF32, k steps of 8) but the pair (i, i), which takes the
    plain fp32 dot product c_i · b_i; decay 2^((dq − dk)·log2 e), mask by
    select; then Y += P·X one 32-key step at a time, each 8-key k step in
    the kernel's permuted order (A slot t takes key 2t, slot t + 4 key
    2t + 1)."""
    q = x.shape[-2]
    s = _mma_3x(torch.zeros(*x.shape[:-2], q, q), c, b.transpose(-1, -2),
                passes)
    pos = torch.arange(q)
    s[..., pos, pos] = (c * b).sum(-1)
    d = (dta[..., :, None] - dta[..., None, :]) * np.float32(1.4426950408889634)
    p = torch.where(pos[None, :] <= pos[:, None], s * torch.exp2(d),
                    torch.zeros(()))
    perm = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    keys = torch.cat([k + perm for k in range(0, -(-q // 8) * 8, 8)])
    keys = keys[keys < q]
    y = torch.zeros(x.shape)
    for k0 in range(0, q, BK):
        blk = keys[k0:k0 + BK]
        y = _mma_3x(y, p[..., :, blk], x[..., blk, :], passes)
    return y


def _row_err(got, want):
    scale = want.abs().amax(dim=-1)
    return ((got - want).abs().amax(dim=-1) / scale).max().item()


def test_mma_route_arithmetic_keeps_the_f32_bar_at_the_model_decay():
    """Q 256, P 64, N 128 (mamba2-370m's chunk, head and state dims),
    log-decays from dt ≈ 0.7 (about -140 over the chunk): the emulated
    3xTF32 route stays within 1e-4 of each output row of the plain
    version, where a single TF32 pass misses the bar tenfold."""
    rng = np.random.default_rng(19)
    q, p, n = 256, 64, 128
    x = torch.from_numpy(rng.normal(size=(2, 1, q, p)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(2, 1, q, n)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(2, 1, q, n)).astype(np.float32))
    dta = torch.from_numpy(np.cumsum(
        -np.abs(rng.normal(size=(2, 1, q))) * 0.7, axis=-1).astype(np.float32))
    assert dta[..., -1].max().item() < -100
    want = ssd_chunk_diag_ref(x, dta, b, c)
    got = _mma_route_emulation(x, dta, b, c)
    assert torch.isfinite(got).all()
    assert _row_err(got, want) <= SSD_TOL
    assert _row_err(_mma_route_emulation(x, dta, b, c, passes=1), want) \
        > 10 * SSD_TOL


def test_tf32_split_is_exact_and_cut_by_bit_mask():
    """hi keeps 10 mantissa bits (cut toward zero), hi + lo is x exactly,
    and what the mma reads of lo errs by less than 2^-20 of x."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + 3 * ulp / 4,
                      3.0, -0.0])
    assert _tf32(x).tolist() == [1.0, -1.0, 1.0, 3.0, -0.0]
    r = torch.randn(1000)
    hi = _tf32(r)
    assert torch.equal(hi + (r - hi), r)
    _, lo = _split(r)
    assert torch.equal(_tf32(lo), lo)
    assert ((hi + lo - r).abs() <= r.abs() * 2.0 ** -20).all()


@pytest.fixture(scope="module")
def ssd_pallas_kept():
    return ssd_pallas_ref.load(), ssd_pallas_ref.pallas_outputs()


@pytest.mark.parametrize("dtype", ssd_pallas_ref.DTYPES)
def test_ssd_pallas_outputs_are_kept(ssd_pallas_kept, dtype):
    """``tests/data/ssd_pallas.npz`` holds what the reference's Pallas SSD
    chunk kernel computes on the deep-decay ragged case the card tests hold
    the kernels against (to within one rounding of the output), and the
    port's plain version agrees with it at the usual bars per row."""
    kept, fresh = ssd_pallas_kept
    want = fresh[dtype]
    shape = (ssd_pallas_ref.BH, ssd_pallas_ref.C, ssd_pallas_ref.Q,
             ssd_pallas_ref.P)
    assert kept[dtype].shape == want.shape == shape
    assert np.isfinite(kept[dtype]).all()
    scale = np.abs(want).max(axis=-1)
    bar = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert (np.abs(kept[dtype] - want).max(axis=-1) / scale).max() <= bar
    dt = getattr(torch, dtype)
    ins = [torch.from_numpy(a).to(dt) for a in ssd_pallas_ref.inputs()]
    assert ins[1][..., -1].max().item() < -100
    before = dict(ssd_chunk_diag.route_launches)
    got = ssd_chunk_diag(*ins).float().numpy()
    assert ssd_chunk_diag.route_launches == before    # CPU: no launch
    tol = SSD_TOL if dtype == "float32" else 2e-2
    assert (np.abs(got - want).max(axis=-1) / scale).max() <= tol


# ---------------------------------------------------------------------------
# The whole SSD core with B and C once a group (``ssd_scan``), on the CPU:
# the host lowering's bits, the shape check, the chunked route's choice and
# counters, the autograd rule, the head-sharded plan.  The chunked kernels
# themselves run only on the card.
# ---------------------------------------------------------------------------

from repro_torch.core import blas                                  # noqa: E402
from repro_torch.core.hero import offload_policy                   # noqa: E402
from repro_torch.kernels import autograd as kgrad                  # noqa: E402
from repro_torch.kernels.ref import ssd_scan_ref                   # noqa: E402
from repro_torch.kernels.ssd_scan import (                         # noqa: E402
    SCAN_KERNELS, SCAN_ROUTES, chunk_smem_bytes, heads_per_block, scan_route,
    ssd_scan, state_stages)


def _group_operands(bsz=2, s=32, h=8, g=2, p=16, n=8, seed=0):
    """x (B, S, H, P), dt, a, B and C (B, S, G, N) as views of one
    conv-output-shaped (B, S, H·P + 2·G·N) buffer, d_skip."""
    gen = torch.Generator().manual_seed(seed)
    buf = torch.randn(bsz, s, h * p + 2 * g * n, generator=gen)
    x = buf[..., :h * p].view(bsz, s, h, p)
    b = buf[..., h * p:h * p + g * n].view(bsz, s, g, n)
    c = buf[..., h * p + g * n:].view(bsz, s, g, n)
    dt = torch.nn.functional.softplus(torch.randn(bsz, s, h, generator=gen))
    a = -torch.rand(h, generator=gen) - 0.1
    d_skip = torch.randn(h, generator=gen)
    return x, dt, a, b, c, d_skip


def _per_head(t, h):
    return t.repeat_interleave(h // t.shape[2], dim=2)


@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("chunk", [8, 32])
@pytest.mark.parametrize("mode,use_kernels", [("host", False),
                                              ("device", True)])
def test_group_b_and_c_equal_the_per_head_call_bit_for_bit(g, chunk, mode,
                                                           use_kernels):
    """B and C once a group give exactly the per-head call's result (chunk
    < S and chunk = S), through the seam's host lowering and through the
    kernel lowering's CPU path, and the plain core's too."""
    x, dt, a, b, c, d = _group_operands(s=32, h=16, g=g)
    with offload_policy(mode=mode, use_kernels=use_kernels):
        got = blas.ssd_scan(x, dt, a, b, c, d, chunk=chunk)
        want = blas.ssd_scan(x, dt, a, _per_head(b, 16), _per_head(c, 16), d,
                             chunk=chunk)
    assert torch.equal(got, want)
    assert torch.equal(got, ssd_scan_ref(x, dt, a, b, c, d, chunk))


@pytest.mark.parametrize("bc_shape,ok", [
    ((2, 16, 8, 4), True), ((2, 16, 4, 4), True), ((2, 16, 1, 4), True),
    ((2, 16, 3, 4), False), ((2, 16, 16, 4), False), ((2, 8, 2, 4), False),
    ((2, 16, 2), False)])
def test_ssd_dims_take_groups_that_divide_the_heads(bc_shape, ok):
    x, dt = torch.zeros(2, 16, 8, 4), torch.zeros(2, 16, 8)
    a = d = torch.zeros(8)
    bc = torch.zeros(bc_shape)
    if ok:
        assert blas._ssd_dims(x, dt, a, bc, bc, d, chunk=8) \
            == (2, 16, 8, 4, 4, 8)
    else:
        with pytest.raises(ValueError, match="B/C"):
            blas._ssd_dims(x, dt, a, bc, bc, d, chunk=8)
    with pytest.raises(ValueError, match="B/C"):
        blas._ssd_dims(x, dt, a, torch.zeros(2, 16, 8, 4),
                       torch.zeros(2, 16, 4, 4), d, chunk=8)


def _route_of(**kw):
    x, dt, a, b, c, d = _group_operands(**kw)
    return scan_route(x, dt, b, c, 256)


def test_scan_route_takes_the_models_operands_on_the_chunked_kernels():
    """The chunked route takes f32 views of the conv's output at the
    models' widths (granite, jamba: 8 groups, mamba2-370m) and sends what
    its kernels do not read to the composition."""
    assert _route_of(h=128, g=1, p=64, n=128, s=256) == "chunked"
    assert _route_of(h=16, g=8, p=64, n=128, s=256) == "chunked"
    assert _route_of(h=8, g=2, p=16, n=8) == "chunked"
    assert _route_of(h=4, g=1, p=132, n=8) == "composed"      # P > 128
    assert _route_of(h=4, g=1, p=16, n=256) == "composed"     # N > 128
    assert _route_of(h=4, g=1, p=18, n=8) == "composed"       # P % 4
    assert _route_of(h=4, g=1, p=16, n=6) == "composed"       # N % 4
    x, dt, a, b, c, d = _group_operands(h=4, g=1, p=16, n=8)
    assert scan_route(x.to(torch.bfloat16), dt, b, c, 8) == "composed"
    assert scan_route(x, dt.double(), b, c, 8) == "composed"
    buf = torch.zeros(2 * 32 * 200 + 1)[1:].view(2, 32, 200)  # 4-byte offset
    assert scan_route(buf[..., :64].view(2, 32, 4, 16), dt, b, c, 8) \
        == "composed"
    wide = torch.zeros(2, 32, 4, 17)[..., :16]                # rows of 17
    assert scan_route(wide, dt, b, c, 8) == "composed"
    assert scan_route(x, dt, b.expand(2, 32, 1, 8), c, 8) == "chunked"
    assert scan_route(x, dt, torch.zeros(2, 1, 1, 8).expand(2, 32, 1, 8), c,
                      8) == "composed"                        # stride 0


def test_chunked_blocks_fit_the_card_at_the_model_widths():
    """granite's chunk-output block fits twice an SM (P 64, N 128, Q 256);
    its state block once, 16 heads of a group a block, with the deepest
    ring (8 X slabs; 5 at P 128, none at Q 512); jamba's 32 heads a group
    take 16 a block, mamba2-370m's 32 heads as well."""
    assert 2 * (chunk_smem_bytes(256, 128, 64) + 1024) <= _SM_SMEM
    assert state_stages(256, 128, 64, 16) == 8
    assert state_stages(256, 128, 128, 16) == 5
    assert state_stages(512, 128, 64, 16) == 0
    assert chunk_smem_bytes(256, 128, 128) <= _MAX_SMEM
    assert heads_per_block(128) == 16 and heads_per_block(32) == 16
    assert heads_per_block(12) == 12 and heads_per_block(18) == 9
    assert heads_per_block(1) == 1


def test_ssd_scan_counts_only_the_cards_calls():
    """The wrapper's counters name both routes and the chunked route's
    three kernels; a call on CPU tensors takes the plain core and counts
    nothing."""
    assert set(ssd_scan.route_launches) == set(SCAN_ROUTES) \
        == {"chunked", "composed"}
    assert tuple(ssd_scan.kernel_launches) == SCAN_KERNELS \
        == ("state", "pass", "output")
    before = (ssd_scan.launches, dict(ssd_scan.route_launches),
              dict(ssd_scan.kernel_launches))
    x, dt, a, b, c, d = _group_operands()
    got = ssd_scan(x, dt, a, b, c, d, chunk=8)
    assert torch.equal(got, ssd_scan_ref(x, dt, a, b, c, d, 8))
    assert (ssd_scan.launches, ssd_scan.route_launches,
            ssd_scan.kernel_launches) == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ssd_scan(*(t.to("meta") for t in (x, dt, a, b, c, d)), chunk=8)


@pytest.mark.parametrize("g", [1, 4])
def test_ssd_scan_kernel_lowering_backward_recomputes_the_plain_core(g):
    """Under grad the kernel lowering runs inside the SSD rows' rule: the
    wrapper is the forward, the backward the plain core's gradients."""
    ops = _group_operands(h=8, g=g, s=16)
    leaves = [t.detach().clone().requires_grad_(True) for t in ops]
    with offload_policy(mode="device", use_kernels=True):
        y = blas.ssd_scan(*leaves, chunk=8)
    assert "_SsdScan" in type(y.grad_fn).__name__
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, leaves, dy)
    plain = [t.detach().clone().requires_grad_(True) for t in ops]
    want = torch.autograd.grad(ssd_scan_ref(*plain, 8), plain, dy)
    for gt, wt in zip(got, want):
        assert torch.equal(gt, wt)
    y2 = kgrad.lowering("ssd_scan")(*leaves, chunk=8)
    assert torch.equal(y2.detach(), y.detach())


@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_head_sharded_plan_with_group_b_and_c_equals_the_unsharded_call(g):
    """On the emulated (2, 4) mesh the head-sharded plan takes B and C once
    a group: replicated for one group, sharded where the model axis splits
    the groups, repeated per head otherwise (2 groups over 4 shards); each
    equals the unsharded call."""
    from repro_torch.core.accounting import offload_trace
    from repro_torch.sharding.spmd import Mesh

    ops = _group_operands(bsz=2, s=16, h=8, g=g)
    with offload_policy(mode="device", use_kernels=True):
        want = blas.ssd_scan(*ops, chunk=8)
        with offload_trace() as tr, Mesh((2, 4), ("data", "model")):
            got = blas.ssd_scan(*ops, chunk=8)
    assert "tp-plan" in tr.records[0].note
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
