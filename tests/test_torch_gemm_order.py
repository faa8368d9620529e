"""The wgmma kernel's tile order (``kernels/gemm.py::wgmma_plan``), on the
CPU: the block -> tile map that ``csrc/gemm_wgmma.cuh`` computes, and the
plan that picks its group.  The kernel itself, and that every order gives
the same bits, are held on the card (``tests/test_torch_kernels_gpu.py``,
``-k order``)."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.kernels import gemm as G

H100_SMS = 132


def _tiles(m_tiles, n_tiles, group):
    return [G.wgmma_block_tile(block, m_tiles, n_tiles, group)
            for block in range(m_tiles * n_tiles)]


@settings(max_examples=200, deadline=None)
@given(m_tiles=st.integers(1, 300), n_tiles=st.integers(1, 40),
       group=st.integers(1, 40))
def test_block_map_is_a_bijection_onto_the_grid(m_tiles, n_tiles, group):
    """Every block gets its own tile and every tile a block, whatever the
    group, a short last group (m tiles not a multiple of it) included."""
    tiles = _tiles(m_tiles, n_tiles, group)
    assert sorted(tiles) == [(i, j) for i in range(m_tiles)
                             for j in range(n_tiles)]


@settings(max_examples=100, deadline=None)
@given(m_tiles=st.integers(1, 300), n_tiles=st.integers(1, 40),
       extra=st.integers(0, 50))
def test_group_of_all_m_tiles_is_the_plain_order(m_tiles, n_tiles, extra):
    """A group of m tiles or more is the plain order: m fastest over the
    whole grid, as the kernel's blocks start."""
    assert _tiles(m_tiles, n_tiles, m_tiles + extra) == [
        (block % m_tiles, block // m_tiles)
        for block in range(m_tiles * n_tiles)]


def test_groups_walk_m_then_n_then_the_next_group():
    """Within a group m runs fastest, then n; a group's blocks are
    consecutive; the last, short group (10 = 4 + 4 + 2) walks its 2 rows."""
    tiles = _tiles(10, 3, 4)
    assert tiles[:12] == [(i % 4, i // 4) for i in range(12)]
    assert tiles[12:24] == [(4 + i % 4, i // 4) for i in range(12)]
    assert tiles[24:] == [(8, 0), (9, 0), (8, 1), (9, 1), (8, 2), (9, 2)]


@settings(max_examples=200, deadline=None)
@given(m=st.integers(17, 70000), n=st.integers(1, 70000),
       k=st.integers(8, 20000), batch=st.integers(1, 256),
       sms=st.sampled_from([66, 114, 132]))
def test_plan_is_a_group_within_the_m_tiles(m, n, k, batch, sms):
    """The plan is a whole group of 1 .. m tiles, and the plain order (all
    m tiles) wherever the grid fits in one wave of blocks; on the H100's
    132 SMs every launch at m <= 1024 keeps today's order."""
    m_tiles = -(-m // 128)
    n_tiles = 1 if n <= 64 else -(-n // 128)
    group = G.wgmma_plan(m, n, k, batch, sms)
    assert isinstance(group, int) and 1 <= group <= m_tiles
    if m_tiles * n_tiles <= sms:
        assert group == m_tiles
    if m <= 1024:
        assert G.wgmma_plan(m, n, k, batch, H100_SMS) == m_tiles


@pytest.mark.parametrize("m,n,k", [(16384, 5120, 4096), (16384, 4096, 4096),
                                   (16384, 11008, 4096), (16384, 4096, 11008),
                                   (16384, 64000, 4096), (32768, 2048, 1024)])
def test_plan_groups_the_benchmark_shapes(m, n, k):
    """yi-6b's five GEMMs at 4 x 4096 tokens (and mamba2-370m's in-projection
    at 16 x 2048) run in groups of 12 m tiles on an H100: a wave of 132
    blocks is a 12 x 11 patch, 23 panels, the fewest any group gives."""
    assert G.wgmma_plan(m, n, k, 1, H100_SMS) == 12


@pytest.mark.parametrize("n_tiles", [32, 40, 86, 500])
@pytest.mark.parametrize("sms", [66, 114, 132])
def test_plan_reads_near_the_fewest_panels_a_wave(sms, n_tiles):
    """Against a direct count at yi-6b's grids (128 m tiles; 32, 40, 86 and
    500 n tiles): the distinct m and n tiles of each wave of ``sms``
    consecutive blocks, summed over the grid, are within 5 % of the
    fewest any group up to 40 gives at the plan's group (the plan counts
    a steady wave and leaves out where waves straddle two groups), and under
    30 % of the plain order's."""
    m_tiles = 128

    def panels(group):
        tiles = _tiles(m_tiles, n_tiles, group)
        waves = [tiles[w:w + sms] for w in range(0, len(tiles), sms)]
        return sum(len({i for i, _ in w}) + len({j for _, j in w})
                   for w in waves)

    plan = G.wgmma_plan(128 * m_tiles, 128 * n_tiles, 4096, 1, sms)
    assert panels(plan) <= 1.05 * min(panels(g) for g in range(1, 41))
    assert panels(plan) < 0.3 * panels(m_tiles)
