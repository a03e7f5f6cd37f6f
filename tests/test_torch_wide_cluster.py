"""The plans of K1's and K2's wide route (``csrc/wide_tc.cu``), on the CPU:
clusters of blocks that share each weight chunk, and a bf16 tile's
activations resident in shared memory.

On request (the wrappers' ``cluster``) K1's and K2's blocks go in clusters of
``kernels.WIDE_CLUSTER`` blocks along x (``csrc/wide_cluster.cu``). The blocks
of a cluster run row tiles of one member, and each weight chunk of the ring
is fetched once, by one block, and multicast into every block's ring buffer.
Where a bf16 stack's two activation buffers fit beside three weight chunks
(``WideTileLayout.resident``), the activations stay in shared memory and the
ring carries weights only (``csrc/wide_smem.cu``). The kernels cannot run
here, so these tests check the Python mirror of their plans:

- the grid: the row tiles padded to a multiple of the cluster (K2 at config
  B's shape 26 x 5 blocks, K1 at config A's 126), and the padded blocks'
  scratch in the wrappers' calls (against the stand-in library);
- the ring: every weight chunk of a chain is issued by exactly one block of
  the cluster, in turn, so each block issues its share;
- K1's members: the steps at which a cluster's tiles straddle two members
  under a rotation, against a brute-force enumeration of the rotated tiles,
  and the padded tile's member (its cluster's first tile's);
- the resident plan's shared memory (``make_smem_desc``), and which stacks
  it takes.
"""
import numpy as np
import pytest
import torch

from mbrl_tpu_torch.ops import kernels as tk
from test_torch_wide_route import _stack, fake_card  # noqa: F401 (a fixture)

WIDE = (24, 512, 512, 512, 512, 36)


@pytest.mark.parametrize("tiles,cluster,want", [
    (25, 2, 26), (125, 2, 126), (26, 2, 26), (1, 2, 2), (25, 1, 25), (125, 1, 125),
])
def test_the_grid_pads_the_tiles_to_whole_clusters(tiles, cluster, want):
    assert tk.wide_grid(tiles, cluster) == want


def test_the_grid_takes_only_the_entries_cluster_sizes():
    assert tk.WIDE_CLUSTER in tk.WIDE_CLUSTERS and 1 in tk.WIDE_CLUSTERS
    for bad in (0, 3, 4, 8):  # 4: a second wave at config B's shape
        with pytest.raises(ValueError):
            tk.wide_grid(25, bad)


@pytest.mark.parametrize("low_precision", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("share", [1, 2])
def test_each_weight_chunk_is_issued_once_a_cluster_in_turn(low_precision, share):
    lay = tk.WideTileLayout(WIDE, low_precision)
    ring = tk.wide_ring(lay)
    # 512 x 512 f32: 2 passes of 32 chunks of 16 rows; bf16: 2 passes of 8 chunks of 64
    assert sum(1 for i, _, _ in ring if i == 1) == (16 if low_precision else 64)
    assert len(ring) == sum(len(lay.passes(i)) * -(-lay.k_pad[i] // lay.chunk)
                            for i in range(len(WIDE) - 1))
    # two steps of K1 (the ring counter runs on): each buffer has one issuer
    issued = [[it for it in range(2 * len(ring)) if tk.chunk_issuer(it, share) == rank]
              for rank in range(share)]
    assert sorted(it for own in issued for it in own) == list(range(2 * len(ring)))
    shares = [len(own) for own in issued]
    assert max(shares) - min(shares) <= 1
    assert all(tk.chunk_issuer(it, share) != tk.chunk_issuer(it + 1, share)
               for it in range(10)) or share == 1


def _brute_members(num_tiles, tiles_per_member, rot):
    """Row tile i's member at rotation rot, from the rotated list of tiles."""
    owners = np.repeat(np.arange(num_tiles // tiles_per_member), tiles_per_member)
    return np.roll(owners, -rot)


@pytest.mark.parametrize("num_tiles,tiles_per_member,cluster",
                         [(125, 25, 2), (125, 25, 1), (10, 2, 2), (35, 7, 2), (12, 3, 2), (5, 1, 2)])
def test_k1_straddles_match_a_brute_force_enumeration(num_tiles, tiles_per_member, cluster):
    rng = np.random.default_rng(num_tiles + cluster)
    rot = np.cumsum(rng.integers(0, num_tiles, 30)) % num_tiles
    rot[0] = 0
    got = tk.k1_straddles(rot.tolist(), num_tiles, tiles_per_member, cluster)
    blocks = tk.wide_grid(num_tiles, cluster)
    assert len(got) == blocks // cluster
    for c, first in enumerate(range(0, blocks, cluster)):
        want = []
        for t, r in enumerate(rot):
            members = _brute_members(num_tiles, tiles_per_member, int(r))
            real = [members[i] for i in range(first, min(first + cluster, num_tiles))]
            if len(set(real)) > 1:
                want.append(t)
        assert got[c] == want, (c, first)
        for t, r in enumerate(rot):  # each tile's member, the padded ones their first tile's
            members = _brute_members(num_tiles, tiles_per_member, int(r))
            for i in range(first, first + cluster):
                want_m = members[i] if i < num_tiles else members[first]
                assert tk.k1_member(i, int(r), num_tiles, tiles_per_member, cluster) == want_m


def test_k1_pairs_at_config_a_straddle_about_one_step_in_twenty_five():
    # A: 125 tiles of 64 rows over 5 members; every rotation of a step
    num_tiles, per = 125, 25
    straddles = tk.k1_straddles(list(range(num_tiles)), num_tiles, per, 2)
    assert len(straddles) == 63  # 126 blocks, the last pair one real tile and a padded one
    assert straddles[-1] == []  # a padded tile follows its pair: never straddles
    counts = [len(s) for s in straddles[:-1]]
    # a real pair (i, i + 1) straddles when (i + r) % 125 is a member's last
    # tile: 5 of 125 rotations, one in 25
    assert all(c == 5 for c in counts)


@pytest.mark.parametrize("cluster", [None, 1, 2])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_the_wrappers_pass_the_padded_grids_scratch(fake_card, dt, cluster):
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    stack = _stack(WIDE, dtype, e=5)
    lay = tk.WideTileLayout(WIDE, stack.low_precision)
    g = torch.Generator().manual_seed(0)
    lv = torch.zeros((1, 18))
    # K2 at config B's shape: 25 row tiles a member, 26 in clusters of two
    kw = {} if cluster is None else {"cluster": cluster}
    tk.fused_ensemble_mlp_gaussian(g, torch.zeros((5, 1600, 24)), stack, lv, lv, 18, **kw)
    stack1 = _stack((23,) + WIDE[1:], dtype, e=5)
    lay1 = tk.WideTileLayout(stack1.dims, stack1.low_precision)
    batch, horizon, tile = 8000, 3, 64  # config A: 125 tiles, 126 blocks in pairs
    tk.fused_rollout_returns(
        g, torch.zeros(horizon, dtype=torch.int32), torch.zeros((batch, 17)),
        torch.zeros((batch, horizon, 6)), torch.ones((1, 17)), stack1, lv, lv, 18, tile, **kw,
    )
    (k2, a2), (k1, a1) = fake_card.calls
    assert (k2, k1) == ("mbrl_ensemble_mlp_gaussian_wide", "mbrl_rollout_returns_wide")
    want = 1 if cluster is None else cluster  # one block a cluster unless asked
    assert a2[18] == a1[25] == want
    assert a2[-2] == tk.wide_grid(25, want) * 5 * lay.block_bytes()
    assert a1[-2] == tk.wide_grid(125, want) * lay1.block_bytes(17)
    if want == 2:
        assert a2[-2] == 26 * 5 * lay.block_bytes() and a1[-2] == 126 * lay1.block_bytes(17)
    assert tk.launch_counts()["fused_rollout_returns"] == 1


@pytest.mark.parametrize("dims,resident", [
    (WIDE, True),  # 2 x 64 KB of activations, 3 weight chunks of 32 KB
    ((23,) + WIDE[1:], True),
    ((24, 300, 300, 36), True),
    ((24,) + (64,) * 11 + (36,), True),
    ((23, 600, 36), False),  # 2 x 76 KB leave room for 2 chunks only
    ((24, 1024, 1024, 36), False),
])
def test_the_resident_plan_mirrors_make_smem_desc(dims, resident):
    lay = tk.WideTileLayout(dims, True)
    weights = lay.chunk * min(tk.WIDE_PASS, max(lay.n_pad)) * 2  # a bf16 weight chunk
    assert lay.stage_bytes == 64 * lay.chunk * 2 + weights
    free = tk.TC_SMEM_BYTES - 128 - 2 * lay.a_buf_bytes
    assert lay.smem_stages == max(0, min(tk.TC_MAX_STAGES, free // weights))
    assert lay.resident == resident == (lay.smem_stages >= tk.WIDE_SMEM_MIN_STAGES)
    if resident:  # barriers, both activation buffers and the ring fit a block
        assert 128 + 2 * lay.a_buf_bytes + lay.smem_stages * weights <= tk.TC_SMEM_BYTES
    # an f32 stack's hi/lo activations never stay resident
    assert not tk.WideTileLayout(dims, False).resident
    assert tk.WideTileLayout(dims, False).smem_stages == 0


def test_the_resident_plan_at_512_columns():
    lay = tk.WideTileLayout(WIDE, True)
    assert lay.a_buf_bytes == 64 * 512 * 2 and lay.smem_stages == 3
    assert 128 + 2 * 65_536 + 3 * 32_768 == 229_504 <= tk.TC_SMEM_BYTES


def test_the_clusters_ride_on_the_entries_signatures():
    from mbrl_tpu_torch.ops import build

    # the cluster follows the tiles' elements a member, before the scratch
    assert build.SIGNATURES["mbrl_ensemble_mlp_gaussian_wide"][17:19] == [build._LL, build._I]
    assert build.SIGNATURES["mbrl_rollout_returns_wide"][24:26] == [build._LL, build._I]
    assert len(build.SIGNATURES["mbrl_wide_max_active_clusters"]) == 8
