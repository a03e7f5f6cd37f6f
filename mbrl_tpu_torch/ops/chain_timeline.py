"""Where one block of K1, K2 or K3 spends its time, phase by phase, on the card,
and what each chain kernel takes a launch at the main path's shapes.

    python3 -m mbrl_tpu_torch.ops.chain_timeline              # the phase tables
    python3 -m mbrl_tpu_torch.ops.chain_timeline --k3         # K3's alone
    python3 -m mbrl_tpu_torch.ops.chain_timeline --ms         # ms per launch
    python3 -m mbrl_tpu_torch.ops.chain_timeline --ms --routes --repeats 3
    python3 -m mbrl_tpu_torch.ops.chain_timeline --ms --root DIR --repeats 3
    python3 -m mbrl_tpu_torch.ops.chain_timeline --ms --wide --clusters --repeats 3
    python3 -m mbrl_tpu_torch.ops.chain_timeline --ms --wide --routes --root DIR --repeats 3
    python3 -m mbrl_tpu_torch.ops.chain_timeline --wide                # the wide tables alone

The phase tables build the kernels with ``-DTC_TIMELINE`` (a library of its
own in ``mbrl_tpu_torch/_build/``) and print, for block (0, 0), the
microseconds from its start to each mark of ``csrc/tc_chain.cuh``: barriers
set up, input tile built, then for every product the end of its wgmma, the
barrier after it and the end of its epilogue (for a hidden layer also its
stores issued and fenced, before the closing barrier), the first weight
chunk landed, the normals ready for the consumers (and, on the producer's
side, drawn), and the sampled output.

K3 first, one shape of each of its routes (``K3_TIMELINES``): one tile a
block at config B's shape (the marks of the last tile block 0 ran, from that
tile's start), two tiles a block at S=20,000 and at config M's shape (each
consumer warpgroup's last tile, its marks from the block's start: input,
products and epilogue of every product, head written), and a cluster a
member at one row per elite (block 0's marks from its start: its columns of
each product written, the cluster met). Then K2 at config E's shape (E=5 x
S=1,400 rows, in 5, 4x200 silu, head 8) and config B's (S=1,600, in 24,
head 36), f32 and bf16; K1 at config A's (8,000 rows, H=30, in 23, head 36,
one block per 64-row tile) with the last step of block 0 counted from that
step's start, and the block's whole time.

Then the wide route at 4x512 (``csrc/wide_tc.cuh``): K2 at config B's shape
one block a cluster (the plain ring; in bf16 the resident activations) and
in clusters of ``kernels.WIDE_CLUSTER`` blocks, with the marks of
``produce_wide`` and ``consume_wide`` per product: on the consumers' side its
first chunk landed, its products done, its epilogue fenced and handed on (the
head: whole); on the producer's, the ready barrier passed and its last copy
issued. K2's line also gives the ring's pace in product 1 (a 512 x 512
product): the µs a buffer, and the time the producer waited there for a
buffer's release by every consumer of the cluster. K3 at that shape and at
S=20,000 (in 23), f32 and bf16, on both of its wide routes: the scratch
route with the marks above, the resident route
(``csrc/ensemble_mlp_wide_smem.cu``) with its own per product (its first
ring buffer landed, its products done, its epilogue written, the barrier
after it passed; warpgroup 1's products done; the producer's copies begun
and issued), each with product 1's pace. Last the block-count check
(``block_counts``): K3 at 4x512 with the grid forced to ``BLOCK_COUNTS``
persistent blocks on both routes, f32 and bf16, at S=42,240 (3,300 tiles, a
whole number for every grid): µs a ring buffer of product 1 and the
block's time. ``--wide`` prints the wide tables alone.

``--ms`` times each chain kernel instead, in CUDA graphs of 20 launches (the
device time a launch, without the wrapper's host time) at the same shapes
and at K3's (``K3_SHAPES``: D, C100k, M, one row per elite at CL-B, CL-A and
DG, and the routes' limits), and the wide route at 4x512 (K2 at B, K1 at A,
K3 at C8k and C100k), ``--repeats`` times over, with the SHA-256 of each
launch's first output; ``--routes`` also times K3 on the routes it does not
pick at ``K3_ROUTE_SHAPES`` (with ``--wide``, K3's wide rows on the scratch
route too), ``--clusters`` K1's and K2's wide route at the
cluster sizes the wrappers do not pick, ``--wide`` the wide route alone. For
a checkout with clusters it
first prints K1's and K2's wide grids at each cluster size beside the
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``). With
``--root DIR`` it builds and times the package of another checkout at DIR
(an earlier commit, say), through the same wrappers, so that two trees can
be compared in one call on one card. Needs a CUDA device; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import sys

import torch

SEED = 0
DIMS = (24, 200, 200, 200, 200, 36)
WIDE_DIMS = (24, 512, 512, 512, 512, 36)
MEMBERS, ROWS, OUT = 5, 1600, 18
LONG_ROWS = 20_000
PRODUCER = 64  # the producer thread's marks start here (warpgroup 2)
# the main path's shapes: name -> (dims, rows a member, Gaussian head's out)
K2_SHAPES = {"E": ((5, 200, 200, 200, 200, 8), 1400, 4), "B": (DIMS, ROWS, OUT)}
# config A: 400 x 20 particles over 5 members, horizon 30, obs 17, act 6
K1_BATCH, K1_HORIZON, K1_OBS, K1_ACT, K1_TILE = 8000, 30, 17, 6, 64
K1_DIMS = (K1_OBS + K1_ACT, 200, 200, 200, 200, 2 * (K1_OBS + 1))
K1_WIDE_DIMS = (K1_OBS + K1_ACT,) + WIDE_DIMS[1:]
# K3: name -> (dims, rows a member): the main path's shapes (one row per
# elite at CL-B, CL-A and DG), then the two-tile route's crossover (27 tiles a
# member: 135 > 132 SMs), an odd tile count a member, and S = 64 and 65
M_DIMS = (5, 200, 200, 200, 200, 10)
K3_SHAPES = {"C8k": (DIMS, ROWS), "D": (DIMS[:-1] + (18,), ROWS),
             "C100k": ((23,) + DIMS[1:], LONG_ROWS), "M": (M_DIMS, 16_000),
             "CL-B": (DIMS, 1), "CL-A": ((23,) + DIMS[1:], 1),
             "DG": ((5, 200, 200, 200, 200, 8), 1),
             "x1700": (DIMS, 1_700), "x1000": (DIMS, 1_000), "S64": (DIMS, 64), "S65": (DIMS, 65)}
# K3's phase tables: name -> (dims, rows a member), each route at the main
# path's shapes
K3_TIMELINES = {"B": (DIMS, ROWS), "C100k": ((23,) + DIMS[1:], LONG_ROWS), "M": (M_DIMS, 16_000),
                "CL-B": (DIMS, 1)}
# shapes at which --ms also times the routes that K3 does not pick there
K3_ROUTE_SHAPES = ("C8k", "x1700", "x1000", "M", "C100k", "CL-B", "S64")
# the block-count check: K3's wide grid forced to each of these persistent
# blocks at BLOCK_ROWS rows a member (660 tiles a member, 3,300 in all: every
# grid walks a whole number of tiles a block)
BLOCK_COUNTS = (5, 25, 66, 132)
BLOCK_ROWS = 42_240


def marks(num_products: int):
    names = {0: "start", 1: "barriers", 2: "input"}
    for i in range(num_products):
        names[3 + 3 * i] = f"p{i}_products"
        names[4 + 3 * i] = f"p{i}_synced"
        names[5 + 3 * i] = f"p{i}_epilogue"
        if i < min(num_products - 1, 4):  # inside a hidden layer's epilogue
            names[18 + i] = f"p{i}_stored"
            names[22 + i] = f"p{i}_fenced"
    names[27] = "first_chunk_landed"
    names[26] = "noise_ready"
    names[PRODUCER + 26] = "producer_noise_drawn"
    names[31] = "sampled"
    return names


def wide_marks(num_products: int):
    """The wide route's marks (``csrc/wide_tc.cuh``): the consumers' and the
    producer's, by index into the timeline."""
    names = {0: "start", 1: "barriers", 2: "input"}
    for i in range(min(num_products, 8)):
        j = 3 + 3 * i
        names[j], names[j + 1] = f"p{i}_landed", f"p{i}_products"
        names[j + 2] = f"p{i}_handed_on" if i + 1 < num_products else f"p{i}_head_whole"
        names[PRODUCER + j] = f"producer_p{i}_ready_passed"
        names[PRODUCER + j + 1] = f"producer_p{i}_issued"
    names[31] = "sampled"
    return names


def k3_smem_marks(num_products: int):
    """The marks of K3's resident wide route
    (``csrc/ensemble_mlp_wide_smem.cu``): warpgroup 0's, warpgroup 1's
    products done, the producer's, by index into the timeline."""
    names = {0: "start", 1: "barriers", 2: "input", 29: "tile_begun", 30: "tile_done"}
    for i in range(min(num_products, 6)):
        j = 3 + 4 * i
        names[j], names[j + 1] = f"p{i}_landed", f"p{i}_products"
        names[j + 2], names[j + 3] = f"p{i}_written", f"p{i}_passed"
        names[32 + j + 1] = f"wg1_p{i}_products"
        names[PRODUCER + j] = f"producer_p{i}_begun"
        names[PRODUCER + j + 1] = f"producer_p{i}_issued"
    return names


def _stack(dtype: torch.dtype, dims, g: torch.Generator):
    from mbrl_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    ws = [torch.randn((MEMBERS, a, b), generator=g) / a**0.5 for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((MEMBERS, 1, b), generator=g) for b in dims[1:]]
    return K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                      ws[-1].to(dev), bs[-1].to(dev), "silu", dtype=dtype)


def _bounds(out: int):
    dev = torch.device("cuda")
    return torch.full((1, out), 0.5, device=dev), torch.full((1, out), -10.0, device=dev)


def _cluster_kw(cluster) -> dict:
    """The wrappers' ``cluster`` argument, left out unless given (a checkout
    from before the wide route's clusters has none)."""
    return {} if cluster is None else {"cluster": cluster}


def k2_launch(dtype: torch.dtype, dims, rows: int, out: int, cluster: int = None):
    """K2 at (dims, rows a member): a function that launches it once (on the
    wide route in clusters of ``cluster`` blocks if given)."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    stack = _stack(dtype, dims, g)
    x = torch.randn((MEMBERS, rows, dims[0]), generator=g).to("cuda")
    max_lv, min_lv = _bounds(out)
    tiles = K.pack_tiles(stack)
    kw = _cluster_kw(cluster)
    return lambda: K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, tiles=tiles,
                                                 **kw)


def k1_launch(dtype: torch.dtype, dims=K1_DIMS, cluster: int = None):
    """K1 at config A's shape (``dims`` its stack): a function that launches
    it once (on the wide route in clusters of ``cluster`` blocks if given)."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    stack = _stack(dtype, dims, g)
    num_tiles = K1_BATCH // K1_TILE
    rot = (torch.arange(K1_HORIZON) * 7 % num_tiles).to(dev, torch.int32)
    obs0 = (0.1 * torch.randn((K1_BATCH, K1_OBS), generator=g)).to(dev)
    acts = (torch.rand((K1_BATCH, K1_HORIZON, K1_ACT), generator=g) * 2 - 1).to(dev)
    dmask = torch.ones((1, K1_OBS), device=dev)
    max_lv, min_lv = _bounds(K1_OBS + 1)
    tiles = K.pack_tiles(stack)  # the chain's at these widths, whatever K1 keeps beside it
    args = (rot, obs0, acts, dmask, stack, max_lv, min_lv, K1_OBS + 1, K1_TILE)
    kw = _cluster_kw(cluster)
    return lambda: K.fused_rollout_returns(g, *args, tiles=tiles, **kw)


def k3_launch(dtype: torch.dtype, dims, rows: int, route: str = None):
    """K3 at (dims, rows a member): a function that launches it once, through
    the wrapper, or with ``route`` on that route of the chain's entry
    (``kernels.K3_ROUTES``) whatever the wrapper would pick."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    stack = _stack(dtype, dims, g)
    x = torch.randn((MEMBERS, rows, dims[0]), generator=g).to("cuda")
    tiles = K.pack_tiles(stack)
    if route is None:
        return lambda: K.fused_ensemble_mlp(x, stack, tiles=tiles)
    from mbrl_tpu_torch.ops.build import load_library

    out = torch.empty((MEMBERS, rows, dims[-1]), device="cuda")
    blocks = K.k3_blocks(route, rows, MEMBERS, K.sm_count(x.device))
    args = (x.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(), out.data_ptr(),
            K._dims_arg(stack), stack.num_products, MEMBERS, rows, blocks,
            K.ACTIVATION_CODES[stack.activation], int(stack.low_precision),
            tiles.layout.member_elems, stack.ws.data_ptr(), K.K3_ROUTES.index(route))

    keep = (x, stack, tiles)  # the launch reads them through raw pointers

    def launch():
        code = load_library().mbrl_ensemble_mlp(*args, K._stream(x.device))
        if code != 0 or keep is None:
            raise RuntimeError(f"K3 on the {route} route: CUDA error {code}")
        return out

    return launch


def k3_wide_launch(dtype: torch.dtype, dims, rows: int, route: str, blocks: int = None):
    """K3 on the wide entry's ``route`` (``kernels.K3_WIDE_ROUTES``) at (dims,
    rows a member), whatever the wrapper would pick, on ``blocks`` persistent
    blocks (the wrapper's grid if None): a function that launches it once."""
    from mbrl_tpu_torch.ops import kernels as K
    from mbrl_tpu_torch.ops.build import load_library

    g = torch.Generator().manual_seed(SEED)
    stack = _stack(dtype, dims, g)
    x = torch.randn((MEMBERS, rows, dims[0]), generator=g).to("cuda")
    tiles = K.pack_wide(stack)
    dev = x.device
    out = torch.empty((MEMBERS, rows, dims[-1]), device=dev)
    blocks = blocks or K.persistent_blocks(rows, MEMBERS, K.sm_count(dev))
    scratch = (torch.empty(blocks * tiles.layout.block_bytes(), dtype=torch.uint8, device=dev)
               if route == "scratch" else None)
    args = (x.data_ptr(), tiles.w.data_ptr(), stack.bs.data_ptr(), out.data_ptr(),
            K._dims_arg(stack), K._device_dims(stack.dims, dev).data_ptr(), stack.num_products,
            MEMBERS, rows, blocks, K.ACTIVATION_CODES[stack.activation],
            int(stack.low_precision), tiles.layout.member_elems,
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel(), K.K3_WIDE_ROUTES.index(route))

    keep = (x, stack, tiles, scratch)  # the launch reads them through raw pointers

    def launch():
        code = load_library().mbrl_ensemble_mlp_wide(*args, K._stream(dev))
        if code != 0 or keep is None:
            raise RuntimeError(f"K3 on the wide {route} route: CUDA error {code}")
        return out

    return launch


def _read(reader) -> list:
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 96)()
    if reader(buf) != 0:
        raise RuntimeError("could not read the timeline")
    return list(buf)


def _us(buf, names, origin: int) -> dict:
    return {name: round((buf[k] - buf[origin]) / 1e3, 3) for k, name in sorted(names.items())
            if buf[k]}


def _run(launch, reader) -> list:
    for _ in range(3):  # the last launch's marks are read
        launch()
    return _read(reader)


def timeline_k2(dtype: torch.dtype, lib, shape: str = "B") -> dict:
    dims, rows, out = K2_SHAPES[shape]
    buf = _run(k2_launch(dtype, dims, rows, out), lib.mbrl_timeline)
    return {"dims": list(dims), "rows_per_member": rows,
            "us_since_start": _us(buf, marks(len(dims) - 1), 0)}


def timeline_k1(dtype: torch.dtype, lib) -> dict:
    """Block 0's last step from that step's start (mark 28), and the block's
    whole time over its K1_HORIZON steps (mark 30)."""
    buf = _run(k1_launch(dtype), lib.mbrl_timeline)
    names = {k: n for k, n in marks(len(K1_DIMS) - 1).items() if k >= 2}
    names[28] = "step_start"
    return {"dims": list(K1_DIMS), "steps": K1_HORIZON, "block_us": round((buf[30] - buf[0]) / 1e3, 3),
            "last_step_us_since_its_start": _us(buf, names, 28)}


def ring_period(us: dict, buf, layout) -> dict:
    """The ring's pace in product 1 (a 512 x 512 product): its buffers, the
    µs a buffer from its first chunk landed to its products done (the
    consumers' marks), and the µs the producer waited there for a buffer to
    be free (mark 29, a duration: in a cluster, for every consumer of every
    block to release it)."""
    from mbrl_tpu_torch.ops import kernels as K

    buffers = sum(1 for i, _, _ in K.wide_ring(layout) if i == 1)
    return {"p1_buffers": buffers,
            "p1_us_per_buffer": round((us["p1_products"] - us["p1_landed"]) / buffers, 4),
            "p1_producer_empty_wait_us": round(buf[PRODUCER + 29] / 1e3, 3)}


def timeline_wide_k2(dtype: torch.dtype, lib, cluster: int) -> dict:
    """K2's wide route at config B's shape in clusters of ``cluster``
    blocks, block (0, 0): its marks from its start and the ring's period in
    product 1 (``ring_period``). The kernel of each design has its own
    reader: the clusters', the resident activations' (a bf16 stack at one
    block a cluster) and the plain ring's."""
    from mbrl_tpu_torch.ops import kernels as K

    layout = K.WideTileLayout(WIDE_DIMS, dtype == torch.bfloat16)
    design = "cluster" if cluster > 1 else "smem" if layout.resident else "plain"
    reader = {"cluster": lib.mbrl_timeline_wide_cluster, "smem": lib.mbrl_timeline_wide_smem,
              "plain": lib.mbrl_timeline_wide}[design]
    buf = _run(k2_launch(dtype, WIDE_DIMS, ROWS, OUT, cluster), reader)
    us = _us(buf, wide_marks(len(WIDE_DIMS) - 1), 0)
    return {"cluster": cluster, "design": design, "us_since_start": us,
            **ring_period(us, buf, layout)}


def timeline_k3(dtype: torch.dtype, rows: int, lib, dims=DIMS) -> dict:
    """K3 on the chain, on the route it takes at (dims, rows). One tile or two
    tiles a block: block 0's last tile of each consumer warpgroup, from that
    tile's start (mark 29; warpgroup 1's at 32 + k), and the block's whole
    time over its tiles. A cluster: block 0's marks from its start."""
    from mbrl_tpu_torch.ops import kernels as K

    buf = _run(k3_launch(dtype, dims, rows), lib.mbrl_timeline_k3)
    sms = K.sm_count(torch.device("cuda"))
    route = K.k3_route(rows, MEMBERS, sms, dtype == torch.bfloat16)
    blocks = K.k3_blocks(route, rows, MEMBERS, sms)
    out = {"dims": list(dims), "rows_per_member": rows, "route": route, "blocks": blocks,
           "block_us": round((buf[30] - buf[0]) / 1e3, 3)}
    names = {k: n for k, n in marks(len(dims) - 1).items() if 2 <= k < 29 and k not in (26, 27)}
    names[30] = "head_written"
    if route == "cluster":
        names = {k: n.replace("_products", "_written").replace("_epilogue", "_cluster_met")
                 for k, n in names.items() if (k < 18 and k % 3 != 1) or k == 30}
        return {**out, "us_since_start": _us(buf, names, 0)}
    if route == "tile":
        out["tiles_of_block_0"] = len(K.block_tiles(0, rows, MEMBERS, blocks))
        return {**out, "last_tile_us_since_its_start": _us(buf, names, 29)}
    out["pairs_of_block_0"] = len(K.block_pairs(0, rows, MEMBERS, blocks))
    for wg in (0, 1):  # each warpgroup's last tile, and its marks from the block's start
        own = {32 * wg + k: n for k, n in names.items() if k not in range(18, 26)}
        own[32 * wg + 29] = "tile_begun"
        out[f"warpgroup{wg}_last_tile_us_since_block_start"] = _us(buf, own, 0)
    return out


def k3_ring_period(us: dict, layout, route: str) -> dict:
    """The pace of K3's wide ring in product 1 (a 512 x 512 product): its
    buffers (the scratch route's 40 KB of an activation chunk and a weight
    chunk, the resident route's weight slice), the µs a buffer from its first
    landed to its products done, and that whole span."""
    from mbrl_tpu_torch.ops import kernels as K

    if route == "smem":
        buffers = sum(1 for i, _, _ in K.k3_ring_copies(layout) if i == 1)
        nbytes = layout.k3_stage_bytes
    else:
        buffers = sum(1 for i, _, _ in K.wide_ring(layout) if i == 1)
        nbytes = layout.stage_bytes
    span = us["p1_products"] - us["p1_landed"]
    return {"p1_buffers": buffers, "p1_buffer_bytes": nbytes, "p1_us": round(span, 3),
            "p1_us_per_buffer": round(span / buffers, 4)}


def timeline_k3_wide(dtype: torch.dtype, rows: int, lib, dims, route: str = None,
                     blocks: int = None) -> dict:
    """K3's wide route: block 0's last tile, from that tile's start (mark
    29), the block's whole time over its tiles and product 1's ring pace; on
    the route the wrapper picks (``route`` None, through the wrapper) or on
    ``route`` and ``blocks`` blocks through the entry."""
    from mbrl_tpu_torch.ops import kernels as K

    layout = K.WideTileLayout(tuple(dims), dtype == torch.bfloat16)
    picked = "smem" if layout.k3_resident else "scratch"
    if route is None:
        route, launch = picked, k3_launch(dtype, dims, rows)
    else:
        launch = k3_wide_launch(dtype, dims, rows, route, blocks)
    reader = lib.mbrl_timeline_k3_wide_smem if route == "smem" else lib.mbrl_timeline_k3_wide
    buf = _run(launch, reader)
    if route == "smem":
        names = {k: n for k, n in k3_smem_marks(len(dims) - 1).items() if k not in (0, 1, 29)}
    else:
        names = {k: n for k, n in wide_marks(len(dims) - 1).items()
                 if 2 <= k < 29 or k > PRODUCER + 2}
        names[30] = "head_written"
    blocks = blocks or K.persistent_blocks(rows, MEMBERS, K.sm_count(torch.device("cuda")))
    us = _us(buf, names, 29)
    return {
        "dims": list(dims), "rows_per_member": rows, "route": route, "picked": route == picked,
        "blocks": blocks, "tiles_of_block_0": len(K.block_tiles(0, rows, MEMBERS, blocks)),
        "block_us": round((buf[30] - buf[0]) / 1e3, 3),
        "last_tile_us_since_its_start": us, **k3_ring_period(us, layout, route),
    }


def block_counts(lib) -> list:
    """The block-count check: K3 at 4x512 (in 23) and ``BLOCK_ROWS`` rows a
    member on both wide routes, f32 and bf16, with the grid forced to each of
    ``BLOCK_COUNTS``: product 1's µs a ring buffer and the block's time.
    Where a resource the blocks share paces the ring, the µs a buffer grows
    with the blocks."""
    dims = (23,) + WIDE_DIMS[1:]
    out = []
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for route in ("scratch", "smem"):
            for blocks in BLOCK_COUNTS:
                r = timeline_k3_wide(dtype, BLOCK_ROWS, lib, dims, route, blocks)
                out.append({"dtype": name, **{k: r[k] for k in (
                    "route", "blocks", "tiles_of_block_0", "block_us", "p1_buffers",
                    "p1_buffer_bytes", "p1_us", "p1_us_per_buffer")}})
    return out


def graph_ms(fn, iters: int = 20) -> float:
    """Device ms a call: ``iters`` calls captured in one CUDA graph, replayed
    between two CUDA events (as ``chip_smoke.time_graph_ms``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_ms(repeats: int, routes: bool = False, clusters: bool = False,
              wide: bool = False) -> dict:
    """ms a launch of every chain kernel at the main path's shapes and of
    the wide route at 4x512 (``wide_launches``), each ``repeats`` times (in
    turns over the kernels, so that drift spreads); with ``wide``, of the
    wide route's alone; with ``routes``, K3 also on the routes it does not
    pick (``K3_ROUTE_SHAPES``); with ``clusters``, K1's and K2's wide route
    also in clusters of every other size the entries take. Also the SHA-256
    of each launch's first output (the same seed in any checkout), so that
    two trees' outputs can be compared bit for bit."""
    launches = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        if not wide:
            for shape, (dims, rows, out) in K2_SHAPES.items():
                launches[f"K2@{shape}/{name}"] = k2_launch(dtype, dims, rows, out)
            launches[f"K1@A/{name}"] = k1_launch(dtype)
            for shape, (dims, rows) in K3_SHAPES.items():
                launches[f"K3@{shape}/{name}"] = k3_launch(dtype, dims, rows)
        for shape, launch in wide_launches(dtype, routes=routes and wide).items():
            launches[f"{shape}/{name}"] = launch
        if clusters:  # the cluster sizes the wrappers do not pick
            from mbrl_tpu_torch.ops import kernels as K

            for cluster in K.WIDE_CLUSTERS:
                if cluster != 1:
                    for shape, launch in wide_launches(dtype, cluster).items():
                        launches[f"{shape}/{name}/cluster{cluster}"] = launch
        if routes and not wide:  # the routes K3 does not pick at these shapes
            from mbrl_tpu_torch.ops import kernels as K

            sms = K.sm_count(torch.device("cuda"))
            for shape in K3_ROUTE_SHAPES:
                dims, rows = K3_SHAPES[shape]
                for route in K.K3_ROUTES:
                    picked = K.k3_route(rows, MEMBERS, sms, dtype == torch.bfloat16)
                    if route != picked and (route != "cluster" or rows <= K.MAX_TILE):
                        launches[f"K3@{shape}/{name}/{route}"] = k3_launch(dtype, dims, rows, route)
    digests = {k: hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
               for k, fn in launches.items()}
    times = {k: [] for k in launches}
    for _ in range(repeats):
        for k, fn in launches.items():
            times[k].append(graph_ms(fn, 5 if k.startswith("K1") else 20))
    return times, digests


def wide_launches(dtype: torch.dtype, cluster: int = None, routes: bool = False) -> dict:
    """The wide route at 4x512: name -> a function that launches it once
    through its wrapper: K2 at config B's shape, K1 at A's, K3 at C8k's and
    C100k's; with ``cluster``, K2 and K1 alone, in clusters of that many
    blocks; with ``routes``, K3 also on the wide route it does not pick,
    through the entry."""
    launches = {"K2wide@B/W512": k2_launch(dtype, WIDE_DIMS, ROWS, OUT, cluster),
                "K1wide@A/W512": k1_launch(dtype, K1_WIDE_DIMS, cluster)}
    if cluster is None:
        k3 = {"K3wide@C8k/W512": (WIDE_DIMS, ROWS),
              "K3wide@C100k/W512": ((23,) + WIDE_DIMS[1:], LONG_ROWS)}
        for name, (dims, rows) in k3.items():
            launches[name] = k3_launch(dtype, dims, rows)
        if routes:
            from mbrl_tpu_torch.ops import kernels as K

            for name, (dims, rows) in k3.items():
                picked = "smem" if K.WideTileLayout(dims, dtype == torch.bfloat16).k3_resident \
                    else "scratch"
                for route in K.K3_WIDE_ROUTES:
                    if route != picked:
                        launches[f"{name}/{route}"] = k3_wide_launch(dtype, dims, rows, route)
    return launches


def cluster_occupancy() -> list:
    """K2's and K1's wide kernels at 4x512, each dtype and cluster size the
    entries take: the blocks of their grid at B's and A's shapes and the
    clusters the card holds at once (``kernels.wide_max_active_clusters``)."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    out = []
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for kernel, dims, tiles, members in (("K2wide@B/W512", WIDE_DIMS, -(-ROWS // K.MAX_TILE), MEMBERS),
                                             ("K1wide@A/W512", K1_WIDE_DIMS, K1_BATCH // K1_TILE, 1)):
            stack = _stack(dtype, dims, g)
            for cluster in K.WIDE_CLUSTERS:
                blocks = K.wide_grid(tiles, cluster) * members
                held = K.wide_max_active_clusters(stack, kernel.startswith("K1"), cluster, dev,
                                                  K1_OBS)
                out.append({"kernel": f"{kernel}/{name}", "cluster": cluster,
                            "picked": cluster == 1, "blocks": blocks,
                            "clusters": blocks // cluster, "max_active_clusters": held,
                            "one_wave": blocks // cluster <= held})
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ms", action="store_true", help="time each chain kernel a launch")
    parser.add_argument("--root", help="time the package of the checkout at this directory")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--routes", action="store_true",
                        help="with --ms, time K3 on every route at K3_ROUTE_SHAPES")
    parser.add_argument("--clusters", action="store_true",
                        help="with --ms, time K1's and K2's wide route at every cluster size")
    parser.add_argument("--wide", action="store_true",
                        help="the wide route alone (with --ms its times, else its phase tables)")
    parser.add_argument("--k3", action="store_true", help="the phase tables of K3 alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chain_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, args.root)
        for mod in [m for m in sys.modules if m.split(".")[0] == "mbrl_tpu_torch"]:
            del sys.modules[mod]
    from mbrl_tpu_torch.ops import build

    if args.ms:
        build.build(verbose=True)  # ptxas' registers and spills of each kernel, to stderr
        lib = build.load_library()
        if hasattr(lib, "mbrl_wide_max_active_clusters"):  # a checkout with clusters
            print(json.dumps({"root": args.root or ".", "cluster_occupancy": cluster_occupancy()}),
                  flush=True)
        times, digests = launch_ms(args.repeats, args.routes, args.clusters, args.wide)
        print(json.dumps({"root": args.root or ".", "library": build.library_path().name,
                          "ms": times, "output_sha256": digests}), flush=True)
        return 0
    build.EXTRA_FLAGS = ("-DTC_TIMELINE",)
    lib = build.load_library()
    for reader in ("mbrl_timeline", "mbrl_timeline_k3", "mbrl_timeline_wide",
                   "mbrl_timeline_wide_cluster", "mbrl_timeline_wide_smem",
                   "mbrl_timeline_k3_wide", "mbrl_timeline_k3_wide_smem"):
        getattr(lib, reader).argtypes = [ctypes.c_void_p]
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    if args.wide:
        wide_tables(lib, dtypes)
        return 0
    for shape, (dims, rows) in K3_TIMELINES.items():
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K3", "shape": shape, "dtype": name,
                              **timeline_k3(dtype, rows, lib, dims)}), flush=True)
    if args.k3:
        return 0
    for shape in K2_SHAPES:
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K2", "shape": shape, "dtype": name,
                              **timeline_k2(dtype, lib, shape)}), flush=True)
    for name, dtype in dtypes:
        print(json.dumps({"kernel": "K1", "shape": "A", "dtype": name, **timeline_k1(dtype, lib)}),
              flush=True)
    wide_tables(lib, dtypes)
    return 0


def wide_tables(lib, dtypes) -> None:
    """The wide route's phase tables: K2 at B, K3 at C8k and C100k on both
    of its routes, then the block-count check."""
    from mbrl_tpu_torch.ops import kernels as K

    for name, dtype in dtypes:
        for cluster in (1, K.WIDE_CLUSTER):
            print(json.dumps({"kernel": "K2 wide", "dtype": name, "dims": list(WIDE_DIMS),
                              **timeline_wide_k2(dtype, lib, cluster)}), flush=True)
    for rows, dims in ((ROWS, WIDE_DIMS), (LONG_ROWS, (23,) + WIDE_DIMS[1:])):
        for name, dtype in dtypes:
            for route in K.K3_WIDE_ROUTES:
                print(json.dumps({"kernel": "K3 wide", "dtype": name,
                                  **timeline_k3_wide(dtype, rows, lib, dims, route)}), flush=True)
    print(json.dumps({"kernel": "K3 wide", "block_counts": block_counts(lib)}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
