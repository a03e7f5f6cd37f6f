"""Where one block of K1, K2 or K3 spends its time, phase by phase, on the card,
and what each chain kernel takes a launch at the main path's shapes.

    python3 -m mbrl_tpu_torch.ops.chain_timeline              # the phase tables
    python3 -m mbrl_tpu_torch.ops.chain_timeline --ms         # ms per launch
    python3 -m mbrl_tpu_torch.ops.chain_timeline --ms --root DIR --repeats 3

The phase tables build the kernels with ``-DTC_TIMELINE`` (a library of its
own in ``mbrl_tpu_torch/_build/``) and print, for block (0, 0), the
microseconds from its start to each mark of ``csrc/tc_chain.cuh``: barriers
set up, input tile built, then for every product the end of its wgmma, the
barrier after it and the end of its epilogue (for a hidden layer also its
stores issued and fenced, before the closing barrier), the first weight
chunk landed, the normals ready
for the consumers (and, on the producer's side, drawn), and the sampled
output. The shapes are the main path's: K2 at config E's (E=5 x S=1,400
rows, in 5, 4x200 silu, head 8) and config B's (S=1,600, in 24, head 36),
f32 and bf16; K1 at config A's (8,000 rows, H=30, in 23, head 36, one block
per 64-row tile) with the last step of block 0 counted from that step's
start, and the block's whole time. Then K3 at B's shape (one tile a block)
and at S=20,000 (a persistent block walking 11 or 12 tiles): the same marks
for the last tile block 0 ran, counted from that tile's start, with the
block's whole time and its tiles.

Then the wide route at 4x512 (``csrc/wide_tc.cuh``): K2 at config B's shape,
and K3 at that shape and at S=20,000 (in 23), f32 and bf16, with the marks of
``produce_wide`` and ``consume_wide`` per product: on the consumers' side its
first chunk landed, its products done, its epilogue fenced and handed on (the
head: whole); on the producer's, the ready barrier passed and its last copy
issued.

``--ms`` times each chain kernel instead, in CUDA graphs of 20 launches (the
device time a launch, without the wrapper's host time) at the same shapes
and at K3's D (head 18), C100k and M shapes, ``--repeats`` times over. With
``--root DIR`` it builds and times the package of another checkout at DIR
(an earlier commit, say), through the same wrappers, so that two trees can
be compared in one call on one card. Needs a CUDA device; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import ctypes
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
# K3: name -> (dims, rows a member)
K3_SHAPES = {"C8k": (DIMS, ROWS), "D": (DIMS[:-1] + (18,), ROWS),
             "C100k": ((23,) + DIMS[1:], LONG_ROWS), "M": ((5, 200, 200, 200, 200, 10), 16_000)}


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


def k2_launch(dtype: torch.dtype, dims, rows: int, out: int):
    """K2 at (dims, rows a member): a function that launches it once."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    stack = _stack(dtype, dims, g)
    x = torch.randn((MEMBERS, rows, dims[0]), generator=g).to("cuda")
    max_lv, min_lv = _bounds(out)
    tiles = K.pack_tiles(stack)
    return lambda: K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, out, tiles=tiles)


def k1_launch(dtype: torch.dtype):
    """K1 at config A's shape: a function that launches it once."""
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    stack = _stack(dtype, K1_DIMS, g)
    num_tiles = K1_BATCH // K1_TILE
    rot = (torch.arange(K1_HORIZON) * 7 % num_tiles).to(dev, torch.int32)
    obs0 = (0.1 * torch.randn((K1_BATCH, K1_OBS), generator=g)).to(dev)
    acts = (torch.rand((K1_BATCH, K1_HORIZON, K1_ACT), generator=g) * 2 - 1).to(dev)
    dmask = torch.ones((1, K1_OBS), device=dev)
    max_lv, min_lv = _bounds(K1_OBS + 1)
    tiles = K.pack_tiles(stack)  # the chain's at these widths, whatever K1 keeps beside it
    args = (rot, obs0, acts, dmask, stack, max_lv, min_lv, K1_OBS + 1, K1_TILE)
    return lambda: K.fused_rollout_returns(g, *args, tiles=tiles)


def k3_launch(dtype: torch.dtype, dims, rows: int):
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    stack = _stack(dtype, dims, g)
    x = torch.randn((MEMBERS, rows, dims[0]), generator=g).to("cuda")
    tiles = K.pack_tiles(stack)
    return lambda: K.fused_ensemble_mlp(x, stack, tiles=tiles)


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


def timeline_wide_k2(dtype: torch.dtype, lib) -> dict:
    buf = _run(k2_launch(dtype, WIDE_DIMS, ROWS, OUT), lib.mbrl_timeline_wide)
    return _us(buf, wide_marks(len(WIDE_DIMS) - 1), 0)


def timeline_k3(dtype: torch.dtype, rows: int, lib, dims=DIMS,
                reader: str = "mbrl_timeline_k3") -> dict:
    """Block 0's last tile, from that tile's start (mark 29), and the block's
    whole time over its tiles."""
    from mbrl_tpu_torch.ops import kernels as K

    buf = _run(k3_launch(dtype, dims, rows), getattr(lib, reader))
    if dims == DIMS:
        names = {k: n for k, n in marks(len(dims) - 1).items() if 2 <= k < 29 and k != 26}
    else:
        names = {k: n for k, n in wide_marks(len(dims) - 1).items() if 2 <= k < 29 or k > PRODUCER + 2}
    names[30] = "head_written"
    blocks = K.persistent_blocks(rows, MEMBERS, K.sm_count(torch.device("cuda")))
    return {
        "dims": list(dims), "rows_per_member": rows, "blocks": blocks,
        "tiles_of_block_0": len(K.block_tiles(0, rows, MEMBERS, blocks)),
        "block_us": round((buf[30] - buf[0]) / 1e3, 3),
        "last_tile_us_since_its_start": _us(buf, names, 29),
    }


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


def launch_ms(repeats: int) -> dict:
    """ms a launch of every chain kernel at the main path's shapes, each
    ``repeats`` times (in turns over the kernels, so that drift spreads)."""
    launches = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for shape, (dims, rows, out) in K2_SHAPES.items():
            launches[f"K2@{shape}/{name}"] = k2_launch(dtype, dims, rows, out)
        launches[f"K1@A/{name}"] = k1_launch(dtype)
        for shape, (dims, rows) in K3_SHAPES.items():
            launches[f"K3@{shape}/{name}"] = k3_launch(dtype, dims, rows)
    times = {k: [] for k in launches}
    for _ in range(repeats):
        for k, fn in launches.items():
            times[k].append(graph_ms(fn, 5 if k.startswith("K1") else 20))
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--ms", action="store_true", help="time each chain kernel a launch")
    parser.add_argument("--root", help="time the package of the checkout at this directory")
    parser.add_argument("--repeats", type=int, default=3)
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
        build.load_library()
        print(json.dumps({"root": args.root or ".", "library": build.library_path().name,
                          "ms": launch_ms(args.repeats)}), flush=True)
        return 0
    build.EXTRA_FLAGS = ("-DTC_TIMELINE",)
    lib = build.load_library()
    for reader in ("mbrl_timeline", "mbrl_timeline_k3", "mbrl_timeline_wide",
                   "mbrl_timeline_k3_wide"):
        getattr(lib, reader).argtypes = [ctypes.c_void_p]
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    for shape in K2_SHAPES:
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K2", "shape": shape, "dtype": name,
                              **timeline_k2(dtype, lib, shape)}), flush=True)
    for name, dtype in dtypes:
        print(json.dumps({"kernel": "K1", "shape": "A", "dtype": name, **timeline_k1(dtype, lib)}),
              flush=True)
    for rows in (ROWS, LONG_ROWS):
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K3", "dtype": name, **timeline_k3(dtype, rows, lib)}),
                  flush=True)
    for name, dtype in dtypes:
        print(json.dumps({"kernel": "K2 wide", "dtype": name, "dims": list(WIDE_DIMS),
                          "us_since_start": timeline_wide_k2(dtype, lib)}), flush=True)
    for rows, dims in ((ROWS, WIDE_DIMS), (LONG_ROWS, (23,) + WIDE_DIMS[1:])):
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K3 wide", "dtype": name,
                              **timeline_k3(dtype, rows, lib, dims, "mbrl_timeline_k3_wide")}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
