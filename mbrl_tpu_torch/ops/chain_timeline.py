"""Where one block of K2 or K3 spends its time, phase by phase, on the card.

    python3 -m mbrl_tpu_torch.ops.chain_timeline

Builds the kernels with ``-DTC_TIMELINE`` (a library of its own in
``mbrl_tpu_torch/_build/``), runs K2 at config B's shapes (E=5 x S=1,600 rows,
in 24, 4x200 silu, head 36) in f32 and bf16, and prints, for block (0, 0), the
microseconds from its start to each mark of ``csrc/tc_chain.cuh``: barriers
set up, input tile built, then for every product the end of its wgmma, the
barrier after it and the end of its epilogue (for a hidden layer also its
stores issued and fenced, before the closing barrier), and the sampled output. Then K3
at the same shape (one tile a block) and at S=20,000 (a persistent block
walking 11 or 12 tiles): the same marks for the last tile block 0 ran, counted
from that tile's start, with the block's whole time and its tiles.

Then the wide route at 4x512 (``csrc/wide_tc.cuh``): K2 at config B's shape,
and K3 at that shape and at S=20,000 (in 23), f32 and bf16, with the marks of
``produce_wide`` and ``consume_wide`` per product: on the consumers' side its
first chunk landed, its products done, its epilogue fenced and handed on (the
head: whole); on the producer's, the ready barrier passed and its last copy
issued. Needs a CUDA device; exits 2 without one.
"""
from __future__ import annotations

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


def marks(num_products: int):
    names = {0: "start", 1: "barriers", 2: "input"}
    for i in range(num_products):
        names[3 + 3 * i] = f"p{i}_products"
        names[4 + 3 * i] = f"p{i}_synced"
        names[5 + 3 * i] = f"p{i}_epilogue"
        if i < min(num_products - 1, 4):  # inside a hidden layer's epilogue
            names[18 + i] = f"p{i}_stored"
            names[22 + i] = f"p{i}_fenced"
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


def _inputs(dtype: torch.dtype, rows: int, dims=DIMS):
    from mbrl_tpu_torch.ops import kernels as K

    g = torch.Generator().manual_seed(SEED)
    dev = torch.device("cuda")
    ws = [torch.randn((MEMBERS, a, b), generator=g) / a**0.5 for a, b in zip(dims[:-1], dims[1:])]
    bs = [0.1 * torch.randn((MEMBERS, 1, b), generator=g) for b in dims[1:]]
    stack = K.pack_mlp([w.to(dev) for w in ws[:-1]], [b.to(dev) for b in bs[:-1]],
                       ws[-1].to(dev), bs[-1].to(dev), "silu", dtype=dtype)
    x = torch.randn((MEMBERS, rows, dims[0]), generator=g).to(dev)
    return g, x, stack, K.pack_tiles(stack)


def _read(reader) -> list:
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 96)()
    if reader(buf) != 0:
        raise RuntimeError("could not read the timeline")
    return list(buf)


def _us(buf, names, origin: int) -> dict:
    return {name: round((buf[k] - buf[origin]) / 1e3, 3) for k, name in sorted(names.items())}


def timeline(dtype: torch.dtype, lib, dims=DIMS, reader: str = "mbrl_timeline") -> dict:
    from mbrl_tpu_torch.ops import kernels as K

    g, x, stack, tiles = _inputs(dtype, ROWS, dims)
    max_lv = torch.full((1, OUT), 0.5, device=x.device)
    min_lv = torch.full((1, OUT), -10.0, device=x.device)
    for _ in range(3):  # the last launch's marks are read
        K.fused_ensemble_mlp_gaussian(g, x, stack, max_lv, min_lv, OUT, tiles=tiles)
    buf = _read(getattr(lib, reader))
    names = marks(len(dims) - 1) if dims == DIMS else wide_marks(len(dims) - 1)
    return _us(buf, names, 0)


def timeline_k3(dtype: torch.dtype, rows: int, lib, dims=DIMS,
                reader: str = "mbrl_timeline_k3") -> dict:
    """Block 0's last tile, from that tile's start (mark 29), and the block's
    whole time over its tiles."""
    from mbrl_tpu_torch.ops import kernels as K

    _, x, stack, tiles = _inputs(dtype, rows, dims)
    for _ in range(3):
        K.fused_ensemble_mlp(x, stack, tiles=tiles)
    buf = _read(getattr(lib, reader))
    if dims == DIMS:
        names = {k: n for k, n in marks(len(dims) - 1).items() if 2 <= k < 29}
    else:
        names = {k: n for k, n in wide_marks(len(dims) - 1).items() if 2 <= k < 29 or k > PRODUCER + 2}
    names[30] = "head_written"
    blocks = K.persistent_blocks(rows, MEMBERS, K.sm_count(x.device))
    return {
        "dims": list(dims), "rows_per_member": rows, "blocks": blocks,
        "tiles_of_block_0": len(K.block_tiles(0, rows, MEMBERS, blocks)),
        "block_us": round((buf[30] - buf[0]) / 1e3, 3),
        "last_tile_us_since_its_start": _us(buf, names, 29),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_timeline: needs a CUDA device", file=sys.stderr)
        return 2
    from mbrl_tpu_torch.ops import build

    build.EXTRA_FLAGS = ("-DTC_TIMELINE",)
    lib = build.load_library()
    for reader in ("mbrl_timeline", "mbrl_timeline_k3", "mbrl_timeline_wide",
                   "mbrl_timeline_k3_wide"):
        getattr(lib, reader).argtypes = [ctypes.c_void_p]
    dtypes = (("f32", torch.float32), ("bf16", torch.bfloat16))
    for name, dtype in dtypes:
        print(json.dumps({"kernel": "K2", "dtype": name, "us_since_start": timeline(dtype, lib)}),
              flush=True)
    for rows in (ROWS, LONG_ROWS):
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K3", "dtype": name, **timeline_k3(dtype, rows, lib)}),
                  flush=True)
    for name, dtype in dtypes:
        print(json.dumps({"kernel": "K2 wide", "dtype": name, "dims": list(WIDE_DIMS),
                          "us_since_start": timeline(dtype, lib, WIDE_DIMS, "mbrl_timeline_wide")}),
              flush=True)
    for rows, dims in ((ROWS, WIDE_DIMS), (LONG_ROWS, (23,) + WIDE_DIMS[1:])):
        for name, dtype in dtypes:
            print(json.dumps({"kernel": "K3 wide", "dtype": name,
                              **timeline_k3(dtype, rows, lib, dims, "mbrl_timeline_k3_wide")}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
